// emspec native runtime: lock-free audio ingest primitives (L1).
//
// The reference app's only native surface is OS audio capture inside its
// desktop shell (reference README.md:36; SURVEY.md §2.4).  This library is
// the rebuild's equivalent: a single-producer/single-consumer lock-free
// ring buffer suitable for a real capture callback (never blocks, never
// allocates on the audio thread), a WAV decoder, and strided frame
// extraction — the host side of the host→HBM staging path.
//
// Exposed as a plain C ABI consumed via ctypes (emspec/native/lib.py).
// The Python numpy implementations remain as behavioral references and
// fallbacks; both sides are parity-tested (tests/test_native.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC lock-free ring buffer
//
// Layout: channel-major planar storage (channels × capacity), matching the
// framework's (channels, samples) convention.  Two counters make a seqlock:
//
//   push:   write_end = total + k;  release fence;  copy;
//           total_written = total + k (release)
//   window: total_written (acquire) must hold the span;  copy;
//           acquire fence;  the span must lie after write_end - capacity
//
// A push announces the span it is about to overwrite before it touches
// the buffer.  If a reader's copy saw any sample of that push, the
// release fence (before the push's copy) and the acquire fence (after the
// reader's copy) pair, so the reader also sees that push's write_end and
// reports the overrun: a torn read is detected rather than silently
// returned.  Without concurrency write_end equals total_written between
// calls, so the results are those of a plain ring.
// ---------------------------------------------------------------------------

struct EmspecRing {
    float*   buf;          // channels * capacity, planar
    int64_t  capacity;
    int64_t  channels;
    std::atomic<int64_t> total_written;  // end of the newest finished push
    std::atomic<int64_t> write_end;      // end of the newest begun push
};

EmspecRing* emspec_ring_create(int64_t capacity, int64_t channels) {
    if (capacity <= 0 || channels <= 0) return nullptr;
    auto* r = new (std::nothrow) EmspecRing();
    if (!r) return nullptr;
    r->buf = static_cast<float*>(calloc(
        static_cast<size_t>(capacity) * channels, sizeof(float)));
    if (!r->buf) { delete r; return nullptr; }
    r->capacity = capacity;
    r->channels = channels;
    r->total_written.store(0, std::memory_order_relaxed);
    r->write_end.store(0, std::memory_order_relaxed);
    return r;
}

void emspec_ring_destroy(EmspecRing* r) {
    if (!r) return;
    free(r->buf);
    delete r;
}

int64_t emspec_ring_total_written(const EmspecRing* r) {
    return r->total_written.load(std::memory_order_acquire);
}

int64_t emspec_ring_capacity(const EmspecRing* r) { return r->capacity; }
int64_t emspec_ring_channels(const EmspecRing* r) { return r->channels; }

// Producer: planar (channels, k) samples.  Wait-free; keeps only the
// newest `capacity` samples on oversized pushes (invariant: absolute
// sample i lives at buf[ch][i % capacity]).
void emspec_ring_push(EmspecRing* r, const float* planar, int64_t k) {
    if (k <= 0) return;
    const int64_t cap = r->capacity;
    const int64_t ch  = r->channels;
    int64_t total = r->total_written.load(std::memory_order_relaxed);
    const float* src = planar;
    int64_t count = k;
    if (count >= cap) {               // keep newest window only
        src  += (count - cap);        // per-channel offset applied below
        const int64_t skip = count - cap;
        r->write_end.store(total + k, std::memory_order_relaxed);
        std::atomic_thread_fence(std::memory_order_release);
        for (int64_t c = 0; c < ch; ++c) {
            const float* s = planar + c * k + skip;
            const int64_t start = (total + skip) % cap;
            const int64_t first = cap - start;
            memcpy(r->buf + c * cap + start, s, first * sizeof(float));
            memcpy(r->buf + c * cap, s + first, (cap - first) * sizeof(float));
        }
        r->total_written.store(total + k, std::memory_order_release);
        return;
    }
    const int64_t start = total % cap;
    const int64_t first = (start + count <= cap) ? count : cap - start;
    r->write_end.store(total + count, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_release);
    for (int64_t c = 0; c < ch; ++c) {
        const float* s = planar + c * k;
        memcpy(r->buf + c * cap + start, s, first * sizeof(float));
        if (first < count)
            memcpy(r->buf + c * cap, s + first, (count - first) * sizeof(float));
    }
    r->total_written.store(total + count, std::memory_order_release);
    (void)src;
}

// Producer: interleaved (k frames × channels) — the layout audio callbacks
// deliver.  De-interleaves into the planar ring.
void emspec_ring_push_interleaved(EmspecRing* r, const float* inter, int64_t k) {
    if (k <= 0) return;
    const int64_t cap = r->capacity;
    const int64_t ch  = r->channels;
    int64_t total = r->total_written.load(std::memory_order_relaxed);
    int64_t skip = 0;
    if (k > cap) { skip = k - cap; total += skip; k = cap; }
    r->write_end.store(total + k, std::memory_order_relaxed);
    std::atomic_thread_fence(std::memory_order_release);
    for (int64_t i = 0; i < k; ++i) {
        const int64_t pos = (total + i) % cap;
        const float* frame = inter + (skip + i) * ch;
        for (int64_t c = 0; c < ch; ++c)
            r->buf[c * cap + pos] = frame[c];
    }
    r->total_written.store(total + k, std::memory_order_release);
}

// Consumer: copy absolute span [start_abs, start_abs+n) into out
// (channels × n planar).  Returns 0 ok, -1 span in the future, -2 span
// overwritten (overrun), -3 bad args.  Seqlock validation: after the copy
// and an acquire fence, the span must still lie after write_end -
// capacity, so a push that overlapped the copy, finished or not, is
// reported as an overrun.
int32_t emspec_ring_window(EmspecRing* r, int64_t start_abs, int64_t n,
                           float* out) {
    if (n <= 0 || start_abs < 0) return -3;
    const int64_t cap = r->capacity;
    const int64_t ch  = r->channels;
    int64_t total = r->total_written.load(std::memory_order_acquire);
    if (start_abs + n > total) return -1;
    if (start_abs < total - cap) return -2;
    const int64_t lo = start_abs % cap;
    const int64_t first = (lo + n <= cap) ? n : cap - lo;
    for (int64_t c = 0; c < ch; ++c) {
        memcpy(out + c * n, r->buf + c * cap + lo, first * sizeof(float));
        if (first < n)
            memcpy(out + c * n + first, r->buf + c * cap,
                   (n - first) * sizeof(float));
    }
    // seqlock re-validation: has a push begun over the span since?
    std::atomic_thread_fence(std::memory_order_acquire);
    const int64_t end = r->write_end.load(std::memory_order_relaxed);
    if (start_abs < end - cap) return -2;
    return 0;
}

// ---------------------------------------------------------------------------
// Strided frame extraction: x (n_samples) → frames (t × n), hop apart.
// The memcpy-per-frame host path that feeds device staging.
// ---------------------------------------------------------------------------
int64_t emspec_frame_extract(const float* x, int64_t n_samples,
                             int64_t n, int64_t hop, float* out) {
    if (n <= 0 || hop <= 0 || n_samples < n) return 0;
    const int64_t t = (n_samples - n) / hop + 1;
    for (int64_t i = 0; i < t; ++i)
        memcpy(out + i * n, x + i * hop, n * sizeof(float));
    return t;
}

// ---------------------------------------------------------------------------
// WAV decode (RIFF PCM 8/16/24/32 + IEEE float32) → planar float32.
// Proper chunk walking (handles LIST/fact/etc.), unlike Python's stdlib
// `wave`, and reads the format tag so 32-bit PCM vs float is not guessed.
// ---------------------------------------------------------------------------

struct EmspecWav {
    float*  data;       // channels * samples, planar
    int64_t channels;
    int64_t samples;
    int64_t sample_rate;
};

static uint32_t rd_u32(const uint8_t* p) {
    return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
static uint16_t rd_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

EmspecWav* emspec_wav_read(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (fsize < 44) { fclose(f); return nullptr; }
    uint8_t* raw = static_cast<uint8_t*>(malloc(fsize));
    if (!raw || fread(raw, 1, fsize, f) != static_cast<size_t>(fsize)) {
        free(raw); fclose(f); return nullptr;
    }
    fclose(f);

    if (memcmp(raw, "RIFF", 4) || memcmp(raw + 8, "WAVE", 4)) {
        free(raw); return nullptr;
    }
    uint16_t fmt_tag = 0, channels = 0, bits = 0;
    uint32_t rate = 0;
    const uint8_t* data_p = nullptr;
    uint32_t data_len = 0;
    long off = 12;
    while (off + 8 <= fsize) {
        const uint8_t* hdr = raw + off;
        uint32_t clen = rd_u32(hdr + 4);
        const uint8_t* body = hdr + 8;
        if (off + 8 + static_cast<long>(clen) > fsize) break;
        if (!memcmp(hdr, "fmt ", 4) && clen >= 16) {
            fmt_tag  = rd_u16(body);
            channels = rd_u16(body + 2);
            rate     = rd_u32(body + 4);
            bits     = rd_u16(body + 14);
            if (fmt_tag == 0xFFFE && clen >= 40)      // WAVE_FORMAT_EXTENSIBLE
                fmt_tag = rd_u16(body + 24);
        } else if (!memcmp(hdr, "data", 4)) {
            data_p = body;
            data_len = clen;
        }
        off += 8 + clen + (clen & 1);                 // chunks are word-aligned
    }
    if (!data_p || channels == 0 || rate == 0 ||
        (fmt_tag != 1 && fmt_tag != 3)) { free(raw); return nullptr; }

    // reject depths the sample loop can't decode — otherwise an exotic
    // bit depth (12/20/float16...) silently decodes to all-zero audio;
    // returning nullptr routes the file to the Python fallback, which
    // raises a clear "unsupported sample width" error instead
    const bool supported =
        (fmt_tag == 3 && bits == 32) ||
        (fmt_tag == 1 && (bits == 8 || bits == 16 || bits == 24 ||
                          bits == 32));
    if (!supported) { free(raw); return nullptr; }
    const int64_t bytes_per = bits / 8;
    if (bytes_per == 0) { free(raw); return nullptr; }
    const int64_t nsamp = data_len / (bytes_per * channels);
    auto* w = new (std::nothrow) EmspecWav();
    if (!w) { free(raw); return nullptr; }
    w->data = static_cast<float*>(malloc(
        static_cast<size_t>(nsamp) * channels * sizeof(float)));
    if (!w->data) { delete w; free(raw); return nullptr; }
    w->channels = channels;
    w->samples = nsamp;
    w->sample_rate = rate;

    for (int64_t i = 0; i < nsamp; ++i) {
        for (int64_t c = 0; c < channels; ++c) {
            const uint8_t* s = data_p + (i * channels + c) * bytes_per;
            float v = 0.0f;
            if (fmt_tag == 3 && bits == 32) {
                memcpy(&v, s, 4);
            } else if (bits == 16) {
                v = static_cast<int16_t>(rd_u16(s)) / 32768.0f;
            } else if (bits == 24) {
                int32_t iv = s[0] | (s[1] << 8) | (s[2] << 16);
                if (iv & 0x800000) iv -= 0x1000000;
                v = iv / 8388608.0f;
            } else if (bits == 32) {
                v = static_cast<int32_t>(rd_u32(s)) / 2147483648.0f;
            } else if (bits == 8) {
                v = (static_cast<int>(s[0]) - 128) / 128.0f;
            }
            w->data[c * nsamp + i] = v;
        }
    }
    free(raw);
    return w;
}

float*  emspec_wav_data(const EmspecWav* w)        { return w->data; }
int64_t emspec_wav_channels(const EmspecWav* w)    { return w->channels; }
int64_t emspec_wav_samples(const EmspecWav* w)     { return w->samples; }
int64_t emspec_wav_sample_rate(const EmspecWav* w) { return w->sample_rate; }

void emspec_wav_free(EmspecWav* w) {
    if (!w) return;
    free(w->data);
    delete w;
}

}  // extern "C"
