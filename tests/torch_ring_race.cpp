// A two-thread race program for the native ring's seqlock
// (emspec_torch/native/src/emspec_native.cpp), built with that file and
// the library's flags plus -pthread (tests/test_torch_ring_race.py):
//
//   g++ -O3 -std=c++17 -march=native -pthread -o torch_ring_race
//       torch_ring_race.cpp emspec_native.cpp
//   ./torch_ring_race CHANNELS CAPACITY CHUNK WINDOW LAPS planar|interleaved
//
// A producer thread pushes CHUNK samples at a time, unpaced, until LAPS ×
// CAPACITY samples are in; every value encodes its absolute index and
// channel.  A reader thread reads the WINDOW samples at the overwrite
// horizon (the oldest still in the ring) as fast as it can and checks
// every value.  Once a lap the producer waits until the reader has begun
// and finished a read after it stopped pushing: that read overlaps no
// push and must come back valid.  Prints one JSON object: valid (returned
// and exact), torn (returned as valid with a wrong value), overrun (-2),
// future (-1), quiet (the reads no push overlapped), quiet_valid (those
// that came back valid) and the wall.  Exits 1 on bad arguments or when
// the reader stalls for 60 s.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
struct EmspecRing;
EmspecRing* emspec_ring_create(int64_t capacity, int64_t channels);
void emspec_ring_destroy(EmspecRing* r);
int64_t emspec_ring_total_written(const EmspecRing* r);
void emspec_ring_push(EmspecRing* r, const float* planar, int64_t k);
void emspec_ring_push_interleaved(EmspecRing* r, const float* inter,
                                  int64_t k);
int32_t emspec_ring_window(EmspecRing* r, int64_t start_abs, int64_t n,
                           float* out);
}

// exact in float32: 20 bits of index, 4 of channel (< 2^24); a lapped
// sample is off by a multiple of the capacity, which is < 2^20
static float encode(int64_t i, int64_t c) {
    return static_cast<float>(((i & ((1 << 20) - 1)) << 4) | (c & 15));
}

int main(int argc, char** argv) {
    if (argc != 7) {
        fprintf(stderr, "usage: %s CHANNELS CAPACITY CHUNK WINDOW LAPS "
                        "planar|interleaved\n", argv[0]);
        return 1;
    }
    const int64_t ch = atoll(argv[1]), cap = atoll(argv[2]),
                  chunk = atoll(argv[3]), n = atoll(argv[4]),
                  laps = atoll(argv[5]);
    const bool inter = !strcmp(argv[6], "interleaved");
    if (ch < 1 || ch > 16 || cap < 1 || cap >= (1 << 20) || chunk < 1
        || n < 1 || n > cap || laps < 1
        || (!inter && strcmp(argv[6], "planar"))) {
        fprintf(stderr, "bad arguments\n");
        return 1;
    }
    EmspecRing* ring = emspec_ring_create(cap, ch);
    const int64_t total = laps * cap;
    std::atomic<int64_t> asked{0}, answered{0};
    std::atomic<bool> done{false}, stalled{false};

    std::thread producer([&] {
        std::vector<float> buf(ch * chunk);
        int64_t pos = 0, lap = 0;
        while (pos < total) {
            for (int64_t i = 0; i < chunk; ++i)
                for (int64_t c = 0; c < ch; ++c)
                    buf[inter ? i * ch + c : c * chunk + i] =
                        encode(pos + i, c);
            if (inter) emspec_ring_push_interleaved(ring, buf.data(), chunk);
            else       emspec_ring_push(ring, buf.data(), chunk);
            pos += chunk;
            if (pos / cap > lap) {          // a lap: one quiet read
                lap = pos / cap;
                asked.store(lap, std::memory_order_release);
                const auto t0 = std::chrono::steady_clock::now();
                while (answered.load(std::memory_order_acquire) < lap) {
                    if (std::chrono::steady_clock::now() - t0
                        > std::chrono::seconds(60)) {
                        stalled.store(true);
                        done.store(true);
                        return;
                    }
                    std::this_thread::yield();
                }
            }
        }
        done.store(true, std::memory_order_release);
    });

    int64_t valid = 0, torn = 0, overrun = 0, future = 0, quiet = 0,
            quiet_valid = 0;
    std::vector<float> out(ch * n);
    const auto t0 = std::chrono::steady_clock::now();
    while (!done.load(std::memory_order_acquire)) {
        // the producer waits for this read: it overlaps no push
        const int64_t want = asked.load(std::memory_order_acquire);
        const bool calm = want > answered.load(std::memory_order_relaxed);
        const int64_t tw = emspec_ring_total_written(ring);
        const int64_t start = std::max<int64_t>(tw - cap, 0);
        const int32_t rc = emspec_ring_window(ring, start, n, out.data());
        if (rc == 0) {
            bool ok = true;
            for (int64_t c = 0; c < ch && ok; ++c)
                for (int64_t i = 0; i < n; ++i)
                    if (out[c * n + i] != encode(start + i, c)) {
                        ok = false;
                        break;
                    }
            ++(ok ? valid : torn);
            quiet_valid += calm && ok;
        } else if (rc == -2) {
            ++overrun;
        } else if (rc == -1) {
            ++future;
        } else {
            fprintf(stderr, "emspec_ring_window returned %d\n", rc);
            return 1;
        }
        quiet += calm;
        answered.store(want, std::memory_order_release);
    }
    producer.join();
    const double s = std::chrono::duration<double>(
        std::chrono::steady_clock::now() - t0).count();
    emspec_ring_destroy(ring);
    if (stalled.load()) {
        fprintf(stderr, "the reader stalled for 60 s\n");
        return 1;
    }
    printf("{\"channels\": %lld, \"capacity\": %lld, \"chunk\": %lld, "
           "\"window\": %lld, \"laps\": %lld, \"push\": \"%s\", "
           "\"valid\": %lld, \"torn\": %lld, \"overrun\": %lld, "
           "\"future\": %lld, \"quiet\": %lld, \"quiet_valid\": %lld, "
           "\"seconds\": %.6f}\n",
           (long long)ch, (long long)cap, (long long)chunk, (long long)n,
           (long long)laps, inter ? "interleaved" : "planar",
           (long long)valid, (long long)torn, (long long)overrun,
           (long long)future, (long long)quiet, (long long)quiet_valid, s);
    return 0;
}
