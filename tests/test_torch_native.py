"""The port's native ingest runtime (``emspec_torch.native``: the C++
SPSC ring, strided framing and the WAV decoder, built at first use) on
the CPU: the JAX package's ``tests/test_native.py`` on the port's
library, parity with the JAX package's numpy ring, ``_read_wav_py`` and
``frame_signal_np`` (and with its own native library where that loads),
the WAV half of ``tests/test_decoder_fuzz.py``, the ``Stream`` on either
ring bit for bit, checkpoints across the two rings and under a running
producer, and the build under concurrent processes.

Tolerances: none — every comparison is bit for bit.  The tests skip only
where no C++ compiler is found, and run on the card machine too, which
has no JAX: the JAX package's modules used here import none
(``emspec.io.ring``, ``emspec.io.wav``, ``emspec.native.lib``), and
``frame_signal_np`` is compiled from its own source in
``emspec/dsp/frame.py``, whose module imports JAX.
"""

import ast
import contextlib
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from emspec.io.ring import RingBuffer as JaxRing
from emspec.io.wav import _read_wav_py as jax_read_wav_py
from emspec_torch.config import Settings
from emspec_torch.dsp.frame import frame_signal_np
from emspec_torch.io import synth
from emspec_torch.io.ring import RingBuffer, make_ring
from emspec_torch.io.wav import _read_wav_py as read_wav_py
from emspec_torch.io.wav import read_wav, write_wav
from emspec_torch.native import lib as native
from emspec_torch.stream import Stream
from emspec_torch.utils.checkpoint import load_stream, save_stream

ROOT = Path(__file__).resolve().parents[1]


def _jax_definitions(rel: str, *names: str) -> dict:
    """The named top-level functions of a JAX-package file, compiled from
    its source with numpy as ``np`` (not importing the module, which
    imports JAX)."""
    path = ROOT / "emspec" / rel
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names)
    ns = {"np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


jax_frame_signal_np = _jax_definitions(
    "dsp/frame.py", "num_frames", "frame_signal_np")["frame_signal_np"]


@pytest.fixture(autouse=True)
def _compiler():
    """Skip only without a C++ compiler; with one the library must load."""
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler (CXX, default g++)")
    assert native.available(), native.build_error()


# ------------------------------------------------- tests/test_native.py, ported
def test_ring_parity_with_numpy():
    rng = np.random.default_rng(0)
    nat = native.NativeRingBuffer(256, 2)
    ref = RingBuffer(256, 2)
    for _ in range(20):
        chunk = rng.standard_normal((2, rng.integers(1, 90))).astype(np.float32)
        nat.push(chunk)
        ref.push(chunk)
        assert nat.total_written == ref.total_written
        n = int(min(nat.total_written, 100))
        np.testing.assert_array_equal(nat.latest(n), ref.latest(n))


def test_ring_giant_push_and_errors():
    nat = native.NativeRingBuffer(64, 1)
    nat.push(np.arange(100, dtype=np.float32))
    np.testing.assert_array_equal(nat.window_at(90, 10)[0], np.arange(90, 100))
    with pytest.raises(ValueError, match="overrun"):
        nat.window_at(10, 10)
    with pytest.raises(ValueError, match="past the last"):
        nat.window_at(95, 10)


def test_ring_interleaved_push():
    nat = native.NativeRingBuffer(32, 2)
    frames = np.asarray([[1, 10], [2, 20], [3, 30]], np.float32)  # (k, ch)
    nat.push_interleaved(frames)
    w = nat.latest(3)
    np.testing.assert_array_equal(w, [[1, 2, 3], [10, 20, 30]])
    # the C side reads k × channels floats: a mis-shaped buffer is refused
    for bad in (np.zeros((3, 3), np.float32), np.zeros(6, np.float32)):
        with pytest.raises(ValueError, match="interleaved"):
            nat.push_interleaved(bad)
    mono = native.NativeRingBuffer(8, 1)
    mono.push_interleaved(np.arange(3, dtype=np.float32))
    np.testing.assert_array_equal(mono.latest(3)[0], [0, 1, 2])


def test_ring_concurrent_producer_consumer():
    """SPSC: a producer thread streams while the consumer reads sequential
    windows; the producer never runs more than the ring's capacity ahead
    of the reader (it waits on an Event the reader sets), so every window
    is read, none is lost to an overrun, and each holds its exact
    absolute sample values (a torn read would not)."""
    nat = native.NativeRingBuffer(4096, 1)
    total, n = 200_000, 512
    read_pos = [0]
    room = threading.Event()

    def produce():
        pos = 0
        while pos < total:
            k = min(731, total - pos)
            while True:
                room.clear()
                if pos + k - read_pos[0] <= nat.capacity:
                    break
                room.wait(1.0)
            nat.push(np.arange(pos, pos + k, dtype=np.float32))
            pos += k

    t = threading.Thread(target=produce)
    t.start()
    good = 0
    deadline = time.monotonic() + 60
    while read_pos[0] + n <= total and time.monotonic() < deadline:
        try:
            w = nat.window_at(read_pos[0], n)[0]
        except ValueError as e:
            assert "past the last" in str(e)     # not yet written; never lapped
            continue
        np.testing.assert_array_equal(
            w, np.arange(read_pos[0], read_pos[0] + n, dtype=np.float32))
        good += 1
        read_pos[0] += n
        room.set()
    room.set()
    t.join(timeout=60)
    assert not t.is_alive()
    assert good == total // n


def test_frame_extract_parity():
    x = synth.noise(0.3, seed=11)
    got = native.frame_extract(x, 512, 128)
    want = frame_signal_np(x, 512, 128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_parity(tmp_path, channels):
    x = np.stack([synth.tone(440.0 * (c + 1), 0.05) for c in range(channels)])
    p = tmp_path / "t.wav"
    write_wav(p, x, 48_000)
    nat, rate_n = native.read_wav(p)
    ref, rate_p = read_wav_py(p)
    assert rate_n == rate_p == 48_000
    np.testing.assert_array_equal(nat, ref)


def _wav(fmt_tag: int, bits: int, channels: int, body: bytes,
         rate: int = 48_000) -> bytes:
    """A RIFF/WAVE file with a 16-byte fmt chunk (stdlib ``wave`` writes
    only PCM, so the 24-bit and float files are built by hand)."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block,
                      block, bits)
    rest = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(body)) + body)
    return b"RIFF" + struct.pack("<I", len(rest)) + rest


def _pcm24(x: np.ndarray) -> tuple[bytes, np.ndarray]:
    """float samples (any shape, interleaved order) → 24-bit PCM bytes
    and the integers they hold."""
    pcm = np.clip(np.round(x * 8388607), -8388608, 8388607).astype("<i4")
    return pcm.view(np.uint8).reshape(-1, 4)[:, :3].tobytes(), pcm


def test_wav_24bit_parity(tmp_path):
    """24-bit PCM path of both decoders."""
    rng = np.random.default_rng(5)
    body, pcm24 = _pcm24(rng.uniform(-1, 1, 200) * 0.9)
    p = tmp_path / "t24.wav"
    p.write_bytes(_wav(1, 24, 1, body))
    nat, rate_n = native.read_wav(p)
    ref, rate_p = read_wav_py(p)
    assert rate_n == rate_p == 48000
    np.testing.assert_allclose(nat, ref, atol=0)
    np.testing.assert_allclose(nat[0], pcm24 / 8388608.0, atol=1e-7)


def test_wav_rejects_garbage(tmp_path):
    p = tmp_path / "bad.wav"
    p.write_bytes(b"not a wav file at all, sorry")
    with pytest.raises(ValueError):
        native.read_wav(p)


def test_ring_torn_read_detection_adversarial():
    """The seqlock under a lapping producer.  Phase 1: an unpaced
    producer laps a small ring while the reader reads spans at the
    overwrite horizon; every window returned as valid must be
    value-exact, a lap during the copy surfacing as an overrun error,
    never as torn data (ctypes releases the GIL inside push and window,
    so the two threads overlap inside the ring code).  Phase 2 gives the
    valid reads a count that scheduling cannot take away: the producer
    pushes one chunk and waits on an Event until the reader has read the
    horizon span, which then holds nothing but live samples."""
    nat = native.NativeRingBuffer(1024, 1)
    total = 1_000_000

    def produce_unpaced():
        pos = 0
        while pos < total:
            k = min(257, total - pos)
            nat.push(np.arange(pos, pos + k, dtype=np.float32))
            pos += k

    def read_horizon():
        tw = int(nat.total_written)
        start = max(tw - 1024, 0)             # the oldest still-live sample
        w = nat.window_at(start, 256)[0]
        np.testing.assert_array_equal(
            w, np.arange(start, start + 256, dtype=np.float32))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=produce_unpaced)
        t.start()
        while nat.total_written < total:
            try:
                read_horizon()
            except ValueError as e:           # overrun detected — the point
                assert "overrun" in str(e) or "past the last" in str(e)
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)

    pushed, read = threading.Event(), threading.Event()
    rounds = 200

    def produce_paced():
        pos = total
        for _ in range(rounds):
            nat.push(np.arange(pos, pos + 257, dtype=np.float32))
            pos += 257
            pushed.set()
            if not read.wait(10):
                return
            read.clear()

    t = threading.Thread(target=produce_paced)
    t.start()
    good = 0
    for _ in range(rounds):
        assert pushed.wait(10)
        pushed.clear()
        read_horizon()                        # the producer is waiting
        good += 1
        read.set()
    t.join(timeout=60)
    assert not t.is_alive() and good == rounds


# ------------------------------------------------- parity with the JAX package
@pytest.mark.parametrize("channels,capacity,seed", [(1, 1000, 0), (16, 777, 1),
                                                    (3, 64, 2)])
def test_native_ring_matches_jax_numpy_ring(channels, capacity, seed):
    """The same random push sequence (giant pushes, empty pushes, mono
    given 1-D) into the port's native ring and the JAX package's numpy
    ring gives the same reads and the same overrun/future errors."""
    rng = np.random.default_rng(seed)
    a, b = native.NativeRingBuffer(capacity, channels), JaxRing(capacity,
                                                                channels)
    for _ in range(150):
        k = int(rng.integers(0, 2 * capacity if rng.uniform() < 0.1 else 300))
        x = rng.standard_normal((channels, k)).astype(np.float32)
        a.push(x[0] if channels == 1 and rng.uniform() < 0.5 else x)
        b.push(x)
        assert a.total_written == b.total_written
        for _ in range(3):
            start = int(rng.integers(0, a.total_written + 50))
            n = int(rng.integers(1, capacity + 20))
            try:
                want = b.window_at(start, n)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e).split(" (")[0]):
                    a.window_at(start, n)
                continue
            np.testing.assert_array_equal(a.window_at(start, n), want)
        if a.total_written:
            np.testing.assert_array_equal(a.latest(min(50, capacity)),
                                          b.latest(min(50, capacity)))


@pytest.mark.parametrize("n,hop", [(512, 128), (1000, 333), (64, 64),
                                   (4096, 100)])
def test_frame_extract_matches_jax_frame_signal_np(n, hop):
    x = synth.noise(0.2, seed=3)
    want = jax_frame_signal_np(x, n, hop)
    np.testing.assert_array_equal(frame_signal_np(x, n, hop), want)
    np.testing.assert_array_equal(native.frame_extract(x, n, hop), want)


def test_frame_extract_short_signal():
    x = np.ones(100, np.float32)
    assert native.frame_extract(x, 512, 128).shape == (0, 512)
    assert frame_signal_np(x, 512, 128).shape == (0, 512)


def _wav_files(tmp_path, seconds=0.2, channels=2, seed=0) -> dict:
    """The same audio as PCM16 (``write_wav``), PCM24, PCM32, 8-bit and
    float32, with a LIST chunk before the data in the PCM24 file."""
    rng = np.random.default_rng(seed)
    x = (0.8 * rng.uniform(-1, 1, (channels, int(seconds * 48_000)))
         ).astype(np.float32)
    inter = x.T.ravel()
    out = {"pcm16": tmp_path / "a16.wav"}
    write_wav(out["pcm16"], x, 48_000)
    body24, _ = _pcm24(inter)
    f = _wav(1, 24, channels, body24)
    listed = f[:36] + b"LIST" + struct.pack("<I", 5) + b"INFOx\x00" + f[36:]
    listed = listed[:4] + struct.pack("<I", len(listed) - 8) + listed[8:]
    body32 = np.round(inter * 2147483647.0).astype("<i4").tobytes()
    body8 = np.round(inter * 127 + 128).astype(np.uint8).tobytes()
    for name, data in (("pcm24", listed),
                       ("pcm32", _wav(1, 32, channels, body32)),
                       ("pcm8", _wav(1, 8, channels, body8)),
                       ("f32", _wav(3, 32, channels,
                                    inter.astype("<f4").tobytes()))):
        out[name] = tmp_path / f"{name}.wav"
        out[name].write_bytes(data)
    return out


def test_wav_native_matches_jax_read_wav_py(tmp_path):
    """Every format the decoders share: the port's native decoder, its
    ``read_wav`` (native first) and its ``_read_wav_py`` against the JAX
    package's ``_read_wav_py``, bit for bit."""
    for name, p in _wav_files(tmp_path).items():
        want, rate = jax_read_wav_py(p)
        for got in (native.read_wav(p), read_wav(p), read_wav_py(p)):
            assert got[1] == rate == 48_000, name
            assert got[0].dtype == np.float32 and got[0].shape == want.shape
            np.testing.assert_array_equal(got[0], want, err_msg=name)


def test_read_wav_takes_the_native_decoder_first(tmp_path, monkeypatch):
    """``io.wav.read_wav`` returns what the native decoder returns, and
    falls through to ``_read_wav_py`` when it raises."""
    p = _wav_files(tmp_path)["pcm16"]
    sentinel = (np.zeros((2, 1), np.float32), 1)
    monkeypatch.setattr(native, "read_wav", lambda path: sentinel)
    assert read_wav(p) is sentinel

    def refuse(path):
        raise ValueError("refused")
    monkeypatch.setattr(native, "read_wav", refuse)
    np.testing.assert_array_equal(read_wav(p)[0], read_wav_py(p)[0])


def _jax_native():
    from emspec.native import lib as jax_native
    if not jax_native.available():
        pytest.skip("the JAX package's native library did not build")
    return jax_native


def test_both_native_libraries_agree(tmp_path):
    """The same pushes into both packages' native rings, the same files
    through both native decoders, the same framing."""
    jax_native = _jax_native()
    rng = np.random.default_rng(7)
    for channels in (1, 16):
        a = native.NativeRingBuffer(500, channels)
        b = jax_native.NativeRingBuffer(500, channels)
        for _ in range(60):
            x = rng.standard_normal(
                (channels, int(rng.integers(1, 700)))).astype(np.float32)
            a.push(x)
            b.push(x)
            assert a.total_written == b.total_written
            n = int(rng.integers(1, 400))
            np.testing.assert_array_equal(a.latest(n), b.latest(n))
    for name, p in _wav_files(tmp_path).items():
        got, want = native.read_wav(p), jax_native.read_wav(p)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
    x = synth.noise(0.1, seed=2)
    np.testing.assert_array_equal(native.frame_extract(x, 1024, 256),
                                  jax_native.frame_extract(x, 1024, 256))


# ------------------------------------------------- the WAV half of the fuzz
def _seed_wav_pcm16() -> bytes:
    import io
    import wave

    x = (0.4 * np.sin(np.arange(400) / 5.0)).astype(np.float32)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48_000)
        w.writeframes(np.stack([x, x]).T.ravel().astype("<f4")
                      .clip(-1, 1).__mul__(32767).astype("<i2").tobytes())
    return buf.getvalue()


def _seed_wav_f32() -> bytes:
    x = (0.3 * np.sin(np.arange(300) / 7.0)).astype("<f4").tobytes()
    return _wav(3, 32, 1, x)


@pytest.mark.parametrize("seed_fn", [_seed_wav_pcm16, _seed_wav_f32],
                         ids=["pcm16", "f32"])
def test_wav_decoder_fuzz(seed_fn, tmp_path):
    """``tests/test_decoder_fuzz.py``'s 300 seeded mutations (byte flips,
    truncations, lying 4-byte fields, deleted slices) through the port's
    ``read_wav``: each either raises ``ValueError`` or decodes as the JAX
    package's ``_read_wav_py`` does, bit for bit.  The two decoders part
    on one field: the native one ignores the RIFF size, stdlib ``wave``
    reads the data chunk only as far as it says, so a RIFF size cut
    short can end the data mid-frame, where ``_read_wav_py`` raises.
    Such a file must decode as ``_read_wav_py`` decodes it with its RIFF
    size set to the file's length (one of the pcm16 mutations)."""
    valid = seed_fn()
    rng = np.random.default_rng(2026)
    p = tmp_path / "fuzz.wav"
    p.write_bytes(valid)
    native.read_wav(p)                      # the seed takes the native path
    parsed = raised = by_native = riff_cut = 0
    for i in range(300):
        data = bytearray(valid)
        kind = i % 4
        if kind == 0:
            for _ in range(int(rng.integers(1, 9))):
                data[int(rng.integers(0, len(data)))] = int(
                    rng.integers(0, 256))
        elif kind == 1:
            data = data[: int(rng.integers(0, len(data)))]
        elif kind == 2:
            off = int(rng.integers(0, max(len(data) - 4, 1)))
            data[off:off + 4] = struct.pack(
                ">I", int(rng.choice([0, 1, 0xFFFF, 0x7FFFFFFF,
                                      0xFFFFFFFF])))
        else:
            a = int(rng.integers(0, len(data)))
            b = min(len(data), a + int(rng.integers(1, 64)))
            del data[a:b]
        p.write_bytes(bytes(data))
        try:
            got, rate = read_wav(p)
        except ValueError:
            raised += 1
            continue
        parsed += 1
        try:
            native.read_wav(p)
            by_native += 1
        except ValueError:
            pass
        try:
            want, want_rate = jax_read_wav_py(p)
        except ValueError:
            p.write_bytes(bytes(data[:4]) + struct.pack("<I", len(data) - 8)
                          + bytes(data[8:]))
            want, want_rate = jax_read_wav_py(p)
            riff_cut += 1
        assert rate == want_rate, i
        np.testing.assert_array_equal(got, want, err_msg=f"mutation {i}")
    assert raised > 50 and parsed > 0 and by_native > 0, (raised, parsed,
                                                          by_native)


# ------------------------------------------------- the stream on either ring
STREAMS = {
    "enhanced8192": (Settings(mode="enhanced", multires=False,
                              fft_size=8192, hop=1024, raster_height=128),
                     0.8),
    "display_default": (Settings(), 0.3),
}


def _signal(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (synth.chirp(100.0, 9000.0, seconds)
            + synth.multitone([440.0, 880.0], seconds, amplitude=0.3)
            + 0.01 * rng.standard_normal(int(seconds * 48_000))
            ).astype(np.float32)


def _run(stream: Stream, x: np.ndarray, chunk: int = 1000) -> list:
    cols = []
    for i in range(0, x.shape[-1], chunk):
        cols += stream.push(x[i:i + chunk])
    return cols


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_native_ring_equals_numpy_ring(name):
    """``Stream(native_ring=True)`` (the default) and ``native_ring=False``
    emit the same columns bit for bit on the CPU."""
    s, seconds = STREAMS[name]
    x = _signal(seconds)
    a = Stream(s, "cpu")
    b = Stream(s, "cpu", native_ring=False)
    assert type(a.ring) is native.NativeRingBuffer
    assert type(b.ring) is RingBuffer
    ca, cb = _run(a, x) + a.flush(), _run(b, x) + b.flush()
    assert len(ca) == len(cb) > 20
    for p, q in zip(ca, cb):
        assert p.index == q.index
        np.testing.assert_array_equal(p.vis.numpy(), q.vis.numpy())
        np.testing.assert_array_equal(p.rgba.numpy(), q.rgba.numpy())


@pytest.mark.parametrize("save_native", [True, False],
                         ids=["native_to_numpy", "numpy_to_native"])
def test_checkpoint_crosses_between_the_rings(save_native, tmp_path):
    """A stream saved from one ring resumes in a stream on the other
    exactly as the uninterrupted stream runs on."""
    s = Settings(mode="enhanced", multires=False, fft_size=1024,
                 raster_height=128, hop=256, smoothing=0.4)
    x = _signal(0.6, seed=4)
    half = 13_000
    ref = _run(Stream(s, "cpu"), x)
    st1 = Stream(s, "cpu", native_ring=save_native)
    cols = _run(st1, x[:half])
    save_stream(tmp_path / "s.npz", st1)
    st2 = Stream(s, "cpu", native_ring=not save_native)
    load_stream(tmp_path / "s.npz", st2)
    assert isinstance(st2.ring, native.NativeRingBuffer) != save_native
    assert st2.ring.total_written == st1.ring.total_written
    np.testing.assert_array_equal(st2.ring.latest(4096),
                                  st1.ring.latest(4096))
    cols += _run(st2, x[half:])
    assert [c.index for c in cols] == [c.index for c in ref]
    for p, q in zip(cols, ref):
        np.testing.assert_array_equal(p.vis.numpy(), q.vis.numpy())


# a 12,000-sample ring (hop 256, window 1024) that a producer laps often
CKPT = Settings(mode="enhanced", multires=False, fft_size=1024,
                raster_height=128, hop=256)
RING_SECONDS = 0.25
RINGS = pytest.mark.parametrize("native_ring", [True, False],
                                ids=["native", "numpy"])


@contextlib.contextmanager
def _one_thread():
    """The stream ≡ batch comparisons run on one intra-op thread: torch's
    CPU ``log10`` split over threads has given 1-ulp differences between
    two calls (``tests/test_torch_post_fused.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _ckpt_stream(native_ring: bool) -> Stream:
    st = Stream(CKPT, "cpu", native_ring=native_ring,
                ring_seconds=RING_SECONDS)
    assert (type(st.ring) is native.NativeRingBuffer) == native_ring
    return st


def _saves_while_fed(st: Stream, x: np.ndarray, pos: int, path: Path
                     ) -> list[dict]:
    """A thread pushes ``x[pos:]`` into the stream's ring, as the web
    shell's feed thread does, while this one drains 4 ms of hops at a
    time, as the app's tick does, and saves after each drain → every
    file's arrays.  Between saves the producer pushes 257 samples at a
    time and holds its lead over the stream's next hop to half the ring,
    so the drain keeps up however slow the host; during a save it pushes
    64 at a time, unpaced, up to the ring less a hop, so the save's reads
    race its pushes and the stream still loses no sample.  A save that
    raises fails the test."""
    hop, cap = st.pipe.hop, st.ring.capacity
    saving, stop = threading.Event(), threading.Event()

    def run():
        p = pos
        while p < x.shape[-1] and not stop.is_set():
            busy = saving.is_set()
            k, lead = (64, cap - hop) if busy else (257, cap // 2)
            if p + k - st._next_frame * hop > lead:
                time.sleep(1e-5 if busy else 1e-4)
                continue
            st.ring.push(x[p:p + k])
            p += k

    t = threading.Thread(target=run)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t.start()
    files = []
    try:
        deadline = time.monotonic() + 120
        while t.is_alive() and time.monotonic() < deadline:
            st._drain(time.perf_counter() + 0.004)
            saving.set()
            try:
                save_stream(path, st)
            finally:
                saving.clear()
            with np.load(path) as z:
                files.append({k: z[k] for k in z.files})
    finally:
        stop.set()
        t.join(timeout=60)
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    return files


def _first_unread(z: dict, st: Stream) -> int:
    """The first sample a resumed (primed) stream reads: its next hop's."""
    return int(z["next_frame"]) * st.pipe.hop + st.pipe.n_max - st.pipe.hop


@RINGS
def test_checkpoint_under_a_running_producer(native_ring, tmp_path):
    """``save_stream`` while a thread pushes into the stream's ring and the
    stream drains between saves: no save raises while the stream keeps
    up (0 dropped frames), and every file's ``ring_data`` is exactly the
    pushed samples [ring_total − kept, ring_total), from at most the
    stream's first unread sample on.  A save whose read of the whole ring
    a push lapped keeps the span from that sample; once the producer has
    stopped, a save stores exactly the last ``capacity`` samples."""
    st = _ckpt_stream(native_ring)
    cap = st.ring.capacity
    end = 10 * cap                       # below 2^24: exact in float32
    x = np.arange(end, dtype=np.float32)
    _run(st, x[:2 * cap])                # primed, the ring lapped
    files = _saves_while_fed(st, x, 2 * cap, tmp_path / "s.npz")
    assert files and st.dropped_frames == 0
    for z in files:
        total, kept = int(z["ring_total"]), z["ring_data"].shape[-1]
        assert 0 < kept <= cap and int(z["dropped"]) == 0
        assert total - kept <= _first_unread(z, st) <= total
        np.testing.assert_array_equal(z["ring_data"][0], x[total - kept:total])
    save_stream(tmp_path / "s.npz", st)
    with np.load(tmp_path / "s.npz") as z:
        assert int(z["ring_total"]) == end
        np.testing.assert_array_equal(z["ring_data"][0], x[end - cap:])


@RINGS
def test_checkpoint_saved_under_a_producer_resumes_as_the_batch(
        native_ring, tmp_path):
    """A file saved under the running producer loads into a fresh stream
    fed the rest of the signal from its ``ring_total`` on: every column
    it computes is ``Pipeline.process``'s of the whole signal at that
    column's index, bit for bit (one intra-op thread)."""
    st = _ckpt_stream(native_ring)
    cap = st.ring.capacity
    x = _signal(2.5, seed=7)
    with _one_thread():
        _run(st, x[:cap + 500])
        files = _saves_while_fed(st, x, cap + 500, tmp_path / "s.npz")
        assert st.dropped_frames == 0
        z = files[len(files) // 2]
        total, kept = int(z["ring_total"]), z["ring_data"].shape[-1]
        np.testing.assert_array_equal(z["ring_data"][0], x[total - kept:total])
        np.savez(tmp_path / "mid.npz", **z)
        b = _ckpt_stream(native_ring)
        load_stream(tmp_path / "mid.npz", b)
        cols = _run(b, x[total:], chunk=1000) + b.flush()
        vis, rgba, _ = b.pipe.process(x)
    t0 = int(z["t"]) - b.reach
    assert [c.index for c in cols] == list(range(t0, vis.shape[0]))
    assert 0 < t0 < vis.shape[0] - 100
    for c in cols:
        assert torch.equal(c.vis, vis[c.index]), c.index
        assert torch.equal(c.rgba, rgba[c.index]), c.index


def _lap_first_read(st: Stream, x: np.ndarray, k: int = 257) -> None:
    """The first read of the stream's ring, from now on, is lapped: just
    before it, ``x``'s next ``k`` samples are pushed, as a producer's push
    during a save's read of the whole ring would."""
    read = st.ring.window_at

    def lapped(start, n):
        st.ring.window_at = read
        p = st.ring.total_written
        st.ring.push(x[p:p + k])
        return read(start, n)
    st.ring.window_at = lapped


@RINGS
def test_a_lapped_save_keeps_the_span_from_the_first_unread_sample(
        native_ring, tmp_path):
    """A push that laps the save's read of the whole ring: the save reads
    again from the stream's first unread sample (the next hop's block once
    the window is primed) to the new total, stores that total, and the
    file resumes bit for bit as the uninterrupted stream."""
    x = _signal(0.8, seed=8)
    with _one_thread():
        st = _ckpt_stream(native_ring)
        cap = st.ring.capacity
        cols = _run(st, x[:2 * cap + 300])
        _lap_first_read(st, x)
        save_stream(tmp_path / "s.npz", st)
        with np.load(tmp_path / "s.npz") as z:
            total, data = int(z["ring_total"]), z["ring_data"]
            assert "needs_window_prime" not in z.files
        assert total == 2 * cap + 300 + 257
        first = st._next_frame * st.pipe.hop + st.pipe.n_max - st.pipe.hop
        np.testing.assert_array_equal(data[0], x[first:total])
        b = _ckpt_stream(native_ring)
        load_stream(tmp_path / "s.npz", b)
        cols += _run(b, x[total:]) + b.flush()
        vis, rgba, _ = b.pipe.process(x)
    assert [c.index for c in cols] == list(range(vis.shape[0]))
    for c in cols:
        assert torch.equal(c.vis, vis[c.index]), c.index
        assert torch.equal(c.rgba, rgba[c.index]), c.index


@RINGS
def test_a_save_raises_only_when_the_stream_lost_samples(native_ring,
                                                          tmp_path):
    """A paused stream whose first unread sample has left the ring: the
    lapped save's second read is lapped too, and the save raises the
    overrun — the stream's own next drain would skip those frames.  A
    fresh stream (unprimed, hop 0) whose first window has left the ring
    raises the same way."""
    x = np.arange(20 * 12_000, dtype=np.float32)
    st = _ckpt_stream(native_ring)
    cap = st.ring.capacity
    st.push(x[:cap])
    st.pause()
    st.push(x[cap:3 * cap])
    _lap_first_read(st, x)
    with pytest.raises(ValueError, match="overrun"):
        save_stream(tmp_path / "s.npz", st)
    fresh = _ckpt_stream(native_ring)
    fresh.pause()
    fresh.push(x[:cap - 100])
    _lap_first_read(fresh, x)
    with pytest.raises(ValueError, match="overrun"):
        save_stream(tmp_path / "s.npz", fresh)


def test_make_ring_contract():
    assert type(make_ring(64, 2)) is native.NativeRingBuffer
    assert type(make_ring(64, 2, prefer_native=False)) is RingBuffer
    with pytest.raises(ValueError, match="capacity must be positive"):
        make_ring(0)                   # the native create fails, numpy raises


# ------------------------------------------------- the build
_PROBE = """
import sys, time
from pathlib import Path
from emspec_torch.native import lib
lib.BUILD_DIR = Path(sys.argv[1])
gate = Path(sys.argv[2])
(gate / sys.argv[3]).touch()
deadline = time.monotonic() + 60
while len(list(gate.iterdir())) < int(sys.argv[4]) and time.monotonic() < deadline:
    time.sleep(0.001)
ok = lib.available()
ring = lib.NativeRingBuffer(8, 1)
ring.push([1.0, 2.0])
print(ok, lib.library_path(), ring.latest(2).tolist())
"""


def _compiler_log_wrapper(tmp_path: Path) -> tuple[Path, Path]:
    """A ``$CXX`` that logs each compile (``-shared``) and runs g++."""
    log = tmp_path / "compiles.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(f"#!/bin/sh\ncase \"$*\" in *-shared*) echo x >> {log};; "
                   f"esac\nexec {shutil.which('g++')} \"$@\"\n")
    cxx.chmod(0o755)
    return cxx, log


def test_four_processes_build_once(tmp_path):
    """Four processes started together against an empty build directory:
    each loads the library, one compiles it, and nothing else is left in
    the directory but the library and the lock."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    build, gate = tmp_path / "build", tmp_path / "gate"
    gate.mkdir()
    cxx, log = _compiler_log_wrapper(tmp_path)
    env = dict(os.environ, CXX=str(cxx), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROBE, str(build), str(gate), str(i), "4"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp_path) for i in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.split())
    assert {o[0] for o in outs} == {"True"}
    assert len({o[1] for o in outs}) == 1
    assert all(" ".join(o[2:]) == "[[1.0, 2.0]]" for o in outs)
    assert log.read_text().count("x") == 1
    assert sorted(f.name for f in build.iterdir()) == sorted(
        [Path(outs[0][1]).name, "native.lock"])


_BROKEN = """
import sys
from pathlib import Path
from emspec_torch.native import lib
lib.BUILD_DIR = Path(sys.argv[1])
from emspec_torch.config import Settings
from emspec_torch.io.ring import RingBuffer
from emspec_torch.stream import Stream
assert not lib.available()
st = Stream(Settings(mode="enhanced", multires=False, fft_size=1024), "cpu")
assert type(st.ring) is RingBuffer
print(lib.build_error())
"""


def test_a_failed_build_falls_back_and_says_why(tmp_path):
    """A compiler that fails: ``available()`` is False, ``build_error()``
    holds its message, no half-built file is left, a ``Stream`` takes the
    numpy ring, and ``doctor`` warns with the reason (rc 0).  Without a
    compiler at all, the same."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\ncase \"$*\" in *-shared*) "
                   "echo 'cxx: refused on purpose' >&2; exit 1;; esac\n"
                   f"exec {shutil.which('g++') or 'false'} \"$@\"\n")
    cxx.chmod(0o755)
    build = tmp_path / "build"
    for compiler in (str(cxx), str(tmp_path / "no-such-compiler")):
        env = dict(os.environ, CXX=compiler, PYTHONPATH=str(ROOT))
        r = subprocess.run([sys.executable, "-c", _BROKEN, str(build)],
                           capture_output=True, text=True, env=env,
                           timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        want = ("refused on purpose" if compiler == str(cxx)
                else "FileNotFoundError")
        assert want in r.stdout
        assert not any(f.suffix == ".so" for f in build.glob("*"))
        d = subprocess.run([sys.executable, "-m", "emspec_torch", "doctor",
                            "--device", "cpu"], capture_output=True,
                           text=True, env=env, timeout=120, cwd=tmp_path)
        row = next(ln for ln in d.stdout.splitlines() if "native ring" in ln)
        assert d.returncode == 0 and row.startswith("WARN")
        assert "numpy fallback" in row and "$CXX" in row
