"""ctypes bindings for the native ingest runtime (``src/emspec_native.cpp``,
the JAX package's ``emspec/native/src/emspec_native.cpp``, copied, with
the ring's seqlock repaired so that a read a push overlapped is reported
as an overrun).

The library is compiled at first use, never at import, with the JAX
package's Makefile flags — ``$CXX`` (default ``g++``) ``-O3 -std=c++17
-fPIC -Wall -Wextra -march=native -shared`` — into
``emspec_torch/_build/``.  Its name carries a hash of the source, the
flags, the compiler's ``--version``, the target ``-march=native``
resolves to and ``platform.machine()``: ``-march=native`` makes the
library host-specific, so a ``_build/`` copied to another machine builds
its own.  The build runs under a thread lock and an ``fcntl`` lock on
``_build/native.lock``, into a temporary file that ``os.replace`` puts
in place, so threads and processes that reach it together (test workers)
build once and none loads a half-written library.

Every consumer gates on :func:`available` and falls back to the numpy
implementations, as the JAX package does; :func:`build_error` keeps what
the compiler said when the build failed.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "src" / "emspec_native.cpp"
BUILD_DIR = _PKG.parent / "_build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native")

_LOCK = threading.Lock()
_lib = None
_tried = False
_error: str | None = None


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


@functools.lru_cache(maxsize=None)
def _compiler_identity(cxx: str) -> bytes:
    """The compiler's ``--version`` and the target flags ``-march=native``
    resolves to on this host (raises ``OSError`` without the compiler)."""
    out = b""
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        out += subprocess.run([cxx, *args], capture_output=True,
                              timeout=60).stdout
    return out


def library_path() -> Path:
    """Where the library for this source, compiler and host lives."""
    cxx = _cxx()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((cxx,) + CXXFLAGS).encode())
    h.update(_compiler_identity(cxx))
    h.update(platform.machine().encode())
    return BUILD_DIR / f"libemspec_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; one process at a time."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)         # released when it closes
        if out.exists():                         # built while we waited
            return out
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=".native_",
                                   suffix=".so")
        os.close(fd)
        try:
            r = subprocess.run([_cxx(), *CXXFLAGS, "-shared", "-o", tmp,
                                str(SOURCE)], capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise RuntimeError(f"{_cxx()} failed ({r.returncode}):\n"
                                   f"{r.stderr}")
            os.replace(tmp, out)                 # atomic: never half-written
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _load():
    global _lib, _tried, _error
    with _LOCK:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None

        c = ctypes
        p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

        lib.emspec_ring_create.restype = c.c_void_p
        lib.emspec_ring_create.argtypes = [c.c_int64, c.c_int64]
        lib.emspec_ring_destroy.argtypes = [c.c_void_p]
        lib.emspec_ring_total_written.restype = c.c_int64
        lib.emspec_ring_total_written.argtypes = [c.c_void_p]
        lib.emspec_ring_capacity.restype = c.c_int64
        lib.emspec_ring_capacity.argtypes = [c.c_void_p]
        lib.emspec_ring_push.argtypes = [c.c_void_p, p_f32, c.c_int64]
        lib.emspec_ring_push_interleaved.argtypes = [c.c_void_p, p_f32,
                                                     c.c_int64]
        lib.emspec_ring_window.restype = c.c_int32
        lib.emspec_ring_window.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                           p_f32]

        lib.emspec_frame_extract.restype = c.c_int64
        lib.emspec_frame_extract.argtypes = [p_f32, c.c_int64, c.c_int64,
                                             c.c_int64, p_f32]

        lib.emspec_wav_read.restype = c.c_void_p
        lib.emspec_wav_read.argtypes = [c.c_char_p]
        lib.emspec_wav_data.restype = ctypes.POINTER(ctypes.c_float)
        lib.emspec_wav_data.argtypes = [c.c_void_p]
        for fn in ("emspec_wav_channels", "emspec_wav_samples",
                   "emspec_wav_sample_rate"):
            getattr(lib, fn).restype = c.c_int64
            getattr(lib, fn).argtypes = [c.c_void_p]
        lib.emspec_wav_free.argtypes = [c.c_void_p]

        _lib = lib
        return _lib


def available() -> bool:
    """True once the library is built and loaded (the first call builds)."""
    return _load() is not None


def build_error() -> str | None:
    """Why :func:`available` is False: the compiler's message, or None."""
    _load()
    return _error


class NativeRingBuffer:
    """SPSC lock-free ring (same contract as emspec_torch.io.ring.RingBuffer)."""

    def __init__(self, capacity: int, channels: int = 1):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.emspec_ring_create(capacity, channels)
        if not self._h:
            raise MemoryError("emspec_ring_create failed")
        self.capacity = capacity
        self.channels = channels

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.emspec_ring_destroy(h)
            self._h = None

    @property
    def total_written(self) -> int:
        return self._lib.emspec_ring_total_written(self._h)

    def push(self, samples: np.ndarray) -> None:
        x = np.ascontiguousarray(samples, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {x.shape[0]}")
        self._lib.emspec_ring_push(self._h, x, x.shape[1])

    def push_interleaved(self, frames: np.ndarray) -> None:
        """(k, channels) interleaved — the audio-callback layout."""
        x = np.ascontiguousarray(frames, np.float32)
        if x.ndim == 1 and self.channels == 1:
            x = x[:, None]
        # the C side reads k × channels floats: a mis-shaped buffer
        # would be read past its end
        if x.ndim != 2 or x.shape[1] != self.channels:
            raise ValueError(f"expected (frames, {self.channels}) "
                             f"interleaved samples, got {x.shape}")
        self._lib.emspec_ring_push_interleaved(self._h, x, x.shape[0])

    def window_at(self, start_abs: int, n: int) -> np.ndarray:
        out = np.empty((self.channels, n), np.float32)
        rc = self._lib.emspec_ring_window(self._h, start_abs, n, out)
        if rc == -1:
            raise ValueError("window extends past the last written sample")
        if rc == -2:
            raise ValueError("window no longer in the ring (overrun)")
        if rc != 0:
            raise ValueError(f"emspec_ring_window failed: {rc}")
        return out

    def latest(self, n: int) -> np.ndarray:
        total = self.total_written
        n = min(n, total)
        return self.window_at(total - n, n)


def frame_extract(x: np.ndarray, n: int, hop: int) -> np.ndarray:
    """Native strided framing: (samples,) → (t, n) float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float32)
    t = 0 if len(x) < n else (len(x) - n) // hop + 1
    out = np.empty((t, n), np.float32)
    if t:
        got = lib.emspec_frame_extract(x, len(x), n, hop, out)
        assert got == t
    return out


def read_wav(path) -> tuple[np.ndarray, int]:
    """Native WAV decode: → ((channels, samples) float32, rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    h = lib.emspec_wav_read(str(path).encode())
    if not h:
        raise ValueError(f"could not decode WAV: {path}")
    try:
        ch = lib.emspec_wav_channels(h)
        ns = lib.emspec_wav_samples(h)
        rate = lib.emspec_wav_sample_rate(h)
        ptr = lib.emspec_wav_data(h)
        data = np.ctypeslib.as_array(ptr, shape=(ch, ns)).copy()
    finally:
        lib.emspec_wav_free(h)
    return data, int(rate)
