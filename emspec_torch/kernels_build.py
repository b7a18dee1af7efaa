"""Build and load the port's CUDA kernels (``emspec_torch/csrc/*.cu``).

Each source compiles in its own ``nvcc`` process, all started together,
and one more links the objects into one shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so the build
takes seconds.  It happens at first use, never at import (importing
the kernel modules must work on a machine without ``nvcc`` or a GPU).
The library lands in ``emspec_torch/_build/`` keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Flags: ``sm_90a`` and IEEE float math — never ``--use_fast_math``
(it would swap in approximate ``log2f`` and division).  The first
``library()`` call builds under a lock, so two threads that reach it
together (a prewarm job and the first ``Stream``) build once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: each returns its cudaError_t (0 = launched)
_SIGNATURES = {
    "emspec_deposits": [_P, _LL, _LL, _LL, _LL] + [_P] * 9
                       + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I,
                          _P, _P],
    "emspec_deposits_cluster": [_P, _LL, _LL, _LL, _LL] + [_P] * 9
                               + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _I,
                                  _I, _I, _P, _P],
    "emspec_deposits_cluster_occupancy": [_P],
    "emspec_deposits_cluster_large": [_P, _LL, _LL, _LL, _LL] + [_P] * 9
                                     + [_I, _I, _I, _I, _F, _F, _F, _F, _I,
                                        _I, _I, _I, _P, _P],
    "emspec_deposits_cluster_large_occupancy": [_I, _I, _I, _P],
    "emspec_deposits_hist": [_P, _LL, _LL, _LL, _LL] + [_P] * 8
                            + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I,
                               _I, _P],
    "emspec_deposits_hist_cluster": [_P, _LL, _LL, _LL, _LL] + [_P] * 8
                                    + [_I, _I, _I, _I, _F, _F, _F, _F, _I,
                                       _I, _I, _I, _P],
    **{f"emspec_deposits_hist_cluster_large_{design}":
       [_P, _LL, _LL, _LL, _LL] + [_P] * 8
       + [_I, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I, _I, _P]
       for design in ("copies", "bands")},
    **{f"emspec_deposits_hist_cluster_large_{design}_occupancy":
       [_I, _I, _I, _I, _P] for design in ("copies", "bands")},
    "emspec_deposits_pack": [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _I, _P],
    "emspec_deposits_finish": [_P] * 8 + [_LL, _I, _I, _I, _I, _F, _F, _F,
                                          _F, _I, _I, _I, _I, _I, _I, _I,
                                          _P, _P],
    "emspec_ema_scan": [_P, _P, _P, _F, _P, _P, _P, _P, _I, _LL, _LL, _LL,
                        _P],
    "emspec_hist_variant": [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I,
                            _P],
    "emspec_histogram": [_P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _P],
    "emspec_histogram_sorted": [_P, _I, _P, _P, _LL, _I, _P],
    "emspec_histogram_tiles": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P],
    "emspec_histogram_batch": [_P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P],
    "emspec_histogram_ring": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P],
    "emspec_histogram_ring_occupancy": [_I, _I, _I, _I, _I, _I, _I, _P],
    "emspec_post_head": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "emspec_post_tail": [_P] * 15 + [_I, _LL, _LL, _LL, _LL, _P],
    "emspec_lut": [_P, _P, _P, _LL, _I, _I, _P],
    "emspec_lut_values": [_P, _P, _P, _LL, _I, _I, _P],
    "emspec_fourstep": [_P] * 8 + [_LL, _I, _I, _I, _P],
    "emspec_window": [_P, _LL, _LL, _LL, _LL, _P, _P, _I, _P],
    "emspec_rfft": [_P, _LL, _LL, _LL, _LL] + [_P] * 6 + [_I, _I, _I, _P],
    "emspec_rfft_cluster": [_P, _LL, _LL, _LL, _LL] + [_P] * 6
                           + [_I, _I, _I, _I, _P],
    "emspec_rfft_cluster_occupancy": [_I, _I, _I, _P],
    "emspec_rfft_pack": [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _I, _P],
    "emspec_rfft_unpack": [_P] * 5 + [_LL, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of emspec_torch are built from source at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libemspec_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = Path(tmp) / f"{src.stem}.o"
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        lib = Path(tmp) / out.name
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(lib, out)                 # atomic: no half-written library
    return out


_BUILD_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, by one thread)."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
