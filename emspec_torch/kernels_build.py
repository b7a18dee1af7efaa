"""Build and load the port's CUDA kernels (``emspec_torch/csrc/*.cu``).

All kernels compile with one ``nvcc`` call into one shared library with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so the
build takes seconds.  It happens at first use, never at import (importing
the kernel modules must work on a machine without ``nvcc`` or a GPU).
The library lands in ``emspec_torch/_build/`` keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Flags: ``sm_90a`` and IEEE float math — never ``--use_fast_math``
(it would swap in approximate ``log2f`` and division).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points: each returns its cudaError_t (0 = launched)
_SIGNATURES = {
    "emspec_deposits": [_P, _LL, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _F, _F, _F, _F, _I, _I, _P],
    "emspec_histogram": [_P, _P, _P, _LL, _LL, _I, _P],
    "emspec_lut": [_P, _P, _P, _LL, _P],
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
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)                 # atomic: no half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
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
