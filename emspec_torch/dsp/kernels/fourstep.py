"""Kernel B4 wrapper — four-step steps 1–3 of a complex DFT
(counterpart of ``emspec/dsp/pallas/fft4.py::fft4_steps123``; source
``emspec_torch/csrc/fourstep.cu``).

``fft4_steps123_plain`` is the JAX package's XLA branch
(``emspec/dsp/fourstep.py:109-126``): the einsum over n1, the twiddle and
the matmul over n2, in full float32 (TF32 stays off, ``device.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import launch_stream, require, require_cuda

MIN_FACTOR, MAX_FACTOR = 16, 512      # the kernel's n1, n2: multiples of 16


@functools.lru_cache(maxsize=None)
def tables(n1: int, n2: int) -> tuple:
    """(C1, S1, TWr, TWi, C2, S2) float32 numpy tables, built in float64
    (``emspec.dsp.fourstep._tables``)."""
    n = n1 * n2
    i1 = np.arange(n1)
    i2 = np.arange(n2)
    a1 = 2.0 * np.pi * np.outer(i1, i1) / n1          # (k1, n1)
    a2 = 2.0 * np.pi * np.outer(i2, i2) / n2          # (n2, k2)
    tw = 2.0 * np.pi * np.outer(i1, i2) / n           # (k1, n2)
    return (np.cos(a1).astype(np.float32), np.sin(a1).astype(np.float32),
            np.cos(tw).astype(np.float32), np.sin(tw).astype(np.float32),
            np.cos(a2).astype(np.float32), np.sin(a2).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _device_tables(n1: int, n2: int, device: str) -> tuple:
    return tuple(torch.from_numpy(t).to(device) for t in tables(n1, n2))


def device_tables(n1: int, n2: int, device) -> tuple:
    return _device_tables(n1, n2, str(torch.device(device)))


def fft4_steps123_plain(zr: torch.Tensor, zi: torch.Tensor):
    """(b, n1, n2) real/imag → X[k1, k2] real/imag, each (b, n1, n2)."""
    C1, S1, TWr, TWi, C2, S2 = device_tables(zr.shape[-2], zr.shape[-1],
                                             zr.device)

    def dot1(m, x):                                # contraction over n1
        return torch.einsum("kj,bjn->bkn", m, x)

    def mm(a, m):                                  # contraction over n2
        return (a.reshape(-1, a.shape[-1]) @ m).reshape(a.shape)

    Ar = dot1(C1, zr) + dot1(S1, zi)
    Ai = dot1(C1, zi) - dot1(S1, zr)
    Br = Ar * TWr + Ai * TWi
    Bi = Ai * TWr - Ar * TWi
    return mm(Br, C2) + mm(Bi, S2), mm(Bi, C2) - mm(Br, S2)


def supported(n1: int, n2: int) -> bool:
    """Factorizations the kernel takes: every pair in ``fourstep._FACTORS``."""
    return all(MIN_FACTOR <= f <= MAX_FACTOR and f % MIN_FACTOR == 0
               for f in (n1, n2))


def fft4_steps123(zr: torch.Tensor, zi: torch.Tensor):
    """zr, zi (b, n1, n2) float32 → X[k1, k2] real/imag, each (b, n1, n2),
    before the step-4 reindex k = k1 + n1·k2 (the contract of the TPU
    kernel).  b = 1 (one live window) is fine."""
    if zr.device.type == "cpu":
        return fft4_steps123_plain(zr, zi)
    what = "fft4_steps123"
    require_cuda(zr, what)
    require(zr.dim() == 3 and zr.shape == zi.shape
            and zi.device == zr.device, what,
            "zr and zi must be (b, n1, n2) tensors of one shape and device")
    b, n1, n2 = zr.shape
    require(supported(n1, n2), what,
            f"(n1, n2) = ({n1}, {n2}): each must be a multiple of "
            f"{MIN_FACTOR} in [{MIN_FACTOR}, {MAX_FACTOR}]")
    require(zr.dtype == torch.float32 and zi.dtype == torch.float32
            and zr.is_contiguous() and zi.is_contiguous(), what,
            "zr and zi must be contiguous float32")
    tab = device_tables(n1, n2, zr.device)
    scratch = torch.empty((2, b, n1, n2), dtype=torch.float32,
                          device=zr.device)
    xr = torch.empty_like(zr)
    xi = torch.empty_like(zi)
    with torch.cuda.device(zr.device):
        rc = kernels_build.library().emspec_fourstep(
            zr.data_ptr(), zi.data_ptr(), *(t.data_ptr() for t in tab),
            scratch[0].data_ptr(), scratch[1].data_ptr(), xr.data_ptr(),
            xi.data_ptr(), b, n1, n2, launch_stream(zr))
    kernels_build.check(rc, what)
    fft4_steps123.launches += 1
    return xr, xi


fft4_steps123.launches = 0
