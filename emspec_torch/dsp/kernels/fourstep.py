"""Kernel B4 wrapper — four-step steps 1–3 of a complex DFT
(counterpart of ``emspec/dsp/pallas/fft4.py::fft4_steps123``; source
``emspec_torch/csrc/fourstep.cu``).

``fft4_steps123_plain`` is the JAX package's XLA branch
(``emspec/dsp/fourstep.py:109-126``): the einsum over n1, the twiddle and
the matmul over n2, in full float32 (TF32 stays off, ``device.py``).

The kernel runs both sub-DFTs as radix-16 Stockham FFTs in shared memory.
It has two routes, picked by n1·n2 alone, so a frame's arithmetic does
not depend on the batch: up to ``SMALL_MAX`` points one launch with no
scratch, above it two launches through a scratch B of the input's shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)

MIN_FACTOR, MAX_FACTOR = 16, 512      # the kernel's n1, n2: powers of two
SMALL_MAX = 16384                     # n1·n2 of the one-launch route
ROUTES = ("small", "large")


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
def radix_tables(n1: int, n2: int) -> tuple:
    """The kernel's float32 tables as (re, im) pairs, built in float64:
    W_512^t = e^{−2πi·t/512}, t < 512 (its inter-pass twiddles), and
    TW[k1, c] = e^{−2πi·k1·c/n} as (n1·n2, 2), the same values as
    ``tables``' (TWr, −TWi)."""
    ang = 2.0 * np.pi * np.arange(512) / 512
    w512 = np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)
    _, _, twr, twi, _, _ = tables(n1, n2)
    return w512, np.stack([twr.reshape(-1), -twi.reshape(-1)], axis=1)


@functools.lru_cache(maxsize=None)
def _device_tables(n1: int, n2: int, device: str, radix: bool) -> tuple:
    host = radix_tables(n1, n2) if radix else tables(n1, n2)
    return tuple(torch.from_numpy(t).to(device) for t in host)


def device_tables(n1: int, n2: int, device) -> tuple:
    """``tables`` on ``device`` (the plain version's)."""
    return _device_tables(n1, n2, str(torch.device(device)), False)


def device_radix_tables(n1: int, n2: int, device) -> tuple:
    """``radix_tables`` on ``device`` (the kernel's)."""
    return _device_tables(n1, n2, str(torch.device(device)), True)


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
    return all(MIN_FACTOR <= f <= MAX_FACTOR and f & (f - 1) == 0
               for f in (n1, n2))


def route_of(n1: int, n2: int) -> str:
    """The kernel's route for (n1, n2): by size only, never by batch."""
    return "small" if n1 * n2 <= SMALL_MAX else "large"


@counted
def fft4_steps123(zr: torch.Tensor, zi: torch.Tensor, *,
                  route: str | None = None):
    """zr, zi (b, n1, n2) float32 → X[k1, k2] real/imag, each (b, n1, n2),
    before the step-4 reindex k = k1 + n1·k2 (the contract of the TPU
    kernel).  b = 1 (one live window) is fine.  ``route`` ("small" or
    "large") overrides ``route_of`` for timing the two against each other;
    "small" takes n1·n2 <= ``SMALL_MAX`` only."""
    if zr.device.type == "cpu":
        return fft4_steps123_plain(zr, zi)
    what = "fft4_steps123"
    require_cuda(zr, what)
    require(zr.dim() == 3 and zr.shape == zi.shape
            and zi.device == zr.device, what,
            "zr and zi must be (b, n1, n2) tensors of one shape and device")
    b, n1, n2 = zr.shape
    require(supported(n1, n2), what,
            f"(n1, n2) = ({n1}, {n2}): each must be a power of two in "
            f"[{MIN_FACTOR}, {MAX_FACTOR}]")
    require(zr.dtype == torch.float32 and zi.dtype == torch.float32
            and zr.is_contiguous() and zi.is_contiguous(), what,
            "zr and zi must be contiguous float32")
    route = route or route_of(n1, n2)
    require(route in ROUTES and (route == "large" or n1 * n2 <= SMALL_MAX),
            what, f"route {route!r} does not take (n1, n2) = ({n1}, {n2})")
    # the kernel moves 16 bytes at a time: an offset view gets an aligned copy
    zr, zi = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (zr, zi))
    w512, tw = device_radix_tables(n1, n2, zr.device)
    xr = torch.empty_like(zr)
    xi = torch.empty_like(zi)
    scratch = (torch.empty((2, b, n1, n2), dtype=torch.float32,
                           device=zr.device) if route == "large" else None)
    with torch.cuda.device(zr.device):
        rc = kernels_build.library().emspec_fourstep(
            zr.data_ptr(), zi.data_ptr(), w512.data_ptr(), tw.data_ptr(),
            *((None, None) if scratch is None
              else (scratch[0].data_ptr(), scratch[1].data_ptr())),
            xr.data_ptr(), xi.data_ptr(), b, n1, n2, int(route == "large"),
            launch_stream(zr))
    kernels_build.check(rc, what)
    fft4_steps123.launches += 1
    return xr, xi
