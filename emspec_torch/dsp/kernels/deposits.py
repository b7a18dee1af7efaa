"""Kernel B1 wrapper — fused enhanced analysis, frames → deposits
(counterpart of ``emspec/dsp/pallas/fft4.py::fft4_deposits(reach=R)``;
source ``emspec_torch/csrc/deposits.cu``).

``quantize_deposits`` is the single definition of the quantization
contract (``emspec.pipeline.Pipeline._deposits_banked``,
``pipeline.py:409-423``): the pipeline's unfused paths and the kernel's
reference ``deposits_plain`` both call it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import launch_stream, require, require_cuda
from emspec_torch.dsp.reassign import reassignment_corrections
from emspec_torch.dsp.stft import stft_triple_stencil, th_window

MIN_N = 512
MAX_N = 16384          # two half-size complex spectra, 8·(N+2) B of shared memory


def supported(n: int) -> bool:
    """Frame sizes kernel B1 holds: powers of two in [512, 16384]."""
    return MIN_N <= n <= MAX_N and (n & (n - 1)) == 0


def quantize_deposits(power, dt, dw, logmap_a, logmap_b, power_floor, *,
                      n: int, hop: int, sr: float, rows: int, band=None):
    """Reassignment corrections (..., n//2+1) → (row, delta, contrib).

    ``delta = round(Δt/hop)`` (a true division, half to even) is the
    relative column offset; contrib is zero for every invalid deposit
    (sub-floor power, row off the axis, f̂ ≤ 0, |Δt| > N/2).  ``band`` is
    the bank's band weight per bin (identically 1 for one bank)."""
    k_idx = torch.arange(n // 2 + 1, dtype=torch.float32, device=power.device)
    f_hat = (k_idx + dw * (n / (2.0 * np.pi))) * (sr / n)           # Hz
    delta = torch.round(dt / float(hop)).to(torch.int32)
    row_f = (torch.log2(torch.clamp(f_hat, min=1e-6)) - logmap_a) * logmap_b
    row = torch.round(row_f).to(torch.int32)
    valid = ((power > power_floor) & (row >= 0) & (row < rows)
             & (f_hat > 0) & (torch.abs(dt) <= float(n) / 2.0))
    weighted = power if band is None else power * band
    contrib = torch.where(valid, weighted * (1.0 / float(n * n)),
                          torch.zeros_like(power))
    return torch.clamp(row, 0, rows - 1), delta, contrib


def deposits_plain(frames, logmap_a, logmap_b, power_floor, *, n: int,
                   hop: int, sr: float, rows: int):
    """frames (..., n) → (row, delta, contrib), each (..., n//2+1): the
    stencil spectra (two ``torch.fft.rfft``), corrections, quantization."""
    return quantize_deposits(
        *reassignment_corrections(*stft_triple_stencil(frames)), logmap_a,
        logmap_b, power_floor, n=n, hop=hop, sr=sr, rows=rows)


def deposits_ids_plain(frames, logmap_a, logmap_b, power_floor, *, n: int,
                       hop: int, sr: float, rows: int, reach: int):
    """Plain B1: (ids = (δ + reach)·rows + row, contrib)."""
    row, delta, contrib = deposits_plain(
        frames, logmap_a, logmap_b, power_floor, n=n, hop=hop, sr=sr,
        rows=rows)
    return (delta + reach) * rows + row, contrib


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: str) -> torch.Tensor:
    """e^{-2πij/n}, j < n/2, built in float64, stored as float32 pairs."""
    ang = -2.0 * np.pi * np.arange(n // 2) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def deposits_ids(frames: torch.Tensor, logmap_a, logmap_b, power_floor, *,
                 n: int, hop: int, sr: float, rows: int, reach: int):
    """frames (..., n) float32 → (ids int32, contrib float32), each
    (..., n//2+1) in natural bin order.  Invalid deposits carry contrib 0
    (and, from the kernel, id −1).  On CUDA the scalars must be float32
    tensors on the frames' device: the kernel reads them from device
    memory, so a slider move causes no host sync."""
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  n=n, hop=hop, sr=sr, rows=rows, reach=reach)
    what = "deposits_ids"
    require_cuda(frames, what)
    require(supported(n), what, f"n={n} outside the kernel's power-of-two "
            f"range [{MIN_N}, {MAX_N}]")
    require(frames.dtype == torch.float32 and frames.shape[-1] == n
            and frames.stride(-1) == 1, what,
            f"frames must be float32 (..., {n}) with unit last stride")
    scal = (logmap_a, logmap_b, power_floor)
    require(all(isinstance(s, torch.Tensor) and s.numel() == 1
                and s.dtype == torch.float32 and s.device == frames.device
                for s in scal), what,
            "logmap_a, logmap_b, power_floor must be float32 scalars on "
            "the frames' device")
    lead = frames.shape[:-1]
    f3 = (frames.reshape(1, 1, n) if frames.dim() == 1
          else frames[None] if frames.dim() == 2
          else frames.reshape((-1,) + frames.shape[-2:]))
    k = n // 2 + 1
    ids = torch.empty(lead + (k,), dtype=torch.int32, device=frames.device)
    contrib = torch.empty(lead + (k,), dtype=torch.float32,
                          device=frames.device)
    dev = str(frames.device)
    th, tw = th_window(n, frames.device), _twiddles(n, dev)
    with torch.cuda.device(frames.device):
        rc = kernels_build.library().emspec_deposits(
            f3.data_ptr(), f3.shape[0], f3.shape[1], f3.stride(0),
            f3.stride(1), th.data_ptr(), tw.data_ptr(),
            logmap_a.data_ptr(), logmap_b.data_ptr(), power_floor.data_ptr(),
            ids.data_ptr(), contrib.data_ptr(), n, hop,
            float(np.float32(0.5 * np.pi / n)),
            float(np.float32(n / (2.0 * np.pi))), float(np.float32(sr / n)),
            float(np.float32(1.0 / float(n * n))), rows, reach,
            launch_stream(frames))
    kernels_build.check(rc, what)
    deposits_ids.launches += 1
    return ids, contrib


deposits_ids.launches = 0
