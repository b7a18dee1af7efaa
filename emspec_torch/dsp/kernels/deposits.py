"""Kernel B1 wrapper — fused enhanced analysis, frames → deposits
(counterpart of ``emspec/dsp/pallas/fft4.py::fft4_deposits(reach=R)``),
and kernel B6, the same analysis fused with the relative histogram
(counterpart of ``fft4_hist``).

B1 has three routes on the card, chosen by the frame size alone
(``route_of``), each with its own launch counter:

* "block", N ≤ 16384 (``SMALL_MAX_N``): ``csrc/deposits.cu``, one block a
  frame holding both signals' spectra in shared memory (kernel B4's
  radix FFT body) — ``deposits_ids.launches``;
* "cluster", N = 32768 (``CLUSTER_N``): ``csrc/deposits.cu``, one
  two-CTA thread-block cluster a frame, the raw and the t·h spectrum one
  CTA each, read across by distributed shared memory —
  ``deposits_ids_cluster.launches``;
* "large", N > 16384: ``csrc/deposits_large.cu`` — a pack kernel, kernel
  B4's steps 1–3 on the packed half-size sequences (``fft4_steps123``,
  which counts its own launches), then a finish kernel for the unpack and
  the epilogue — ``deposits_ids_large.launches``.  It is the route above
  32768, and ``deposits_ids(..., route="large")`` forces it at 32768.

``quantize_deposits`` is the single definition of the quantization
contract (``emspec.pipeline.Pipeline._deposits_banked``,
``pipeline.py:409-423``): the pipeline's unfused paths and the kernels'
plain versions all call it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.fourstep import _FACTORS
from emspec_torch.dsp.kernels import launch_stream, require, require_cuda
from emspec_torch.dsp.kernels.fourstep import (
    device_radix_tables, fft4_steps123)
from emspec_torch.dsp.kernels.scatter import SMEM_BINS, histogram_plain
from emspec_torch.dsp.reassign import reassignment_corrections
from emspec_torch.dsp.stft import stft_triple_stencil, th_window

MIN_N = 512
SMALL_MAX_N = 16384    # block route: two (n1, n2 + 1) tiles in one block
CLUSTER_N = 32768      # cluster route: one 132 KB tile in each of two CTAs
MAX_N = 262144         # the large route: N/2 must have a B4 factorization
ROUTES = ("block", "cluster", "large")


def supported(n: int) -> bool:
    """Frame sizes kernel B1 holds: powers of two in [512, 262144]."""
    return MIN_N <= n <= MAX_N and (n & (n - 1)) == 0


def route_of(n: int) -> str:
    """B1's route for frames of n points: by size only, never by batch."""
    return ("block" if n <= SMALL_MAX_N else "cluster" if n == CLUSTER_N
            else "large")


def block_smem(n: int, num_bins: int = 0) -> int:
    """Shared memory of the block route at n (B6: ``num_bins`` cells
    after the tiles): B4's W_512 table and two (n1, n2 + 1) tiles."""
    n1, n2 = _FACTORS[n // 2]
    return 8 * (512 + 2 * n1 * (n2 + 1)) + 4 * num_bins


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


def deposits_hist_plain(frames, logmap_a, logmap_b, power_floor, min_id: int,
                        *, n: int, hop: int, sr: float, rows: int,
                        reach: int):
    """Plain B6: the relative histogram (..., (2·reach+1)·rows) of plain
    B1's deposits, ids below ``min_id`` dropped."""
    ids, contrib = deposits_ids_plain(
        frames, logmap_a, logmap_b, power_floor, n=n, hop=hop, sr=sr,
        rows=rows, reach=reach)
    return histogram_plain(torch.where(ids >= min_id, ids, -1), contrib,
                           (2 * reach + 1) * rows)


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: str) -> torch.Tensor:
    """e^{-2πij/n}, j < n/2, built in float64, stored as float32 pairs."""
    ang = -2.0 * np.pi * np.arange(n // 2) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def _launch_args(frames: torch.Tensor, scal, what: str, *, n: int, sr: float):
    """Check a CUDA call of B1 or B6 → (f3, th, tw, scalars, constants):
    frames as a (lead, frames_per_lead, n) view read through its strides,
    the window tables, the device scalars and the float32 constants
    (c_dh, N/2π, sr/N, 1/N²)."""
    require_cuda(frames, what)
    require(supported(n), what, f"n={n} outside the kernel's power-of-two "
            f"range [{MIN_N}, {MAX_N}]")
    require(frames.dtype == torch.float32 and frames.shape[-1] == n
            and frames.stride(-1) == 1, what,
            f"frames must be float32 (..., {n}) with unit last stride")
    require(all(isinstance(s, torch.Tensor) and s.numel() == 1
                and s.dtype == torch.float32 and s.device == frames.device
                for s in scal), what,
            "logmap_a, logmap_b, power_floor must be float32 scalars on "
            "the frames' device")
    f3 = (frames.reshape(1, 1, n) if frames.dim() == 1
          else frames[None] if frames.dim() == 2
          else frames.reshape((-1,) + frames.shape[-2:]))
    consts = (float(np.float32(0.5 * np.pi / n)),
              float(np.float32(n / (2.0 * np.pi))), float(np.float32(sr / n)),
              float(np.float32(1.0 / float(n * n))))
    return (f3, th_window(n, frames.device), _twiddles(n, str(frames.device)),
            tuple(s.data_ptr() for s in scal), consts)


def _frame_args(f3: torch.Tensor, th, tw, n: int) -> tuple:
    """The leading arguments of the on-chip routes' C entry points: the
    frames view, the t·h window, B4's tables for (n1, n2) = _FACTORS[N/2]
    and the unpack twiddles."""
    w512, tw4 = device_radix_tables(*_FACTORS[n // 2], f3.device)
    return (f3.data_ptr(), f3.shape[0], f3.shape[1], f3.stride(0),
            f3.stride(1), th.data_ptr(), w512.data_ptr(), tw4.data_ptr(),
            tw.data_ptr())


def _outputs(frames: torch.Tensor, n: int):
    """Empty (ids int32, contrib float32), each (..., n//2+1)."""
    shape = frames.shape[:-1] + (n // 2 + 1,)
    return (torch.empty(shape, dtype=torch.int32, device=frames.device),
            torch.empty(shape, dtype=torch.float32, device=frames.device))


def _on_chip(entry: str, frames, scal, *, n: int, hop: int, sr: float,
             rows: int, reach: int, what: str):
    """One launch of an on-chip route (block or cluster) of B1."""
    f3, th, tw, ptrs, consts = _launch_args(frames, scal, what, n=n, sr=sr)
    ids, contrib = _outputs(frames, n)
    with torch.cuda.device(frames.device):
        rc = getattr(kernels_build.library(), entry)(
            *_frame_args(f3, th, tw, n), *ptrs, ids.data_ptr(),
            contrib.data_ptr(), n, *_FACTORS[n // 2], hop, *consts, rows,
            reach, launch_stream(frames))
    kernels_build.check(rc, what)
    return ids, contrib


def _packed_spectra(f3: torch.Tensor, th: torch.Tensor, n: int, what: str):
    """Large route, stages 1–2: pack each frame's raw and t·h signals into
    two N/2-point complex sequences (2f and 2f+1), then B4's steps 1–3 →
    X[k1, k2] planes (2·frames, n1, n2), before the step-4 reindex."""
    n1, n2 = _FACTORS[n // 2]
    planes = torch.empty((2, 2 * f3.shape[0] * f3.shape[1], n1, n2),
                         dtype=torch.float32, device=f3.device)
    rc = kernels_build.library().emspec_deposits_pack(
        f3.data_ptr(), f3.shape[0], f3.shape[1], f3.stride(0), f3.stride(1),
        th.data_ptr(), planes[0].data_ptr(), planes[1].data_ptr(), n,
        launch_stream(f3))
    kernels_build.check(rc, what)
    return fft4_steps123(planes[0], planes[1])


def _finish(xr, xi, tw, scal_ptrs, consts, ids, out, *, frames: int, n: int,
            hop: int, rows: int, reach: int, min_id: int, num_bins: int,
            what: str) -> None:
    """Large route, stage 3: unpack + epilogue (``ids`` given: B1) or the
    per-block histograms added into ``out`` (``ids`` None: B6)."""
    n1, n2 = _FACTORS[n // 2]
    rc = kernels_build.library().emspec_deposits_finish(
        xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), *scal_ptrs,
        0 if ids is None else ids.data_ptr(), out.data_ptr(), frames, n, n1,
        n2, hop, *consts, rows, reach, min_id, num_bins, int(ids is None),
        launch_stream(xr))
    kernels_build.check(rc, what)


def deposits_ids(frames: torch.Tensor, logmap_a, logmap_b, power_floor, *,
                 n: int, hop: int, sr: float, rows: int, reach: int,
                 route: str | None = None):
    """frames (..., n) float32 → (ids int32, contrib float32), each
    (..., n//2+1) in natural bin order.  Invalid deposits carry contrib 0
    (and, from the kernel, id −1).  On CUDA the scalars must be float32
    tensors on the frames' device: the kernel reads them from device
    memory, so a slider move causes no host sync.  ``route`` ("block",
    "cluster" or "large") overrides ``route_of(n)``, for timing the
    cluster route against the large one at 32768; the block route takes
    n ≤ ``SMALL_MAX_N`` only, the cluster route n = ``CLUSTER_N`` only."""
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  n=n, hop=hop, sr=sr, rows=rows, reach=reach)
    what = "deposits_ids"
    route = route or route_of(n)
    require(route in ROUTES and (route == "block") == (n <= SMALL_MAX_N)
            and (route != "cluster" or n == CLUSTER_N), what,
            f"route {route!r} does not take n={n}")
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=reach)
    scal = (logmap_a, logmap_b, power_floor)
    if route == "large":
        return deposits_ids_large(frames, *scal, **kw)
    if route == "cluster":
        return deposits_ids_cluster(frames, *scal, **kw)
    out = _on_chip("emspec_deposits", frames, scal, what=what, **kw)
    deposits_ids.launches += 1
    return out


def deposits_ids_cluster(frames: torch.Tensor, logmap_a, logmap_b,
                         power_floor, *, n: int, hop: int, sr: float,
                         rows: int, reach: int):
    """B1's cluster route, N = ``CLUSTER_N``: the contract of
    ``deposits_ids`` (a CPU tensor takes the plain version).  One launch,
    no scratch: each frame's spectra stay in its cluster's shared memory."""
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  n=n, hop=hop, sr=sr, rows=rows, reach=reach)
    what = "deposits_ids_cluster"
    require(n == CLUSTER_N, what, f"n={n}: the cluster route takes "
            f"n={CLUSTER_N} only")
    out = _on_chip("emspec_deposits_cluster", frames,
                   (logmap_a, logmap_b, power_floor), n=n, hop=hop, sr=sr,
                   rows=rows, reach=reach, what=what)
    deposits_ids_cluster.launches += 1
    return out


def cluster_occupancy(device) -> int:
    """Two-CTA clusters of the cluster route the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    got = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = kernels_build.library().emspec_deposits_cluster_occupancy(
            ctypes.byref(got))
    kernels_build.check(rc, "cluster_occupancy")
    return got.value


def deposits_ids_large(frames: torch.Tensor, logmap_a, logmap_b,
                       power_floor, *, n: int, hop: int, sr: float, rows: int,
                       reach: int):
    """B1's large-frame route, N in (``SMALL_MAX_N``, ``MAX_N``]: the
    contract of ``deposits_ids`` (a CPU tensor takes the plain version)."""
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  n=n, hop=hop, sr=sr, rows=rows, reach=reach)
    what = "deposits_ids_large"
    require(n > SMALL_MAX_N, what, f"n={n}: sizes up to {SMALL_MAX_N} take "
            f"the block route (deposits_ids)")
    f3, th, tw, scal, consts = _launch_args(
        frames, (logmap_a, logmap_b, power_floor), what, n=n, sr=sr)
    ids, contrib = _outputs(frames, n)
    with torch.cuda.device(frames.device):
        xr, xi = _packed_spectra(f3, th, n, what)
        _finish(xr, xi, tw, scal, consts, ids, contrib,
                frames=f3.shape[0] * f3.shape[1], n=n, hop=hop, rows=rows,
                reach=reach, min_id=0, num_bins=0, what=what)
    deposits_ids_large.launches += 1
    return ids, contrib


def deposits_hist(frames: torch.Tensor, logmap_a, logmap_b, power_floor,
                  min_id: int, *, n: int, hop: int, sr: float, rows: int,
                  reach: int) -> torch.Tensor:
    """Kernel B6: frames (..., n) → per-frame relative histograms
    (..., (2·reach+1)·rows) float32, bin (δ + reach)·rows + row — B1 and
    B2 fused, the deposits never in device memory.  Deposits whose id is
    below ``min_id`` (a host int: the streaming mask (R − t)·rows; batch
    callers pass −2³⁰) are dropped, and ids outside the histogram add
    nothing.  N ≤ 16384: B1's block route with the histogram in shared
    memory after the tiles; larger N: the large route, whose finish
    blocks add their histograms atomically into the zeroed output."""
    if frames.device.type == "cpu":
        return deposits_hist_plain(frames, logmap_a, logmap_b, power_floor,
                                   min_id, n=n, hop=hop, sr=sr, rows=rows,
                                   reach=reach)
    what = "deposits_hist"
    f3, th, tw, scal, consts = _launch_args(
        frames, (logmap_a, logmap_b, power_floor), what, n=n, sr=sr)
    num_bins = (2 * reach + 1) * rows
    small = n <= SMALL_MAX_N
    smem = block_smem(n, num_bins) if small else 4 * num_bins
    require(num_bins <= SMEM_BINS and smem <= 4 * SMEM_BINS, what,
            f"{num_bins} histogram cells at n={n} need {smem} B of shared "
            f"memory, over {4 * SMEM_BINS}")
    frames_n = f3.shape[0] * f3.shape[1]
    lead = frames.shape[:-1]
    with torch.cuda.device(frames.device):
        if small:
            out = torch.empty(lead + (num_bins,), dtype=torch.float32,
                              device=frames.device)
            rc = kernels_build.library().emspec_deposits_hist(
                *_frame_args(f3, th, tw, n), *scal, out.data_ptr(), n,
                *_FACTORS[n // 2], hop, *consts, rows, reach, min_id,
                num_bins, launch_stream(frames))
            kernels_build.check(rc, what)
        else:
            out = torch.zeros(lead + (num_bins,), dtype=torch.float32,
                              device=frames.device)
            xr, xi = _packed_spectra(f3, th, n, what)
            _finish(xr, xi, tw, scal, consts, None, out, frames=frames_n,
                    n=n, hop=hop, rows=rows, reach=reach, min_id=min_id,
                    num_bins=num_bins, what=what)
    deposits_hist.launches += 1
    return out


deposits_ids.launches = 0
deposits_ids_cluster.launches = 0
deposits_ids_large.launches = 0
deposits_hist.launches = 0
