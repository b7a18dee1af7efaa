"""Kernel B1 wrapper — fused enhanced analysis, frames → deposits
(counterpart of ``emspec/dsp/pallas/fft4.py::fft4_deposits(reach=R)``),
and kernel B6, the same analysis fused with the relative histogram
(counterpart of ``fft4_hist``).

B1 has four routes on the card; ``route_of`` picks one by the frame size
alone, each with its own launch counter:

* "block", N ≤ 16384 (``SMALL_MAX_N``): ``csrc/deposits.cu``, one block a
  frame holding both signals' spectra in shared memory (kernel B4's
  radix FFT body) — ``deposits_ids.launches``, and by form in
  ``deposits_ids.form_launches``: "whole" (every bin, no band) or
  "window" (a bin window or a band weight);
* "cluster", N = 32768 (``CLUSTER_N``): ``csrc/deposits.cu``, one
  two-CTA thread-block cluster a frame, the raw and the t·h spectrum one
  CTA each, read across by distributed shared memory —
  ``deposits_ids_cluster.launches``;
* "cluster_large", N = 65536, 131072, 262144 (``CLUSTER_LARGE_N``):
  ``csrc/xcluster.cuh`` (built in ``csrc/deposits_large.cu``), one
  launch, a frame a cluster of 8, 16 and 16 CTAs holding both spectra in
  shared memory, each signal's FFT a four-step transform whose transpose
  crosses the CTAs through distributed shared memory
  (``cluster_large_plan``) —
  ``deposits_ids_cluster_large.launches``;
* "large", N > 16384: ``csrc/deposits_large.cu``'s three launches — a
  pack kernel, kernel B4's steps 1–3 on the packed half-size sequences
  (``fft4_steps123``, which counts its own launches), then a finish
  kernel for the unpack and the epilogue — ``deposits_ids_large.launches``.
  ``deposits_ids(..., route="large")`` forces it at 32768–262144, for
  timing the cluster routes against it.

Every route takes an optional bin window ``[k_lo, k_hi)`` and a per-bin
band weight (a band-sliced multires bank): only the window's bins are
written, (..., k_hi − k_lo), and contrib = (|X_h|²·band)/N², the order
of ``emspec/pipeline.py:420``; the edge bins read their true neighbours
k_lo − 1 and k_hi.  Without them the output is the whole spectrum, bit
for bit as before the window existed.

B6 (``deposits_hist``) has four routes, chosen by ``(n, num_bins)``
alone (``hist_route_of``), each counted in ``deposits_hist.route_launches``:
"block" (N ≤ 16384, B1's block with the histogram after its tiles),
"cluster" (N = 32768 and at most ``CLUSTER_HIST_CELLS`` cells: B1's
cluster, a histogram in each rank's shared memory, each rank storing
half of the cells), "cluster_large" (N = 65536 … 262144, and 32768 above
the cluster route's cells: B1's route cluster_large with the histogram
in the cluster's shared memory, one launch, a 4-CTA cluster a frame at
32768; its cells a private copy in each CTA, each rank storing its share
summed over the copies, or a band in each CTA that the other ranks add
into through distributed shared memory, by shape:
``cluster_large_bands``) and "large" (the three launches of
``deposits_large.cu``, their finish blocks adding into a zeroed output):
no shape routes there — cluster_large's bands hold more cells at every
size (``cluster_large_hist_cells``) than its 58,112 — and
``route="large"`` forces it, for timing.  The three one-launch routes
add through B2's warp merge (``csrc/histogram_common.cuh``).

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
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)
from emspec_torch.dsp.kernels.fourstep import (
    device_radix_tables, fft4_steps123)
from emspec_torch.dsp.kernels.rfft import unpack_twiddles as _twiddles
from emspec_torch.dsp.kernels.scatter import histogram_plain
from emspec_torch.dsp.reassign import reassignment_corrections
from emspec_torch.dsp.stft import stft_triple_stencil_plain, th_window

MIN_N = 512
SMALL_MAX_N = 16384    # block route: two (n1, n2 + 1) tiles in one block
CLUSTER_N = 32768      # cluster route: one 132 KB tile in each of two CTAs
MAX_N = 262144         # the large route: N/2 must have a B4 factorization
CLUSTER_LARGE_N = (65536, 131072, 262144)   # cluster_large's sizes
CLUSTER_LARGE_HIST_N = (CLUSTER_N,) + CLUSTER_LARGE_N   # ... B6's
ROUTES = ("block", "cluster", "cluster_large", "large")
HIST_ROUTES = ("block", "cluster", "cluster_large", "large")     # B6's
SMEM_BYTES = 232448    # a block's shared memory on the H100 (deposits.cu kMaxSmem)
CLUSTER_SMEM = 8 * (512 + 128 * 129 + 128 * 67)    # deposits.cu kClusterSmem
CLUSTER_HIST_CELLS = (SMEM_BYTES - CLUSTER_SMEM) // 4   # kClusterHistCells
TWO_CTA_SMEM = 228 * 1024 // 2 - 1024   # a CTA's most for two an SM (1 KB kept)


def supported(n: int) -> bool:
    """Frame sizes kernel B1 holds: powers of two in [512, 262144]."""
    return MIN_N <= n <= MAX_N and (n & (n - 1)) == 0


def route_of(n: int) -> str:
    """B1's route for frames of n points: by size only, never by batch."""
    return ("block" if n <= SMALL_MAX_N else "cluster" if n == CLUSTER_N
            else "cluster_large" if n in CLUSTER_LARGE_N else "large")


def cluster_large_plan(n: int) -> dict:
    """Route cluster_large at n (``xcluster.cuh`` ``xplan``; 32768
    for B6 alone, in four CTAs): each
    CTA holds ``points`` complex values of both signals in ``threads``
    threads of 16 points (8192 up to 131072, 16384 at 262144), C =
    n/points CTAs a cluster, (n1, n2) = _FACTORS[n/2]; before the exchange
    each rank holds ``cols`` = n2/C columns of both signals, row-major at
    stride ``stride_before`` (W'), after it ``rows`` = n1/C rows of every
    column, column-major at stride ``stride_after`` (Q), with rows·W' =
    cols·Q so that both layouts of one block fill the same values; a
    signal's tile is n1·W' = n2·Q values, and a CTA's shared memory B4's
    W_512 table and both tiles."""
    require(n in CLUSTER_LARGE_HIST_N, "cluster_large_plan",
            f"n={n}: the route takes {CLUSTER_LARGE_HIST_N} (32768: B6)")
    n1, n2 = _FACTORS[n // 2]
    points = 8192 if n <= 131072 else 16384
    ctas = n // points
    cols, rows = n2 // ctas, n1 // ctas
    if cols % rows == 0:
        before, after = cols + cols // rows, rows + 1
    else:
        before, after = cols + 1, rows + rows // cols
    tile = n1 * before
    return dict(points=points, threads=points // 16, ctas=ctas, n1=n1,
                n2=n2, cols=cols, rows=rows, stride_before=before,
                stride_after=after, tile=tile, smem=8 * (512 + 2 * tile))


def cluster_large_hist_cells(n: int, bands: bool = True) -> int:
    """B6's cells at most on route cluster_large at n: a CTA's shared
    memory beside its table and tiles holds 40,192 at 32768, 39,680 at
    65536 and 131072, 22,272 at 262144 — the copies' limit — and a band
    of C times as many (``bands``)."""
    plan = cluster_large_plan(n)
    return (SMEM_BYTES - plan["smem"]) // 4 * (plan["ctas"] if bands else 1)


def cluster_large_bands(n: int, num_bins: int) -> bool:
    """B6's cells on route cluster_large, by shape: a band in each CTA
    where a private copy in each would not fit or would cut two CTAs an SM
    to one while bands keep two (``TWO_CTA_SMEM``); else the copies, whose
    adds stay in their CTA (the H100's times, PERF.md §6)."""
    plan = cluster_large_plan(n)
    copies = plan["smem"] + 4 * num_bins
    bands = plan["smem"] + 4 * -(-num_bins // plan["ctas"])
    return copies > SMEM_BYTES or (copies > TWO_CTA_SMEM
                                   and bands <= TWO_CTA_SMEM)


def hist_route_of(n: int, num_bins: int) -> str:
    """B6's route for frames of n points into ``num_bins`` cells: by shape
    only, never by batch."""
    if n <= SMALL_MAX_N:
        return "block"
    if n == CLUSTER_N and num_bins <= CLUSTER_HIST_CELLS:
        return "cluster"
    return "cluster_large"     # holds more cells than "large" at every n


def block_smem(n: int, num_bins: int = 0) -> int:
    """Shared memory of the block route at n (B6: ``num_bins`` cells
    after the tiles): B4's W_512 table and two (n1, n2 + 1) tiles."""
    n1, n2 = _FACTORS[n // 2]
    return 8 * (512 + 2 * n1 * (n2 + 1)) + 4 * num_bins


def quantize_deposits(power, dt, dw, logmap_a, logmap_b, power_floor, *,
                      n: int, hop: int, sr: float, rows: int, band=None,
                      k_lo: int = 0):
    """Reassignment corrections of bins k_lo, k_lo + 1, … (..., K) →
    (row, delta, contrib).

    ``delta = round(Δt/hop)`` (a true division, half to even) is the
    relative column offset; contrib is zero for every invalid deposit
    (sub-floor power, row off the axis, f̂ ≤ 0, |Δt| > N/2).  ``band`` is
    the bank's band weight per bin (identically 1 for one bank)."""
    k_idx = torch.arange(k_lo, k_lo + power.shape[-1], dtype=torch.float32,
                         device=power.device)
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
                   hop: int, sr: float, rows: int, k_lo: int = 0,
                   k_hi: int | None = None, band=None):
    """frames (..., n) → (row, delta, contrib), each (..., k_hi − k_lo):
    the stencil spectra of the whole frame (two ``torch.fft.rfft`` on
    every device: ``stft_triple_stencil_plain``), the window's bins sliced
    out after the stencils, corrections, quantization with the band
    weight."""
    win = slice(k_lo, k_hi)
    spectra = tuple(a[..., win] for a in stft_triple_stencil_plain(frames))
    return quantize_deposits(
        *reassignment_corrections(*spectra), logmap_a, logmap_b,
        power_floor, n=n, hop=hop, sr=sr, rows=rows, band=band, k_lo=k_lo)


def deposits_ids_plain(frames, logmap_a, logmap_b, power_floor, *, n: int,
                       hop: int, sr: float, rows: int, reach: int,
                       k_lo: int = 0, k_hi: int | None = None, band=None):
    """Plain B1: (ids = (δ + reach)·rows + row, contrib)."""
    row, delta, contrib = deposits_plain(
        frames, logmap_a, logmap_b, power_floor, n=n, hop=hop, sr=sr,
        rows=rows, k_lo=k_lo, k_hi=k_hi, band=band)
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


def _window(frames: torch.Tensor, n: int, k_lo: int, k_hi, band,
            what: str) -> tuple:
    """Check a CUDA call's bin window and band → (k_lo, k_hi, band
    pointer or 0)."""
    k_hi = n // 2 + 1 if k_hi is None else k_hi
    require(0 <= k_lo < k_hi <= n // 2 + 1, what,
            f"bin window [{k_lo}, {k_hi}) outside [0, {n // 2 + 1})")
    require(band is None or (
        band.dtype == torch.float32 and band.shape == (k_hi - k_lo,)
        and band.is_contiguous() and band.device == frames.device), what,
        f"band must be a contiguous float32 ({k_hi - k_lo},) tensor on the "
        f"frames' device")
    return k_lo, k_hi, 0 if band is None else band.data_ptr()


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


def _outputs(frames: torch.Tensor, width: int):
    """Empty (ids int32, contrib float32), each (..., width)."""
    shape = frames.shape[:-1] + (width,)
    return (torch.empty(shape, dtype=torch.int32, device=frames.device),
            torch.empty(shape, dtype=torch.float32, device=frames.device))


def _on_chip(entry: str, frames, scal, *, n: int, hop: int, sr: float,
             rows: int, reach: int, k_lo: int, k_hi, band, what: str):
    """One launch of an on-chip route (block or cluster) of B1."""
    f3, th, tw, ptrs, consts = _launch_args(frames, scal, what, n=n, sr=sr)
    win = _window(frames, n, k_lo, k_hi, band, what)
    ids, contrib = _outputs(frames, win[1] - win[0])
    with torch.cuda.device(frames.device):
        rc = getattr(kernels_build.library(), entry)(
            *_frame_args(f3, th, tw, n), *ptrs, ids.data_ptr(),
            contrib.data_ptr(), n, *_FACTORS[n // 2], hop, *consts, rows,
            reach, *win, launch_stream(frames))
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
            win: tuple, what: str) -> None:
    """Large route, stage 3: unpack + epilogue of the window's bins
    (``ids`` given: B1) or the per-block histograms added into ``out``
    (``ids`` None: B6, the whole spectrum)."""
    n1, n2 = _FACTORS[n // 2]
    rc = kernels_build.library().emspec_deposits_finish(
        xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), *scal_ptrs,
        0 if ids is None else ids.data_ptr(), out.data_ptr(), frames, n, n1,
        n2, hop, *consts, rows, reach, min_id, num_bins, int(ids is None),
        *win, launch_stream(xr))
    kernels_build.check(rc, what)


@counted
def deposits_ids(frames: torch.Tensor, logmap_a, logmap_b, power_floor, *,
                 n: int, hop: int, sr: float, rows: int, reach: int,
                 route: str | None = None, k_lo: int = 0,
                 k_hi: int | None = None, band=None):
    """frames (..., n) float32 → (ids int32, contrib float32), each
    (..., k_hi − k_lo) in natural bin order (the whole spectrum, n//2+1
    bins, by default), contrib weighted by ``band`` (k_hi − k_lo,) where
    given.  Invalid deposits carry contrib 0 (and, from the kernel, id
    −1).  On CUDA the scalars and the band must be float32 tensors on the
    frames' device: the kernel reads them from device memory, so a slider
    move causes no host sync.  ``route`` (one of ``ROUTES``) overrides
    ``route_of(n)``, for timing the cluster routes against the large one;
    the block route takes n ≤ ``SMALL_MAX_N`` only, the cluster route
    n = ``CLUSTER_N`` only, cluster_large the sizes of
    ``CLUSTER_LARGE_N``."""
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=reach, k_lo=k_lo,
              k_hi=k_hi, band=band)
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  **kw)
    what = "deposits_ids"
    route = route or route_of(n)
    require(route in ROUTES and (route == "block") == (n <= SMALL_MAX_N)
            and (route != "cluster" or n == CLUSTER_N)
            and (route != "cluster_large" or n in CLUSTER_LARGE_N), what,
            f"route {route!r} does not take n={n}")
    scal = (logmap_a, logmap_b, power_floor)
    if route == "large":
        return deposits_ids_large(frames, *scal, **kw)
    if route == "cluster":
        return deposits_ids_cluster(frames, *scal, **kw)
    if route == "cluster_large":
        return deposits_ids_cluster_large(frames, *scal, **kw)
    out = _on_chip("emspec_deposits", frames, scal, what=what, **kw)
    deposits_ids.launches += 1
    deposits_ids.form_launches[
        "whole" if band is None and out[0].shape[-1] == n // 2 + 1
        else "window"] += 1
    return out


deposits_ids.form_launches = {"whole": 0, "window": 0}


@counted
def deposits_ids_cluster(frames: torch.Tensor, logmap_a, logmap_b,
                         power_floor, *, n: int, hop: int, sr: float,
                         rows: int, reach: int, k_lo: int = 0,
                         k_hi: int | None = None, band=None):
    """B1's cluster route, N = ``CLUSTER_N``: the contract of
    ``deposits_ids`` (a CPU tensor takes the plain version).  One launch,
    no scratch: each frame's spectra stay in its cluster's shared memory."""
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=reach, k_lo=k_lo,
              k_hi=k_hi, band=band)
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  **kw)
    what = "deposits_ids_cluster"
    require(n == CLUSTER_N, what, f"n={n}: the cluster route takes "
            f"n={CLUSTER_N} only")
    out = _on_chip("emspec_deposits_cluster", frames,
                   (logmap_a, logmap_b, power_floor), what=what, **kw)
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


@counted
def deposits_ids_cluster_large(frames: torch.Tensor, logmap_a, logmap_b,
                               power_floor, *, n: int, hop: int, sr: float,
                               rows: int, reach: int, k_lo: int = 0,
                               k_hi: int | None = None, band=None):
    """B1's route cluster_large, N in ``CLUSTER_LARGE_N``: the contract of
    ``deposits_ids`` (a CPU tensor takes the plain version).  One launch,
    no scratch: each frame's spectra stay in its cluster's shared memory.
    Raises where the card holds no cluster of the size
    (``cluster_large_occupancy``)."""
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=reach, k_lo=k_lo,
              k_hi=k_hi, band=band)
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  **kw)
    what = "deposits_ids_cluster_large"
    require(n in CLUSTER_LARGE_N, what, f"n={n}: the route takes "
            f"{CLUSTER_LARGE_N}")
    require_cuda(frames, what)
    require(cluster_large_occupancy(n, frames.device) > 0, what,
            f"the card holds no cluster of {cluster_large_plan(n)['ctas']} "
            f"CTAs")
    out = _on_chip("emspec_deposits_cluster_large", frames,
                   (logmap_a, logmap_b, power_floor), what=what, **kw)
    deposits_ids_cluster_large.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _cluster_large_occupancy(n: int, device: str, num_bins: int,
                             bands: bool) -> int:
    got = ctypes.c_int(0)
    lib = kernels_build.library()
    with torch.cuda.device(device):
        if num_bins == 0:                               # B1's kernel
            rc = lib.emspec_deposits_cluster_large_occupancy(
                n, *_FACTORS[n // 2], ctypes.byref(got))
        else:
            rc = getattr(lib, f"{_hist_entry(bands)}_occupancy")(
                n, *_FACTORS[n // 2], num_bins, ctypes.byref(got))
    kernels_build.check(rc, "cluster_large_occupancy")
    return got.value


def _hist_entry(bands: bool) -> str:
    """B6's C entry on route cluster_large for a design of its cells
    (``csrc/deposits_hist_copies.cu``, ``deposits_hist_bands.cu``)."""
    return ("emspec_deposits_hist_cluster_large_"
            + ("bands" if bands else "copies"))


def cluster_large_occupancy(n: int, device, num_bins: int = 0,
                            bands: bool = False) -> int:
    """Clusters of route cluster_large at n the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: the card refuses the size):
    B1's, or B6's with ``num_bins`` histogram cells in each CTA, or a band
    of them (``bands``)."""
    return _cluster_large_occupancy(n, str(torch.device(device)), num_bins,
                                    bands)


@counted
def deposits_ids_large(frames: torch.Tensor, logmap_a, logmap_b,
                       power_floor, *, n: int, hop: int, sr: float, rows: int,
                       reach: int, k_lo: int = 0, k_hi: int | None = None,
                       band=None):
    """B1's large-frame route, N in (``SMALL_MAX_N``, ``MAX_N``]: the
    contract of ``deposits_ids`` (a CPU tensor takes the plain version)."""
    if frames.device.type == "cpu":
        return deposits_ids_plain(frames, logmap_a, logmap_b, power_floor,
                                  n=n, hop=hop, sr=sr, rows=rows, reach=reach,
                                  k_lo=k_lo, k_hi=k_hi, band=band)
    what = "deposits_ids_large"
    require(n > SMALL_MAX_N, what, f"n={n}: sizes up to {SMALL_MAX_N} take "
            f"the block route (deposits_ids)")
    f3, th, tw, scal, consts = _launch_args(
        frames, (logmap_a, logmap_b, power_floor), what, n=n, sr=sr)
    win = _window(frames, n, k_lo, k_hi, band, what)
    ids, contrib = _outputs(frames, win[1] - win[0])
    with torch.cuda.device(frames.device):
        xr, xi = _packed_spectra(f3, th, n, what)
        _finish(xr, xi, tw, scal, consts, ids, contrib,
                frames=f3.shape[0] * f3.shape[1], n=n, hop=hop, rows=rows,
                reach=reach, min_id=0, num_bins=0, win=win, what=what)
    deposits_ids_large.launches += 1
    return ids, contrib


@counted
def deposits_hist(frames: torch.Tensor, logmap_a, logmap_b, power_floor,
                  min_id: int, *, n: int, hop: int, sr: float, rows: int,
                  reach: int, route: str | None = None,
                  bands: bool | None = None) -> torch.Tensor:
    """Kernel B6: frames (..., n) → per-frame relative histograms
    (..., (2·reach+1)·rows) float32, bin (δ + reach)·rows + row — B1 and
    B2 fused, the deposits never in device memory.  Deposits whose id is
    below ``min_id`` (a host int: the streaming mask (R − t)·rows; batch
    callers pass −2³⁰) are dropped, and ids outside the histogram add
    nothing.  The route is ``hist_route_of(n, num_bins)`` (module
    docstring); ``route`` forces one, for timing the routes against each
    other, and is refused where its shared memory or frame size does not
    take the shape.  Route cluster_large takes 32768–262144 up to
    ``cluster_large_hist_cells(n)`` cells (160,768 at 32768, 317,440 at
    65536 and 131072, 356,352 at 262144), its cells a copy in each CTA or
    a band in each (``cluster_large_bands``; ``bands`` forces one, for
    timing; refused on the other routes); the three-launch route "large"
    takes every N above 16384 up to 58,112 cells, fewer than cluster_large
    holds at every size, so it runs only where forced."""
    num_bins = (2 * reach + 1) * rows
    what = "deposits_hist"
    require(supported(n), what, f"n={n} outside the kernel's power-of-two "
            f"range [{MIN_N}, {MAX_N}]")
    route = route or hist_route_of(n, num_bins)
    require(route in HIST_ROUTES, what,
            f"route {route!r} not in {HIST_ROUTES}")
    require((route == "block") == (n <= SMALL_MAX_N)
            and (route != "cluster" or n == CLUSTER_N)
            and (route != "cluster_large" or n in CLUSTER_LARGE_HIST_N),
            what, f"route {route!r} does not take n={n}")
    require(bands is None or route == "cluster_large", what,
            f"bands picks the cells of route cluster_large, not {route!r}")
    if route == "cluster_large":
        bands = (cluster_large_bands(n, num_bins) if bands is None
                 else bool(bands))
    limit = ((SMEM_BYTES - block_smem(n)) // 4 if route == "block"
             else CLUSTER_HIST_CELLS if route == "cluster"
             else cluster_large_hist_cells(n, bands)
             if route == "cluster_large" else SMEM_BYTES // 4)
    require(num_bins <= limit, what,
            f"{num_bins} histogram cells at n={n}: the {route} route holds "
            f"at most {limit} in shared memory"
            + (" as private copies" if route == "cluster_large"
               and not bands else ""))
    if frames.device.type == "cpu":
        return deposits_hist_plain(frames, logmap_a, logmap_b, power_floor,
                                   min_id, n=n, hop=hop, sr=sr, rows=rows,
                                   reach=reach)
    f3, th, tw, scal, consts = _launch_args(
        frames, (logmap_a, logmap_b, power_floor), what, n=n, sr=sr)
    lead = frames.shape[:-1]
    with torch.cuda.device(frames.device):
        if route == "large":
            out = torch.zeros(lead + (num_bins,), dtype=torch.float32,
                              device=frames.device)
            xr, xi = _packed_spectra(f3, th, n, what)
            _finish(xr, xi, tw, scal, consts, None, out,
                    frames=f3.shape[0] * f3.shape[1], n=n, hop=hop,
                    rows=rows, reach=reach, min_id=min_id,
                    num_bins=num_bins, win=(0, n // 2 + 1, 0), what=what)
        else:
            if route == "cluster_large":
                require(cluster_large_occupancy(n, frames.device,
                                                num_bins, bands) > 0, what,
                        f"the card holds no cluster of "
                        f"{cluster_large_plan(n)['ctas']} CTAs with "
                        f"{num_bins} cells each")
            out = torch.empty(lead + (num_bins,), dtype=torch.float32,
                              device=frames.device)
            entry = {"block": "emspec_deposits_hist",
                     "cluster": "emspec_deposits_hist_cluster"
                     }.get(route) or _hist_entry(bands)
            rc = getattr(kernels_build.library(), entry)(
                *_frame_args(f3, th, tw, n), *scal, out.data_ptr(), n,
                *_FACTORS[n // 2], hop, *consts, rows, reach, min_id,
                num_bins, launch_stream(frames))
            kernels_build.check(rc, what)
    deposits_hist.launches += 1
    deposits_hist.route_launches[route] += 1
    return out


deposits_hist.route_launches = dict.fromkeys(HIST_ROUTES, 0)
