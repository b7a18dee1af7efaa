"""Where kernel B2's time sits: B2 with single stages taken out
(counterpart of ``bench_probes/scatter_ablation.py::hist_variant``;
source ``emspec_torch/csrc/scatter_ablation.cu``, which describes each
variant).

The TPU probe stubbed the one-hot GEMM stages of its histogram, which B2
does not have; this one takes out B2's own stages.  Every variant runs
B2's device code (``csrc/histogram_common.cuh``) on the route B2 takes
for the shape (``scatter.route_of``), so ``full`` *is* B2 and "full minus
variant" is what that stage costs.  Each variant has a plain PyTorch
version of its own arithmetic, ``hist_variant_plain``:

* ``full``: B2 itself — ``histogram_plain``;
* ``no_merge`` (no warp merge: every lane its own atomic) —
  ``histogram_plain``;
* ``no_atomic`` (each add a plain store of 1 where the lane's or merged
  group's sum is ≥ 0): 1 where an in-range deposit with value ≥ 0 lands,
  else 0 (for values ≥ 0, as every caller's; a cell whose deposits mix
  signs may read either);
* ``no_zero`` (row route only: one zero-fill per ``NO_ZERO_ROWS`` rows):
  within each group of ``NO_ZERO_ROWS`` consecutive rows, the running
  sum of the rows' histograms;
* ``io_only`` (the sink a per-thread register sum): each thread's sum
  of the in-range values ``consume`` hands it, in its order — vector j
  of a range (16-byte loads, after a head of up to three elements to the
  16-byte boundary) to thread j mod T, its four elements in order, then
  the head's elements to threads 0–2 and the tail's to threads 4–6 (4-byte
  path: element j to thread j mod T) — written to cell i of a row from
  thread i mod 512 (row route: a block a row) or to flat cell c from
  thread c mod T (global: T = the grid's threads over the flat stream).

The TPU probe's ``no_gemm`` stage has no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)
from emspec_torch.dsp.kernels.scatter import (
    GLOBAL_THREADS, ROUTES, ROW_THREADS, global_blocks, histogram_plain,
    route_of)

VARIANTS = ("full", "no_merge", "no_atomic", "no_zero", "io_only")
ROW_ONLY = ("no_zero",)            # variants with a meaning on the row route
NO_ZERO_ROWS = 4                   # scatter_ablation.cu kNoZeroRows


def alignment(ids: torch.Tensor, vals: torch.Tensor) -> tuple:
    """(a0, vec) as B2's wrapper passes them: ids' address / 4 mod 4, and
    whether vals shares the 16-byte alignment (16-byte loads)."""
    a0 = ids.data_ptr() % 16
    return a0 // 4, vals.data_ptr() % 16 == a0


def _thread_sums(v: torch.Tensor, head: int, vec: bool,
                 threads: int) -> torch.Tensor:
    """``consume`` over each row of v (r, L) as one range split over
    ``threads`` threads, the sink a register sum → (r, threads) float32,
    each thread adding its elements in its order."""
    r, n = v.shape
    acc = torch.zeros((r, threads), dtype=torch.float32, device=v.device)
    if not vec:
        steps = F.pad(v, (0, -n % threads)).reshape(r, -1, threads)
        for s in range(steps.shape[1]):
            acc = acc + steps[:, s]
        return acc
    head = min(n, head)
    nv = (n - head) >> 2
    body = v[:, head:head + 4 * nv].reshape(r, nv, 4)
    body = F.pad(body, (0, 0, 0, -nv % threads)).reshape(r, -1, threads, 4)
    for s in range(body.shape[1]):
        for k in range(4):
            acc = acc + body[:, s, :, k]
    acc[:, :head] += v[:, :head]                          # lanes 0–2
    tail = n - head - 4 * nv
    acc[:, 4:4 + tail] += v[:, head + 4 * nv:]            # lanes 4–6
    return acc


def _io_only(ids, vals, num_bins: int, route: str, a0: int,
             vec: bool) -> torch.Tensor:
    b, m = ids.shape
    v = torch.where((ids >= 0) & (ids < num_bins), vals,
                    torch.zeros_like(vals))
    if route == "global":
        threads = global_blocks(b, m) * GLOBAL_THREADS
        s = _thread_sums(v.reshape(1, -1), (4 - (a0 & 3)) & 3, vec,
                         threads)[0]
        cell = torch.arange(b * num_bins, device=ids.device) % threads
        return s[cell].reshape(b, num_bins)
    sums = torch.empty((b, ROW_THREADS), dtype=torch.float32,
                       device=ids.device)
    heads = (4 - ((a0 + torch.arange(b) * m) & 3)) & 3     # by row start
    for h in range(4):
        rs = torch.nonzero(heads == h).reshape(-1).to(ids.device)
        if rs.numel():
            sums[rs] = _thread_sums(v[rs], h, vec, ROW_THREADS)
    return sums[:, torch.arange(num_bins, device=ids.device) % ROW_THREADS]


def hist_variant_plain(ids: torch.Tensor, vals: torch.Tensor,
                       num_bins: int, variant: str, *,
                       a0: int | None = None,
                       vec: bool | None = None) -> torch.Tensor:
    """ids, vals (b, m) → (b, num_bins) float32, each variant's own
    arithmetic (module docstring).  ``io_only`` follows the kernel's
    thread map at the route B2 takes for the shape, for the alignment
    ``(a0, vec)`` (by default the tensors' own, as the kernel sees it)."""
    if variant in ("full", "no_merge"):
        return histogram_plain(ids, vals, num_bins)
    if variant == "no_atomic":
        hit = histogram_plain(torch.where(vals >= 0, ids, -1),
                              torch.ones_like(vals), num_bins)
        return (hit > 0).float()
    if variant == "no_zero":
        h = histogram_plain(ids, vals, num_bins)
        b = h.shape[0]
        pad = -b % NO_ZERO_ROWS
        g = F.pad(h, (0, 0, 0, pad)).reshape(-1, NO_ZERO_ROWS, num_bins)
        run = [g[:, 0]]
        for r in range(1, NO_ZERO_ROWS):
            run.append(run[-1] + g[:, r])
        return torch.stack(run, 1).reshape(-1, num_bins)[:b]
    if variant == "io_only":
        own = alignment(ids, vals)
        b, m = ids.shape
        return _io_only(ids, vals, num_bins, route_of(b, m, num_bins),
                        own[0] if a0 is None else a0,
                        own[1] if vec is None else vec)
    raise ValueError(f"hist_variant: unknown variant {variant!r}")


@counted
def hist_variant(ids: torch.Tensor, vals: torch.Tensor, num_bins: int,
                 variant: str) -> torch.Tensor:
    """ids (b, m) int32, vals (b, m) float32 → (b, num_bins) float32 by
    the probe kernel's ``variant``, on the route B2 takes for the shape
    (a CPU tensor takes the plain version).  ``no_zero`` needs the row
    route."""
    what = "hist_variant"
    require(variant in VARIANTS, what,
            f"variant {variant!r} not in {VARIANTS}")
    require(ids.dim() == 2 and ids.shape == vals.shape, what,
            "ids and vals must be (b, m) tensors of one shape")
    b, m = ids.shape
    route = route_of(b, m, num_bins)
    require(route == "row" or variant not in ROW_ONLY, what,
            f"{variant} is a row-route variant; ({b}, {m}) → {num_bins} "
            f"takes the {route} route")
    if ids.device.type == "cpu":
        return hist_variant_plain(ids, vals, num_bins, variant)
    require_cuda(ids, what)
    require(ids.dtype == torch.int32 and vals.dtype == torch.float32
            and vals.device == ids.device and ids.is_contiguous()
            and vals.is_contiguous(), what,
            "ids int32 and vals float32 must be contiguous tensors on one "
            "device")
    require(0 < num_bins < 2**31, what,
            f"num_bins={num_bins} outside (0, 2**31)")
    alloc = (torch.zeros if route == "global" and variant != "io_only"
             else torch.empty)
    out = alloc((b, num_bins), dtype=torch.float32, device=ids.device)
    a0, vec = alignment(ids, vals)
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_hist_variant(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), b, m, num_bins,
            VARIANTS.index(variant), ROUTES.index(route),
            global_blocks(b, m), a0, int(vec), launch_stream(ids))
    kernels_build.check(rc, what)
    hist_variant.launches += 1
    return out
