"""Where kernel B2's time sits: B2 with single stages stubbed out
(counterpart of ``bench_probes/scatter_ablation.py::hist_variant``;
source ``emspec_torch/csrc/scatter_ablation.cu``, which describes each
variant).

The TPU probe stubbed the one-hot GEMM stages of its histogram, which B2
does not have; this one stubs B2's own stages.  Each variant has a plain
PyTorch version of its own arithmetic, ``hist_variant_plain``:

* ``full``: B2 itself — ``histogram_plain`` within B2's bound;
* ``no_atomic``: 1 where an in-range deposit with value ≥ 0 lands, else 0;
* ``no_zero``: within each group of ``NO_ZERO_ROWS`` consecutive rows,
  the running sum of the rows' histograms;
* ``io_only``: cell i holds Σ of the in-range values at positions
  j ≡ i mod ``THREADS``, added in index order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import launch_stream, require, require_cuda
from emspec_torch.dsp.kernels.scatter import SMEM_BINS, histogram_plain

VARIANTS = ("full", "no_atomic", "no_zero", "io_only")
THREADS = 512          # scatter_ablation.cu kThreads
NO_ZERO_ROWS = 4       # scatter_ablation.cu kNoZeroRows


def hist_variant_plain(ids: torch.Tensor, vals: torch.Tensor,
                       num_bins: int, variant: str) -> torch.Tensor:
    """ids, vals (b, m) → (b, num_bins) float32, each variant's own
    arithmetic (module docstring)."""
    if variant == "full":
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
        b, m = ids.shape
        ok = (ids >= 0) & (ids < num_bins)
        v = torch.where(ok, vals, torch.zeros_like(vals))
        v = F.pad(v, (0, -m % THREADS)).reshape(b, -1, THREADS)
        s = torch.zeros((b, THREADS), dtype=torch.float32, device=ids.device)
        for j in range(v.shape[1]):                    # index order
            s = s + v[:, j]
        reps = math.ceil(num_bins / THREADS)
        return s.repeat(1, reps)[:, :num_bins]
    raise ValueError(f"hist_variant: unknown variant {variant!r}")


def hist_variant(ids: torch.Tensor, vals: torch.Tensor, num_bins: int,
                 variant: str) -> torch.Tensor:
    """ids (b, m) int32, vals (b, m) float32 → (b, num_bins) float32 by
    the probe kernel's ``variant`` (a CPU tensor takes the plain version)."""
    require(variant in VARIANTS, "hist_variant",
            f"variant {variant!r} not in {VARIANTS}")
    if ids.device.type == "cpu":
        return hist_variant_plain(ids, vals, num_bins, variant)
    what = "hist_variant"
    require_cuda(ids, what)
    require(ids.dim() == 2 and ids.shape == vals.shape
            and ids.dtype == torch.int32 and vals.dtype == torch.float32
            and vals.device == ids.device and ids.is_contiguous()
            and vals.is_contiguous(), what,
            "ids int32 and vals float32 must be contiguous (b, m) tensors "
            "of one shape and device")
    require(0 < num_bins <= SMEM_BINS, what,
            f"num_bins={num_bins} outside (0, {SMEM_BINS}] (shared memory)")
    b, m = ids.shape
    out = torch.empty((b, num_bins), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_hist_variant(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), b, m, num_bins,
            VARIANTS.index(variant), launch_stream(ids))
    kernels_build.check(rc, what)
    hist_variant.launches += 1
    return out


hist_variant.launches = 0
