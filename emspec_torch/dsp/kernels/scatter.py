"""Kernel B2 wrapper — per-row histogram (the reassignment scatter-add)
(counterpart of ``emspec/dsp/pallas/scatter.py::histogram_matmul``;
source ``emspec_torch/csrc/histogram.cu``)."""

from __future__ import annotations

import math

import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import launch_stream, require, require_cuda

# float32 cells one block's shared memory holds (227 KB on the H100)
MAX_BINS = 232448 // 4


def histogram_plain(ids: torch.Tensor, vals: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """``histogram_reference``: per leading row, Σ vals into cells by id.
    Out-of-range ids go to a discarded overflow cell with value 0, so a
    NaN/Inf behind a dropped id never lands."""
    lead = ids.shape[:-1]
    b = math.prod(lead)
    ok = (ids >= 0) & (ids < num_bins)
    safe = torch.where(ok, ids, num_bins).to(torch.int64).reshape(b, -1)
    safe = safe + (torch.arange(b, device=ids.device)
                   * (num_bins + 1))[:, None]
    v = torch.where(ok, vals, torch.zeros_like(vals)).reshape(-1)
    out = torch.zeros(b * (num_bins + 1), dtype=torch.float32,
                      device=ids.device)
    out.index_add_(0, safe.reshape(-1), v)
    return out.view(b, num_bins + 1)[:, :num_bins].reshape(lead + (num_bins,))


def histogram(ids: torch.Tensor, vals: torch.Tensor, num_bins: int,
              passes: int = 2) -> torch.Tensor:
    """ids (..., M) int32, vals (..., M) float32 → (..., num_bins) float32.

    An id outside [0, num_bins) contributes nothing, even when its value
    is NaN or Inf.  ``passes`` is accepted for the JAX signature and is
    moot here: the kernel adds in float32 atomics, each exact to one
    rounding (the TPU kernel split values into bf16 terms)."""
    del passes
    if ids.device.type == "cpu":
        return histogram_plain(ids, vals, num_bins)
    what = "histogram"
    require_cuda(ids, what)
    require(ids.dtype == torch.int32 and vals.dtype == torch.float32, what,
            "ids must be int32 and vals float32")
    require(ids.shape == vals.shape and vals.device == ids.device, what,
            "ids and vals must share shape and device")
    require(ids.is_contiguous() and vals.is_contiguous(), what,
            "ids and vals must be contiguous")
    require(0 < num_bins <= MAX_BINS, what,
            f"num_bins={num_bins} outside (0, {MAX_BINS}] (shared memory)")
    lead = ids.shape[:-1]
    m = ids.shape[-1] if ids.dim() else 1
    out = torch.empty(lead + (num_bins,), dtype=torch.float32,
                      device=ids.device)
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), math.prod(lead),
            m, num_bins, launch_stream(ids))
    kernels_build.check(rc, what)
    histogram.launches += 1
    return out


histogram.launches = 0
