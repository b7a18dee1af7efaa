"""Kernel B2 wrapper — per-row histogram (the reassignment scatter-add)
(counterpart of ``emspec/dsp/pallas/scatter.py::histogram_matmul``;
source ``emspec_torch/csrc/histogram.cu``).

Two routes on the card, chosen by the shape ``(rows, m, num_bins)``
alone (``route_of``), never by the data:

* "row": one block a row, the row's histogram in shared memory, stored
  whole (no zeroed output) — where the rows alone give every SM two
  blocks (``ROW_MIN_ROWS``) and four such blocks fit an SM's shared
  memory (``ROW_MAX_BINS``);
* "global": every other shape, every ``num_bins`` above a block's shared
  memory (``SMEM_BINS``) included: the flat rows·m stream of deposits,
  spread over ``global_blocks`` blocks whatever the row count, goes
  straight into a zeroed output with global atomics.

Both merge equal ids within a warp before the atomic (the ids of real
audio cluster on a few hot cells) and read ids and vals with 16-byte
loads where the two share their alignment.  ``histogram(..., route=...)``
forces a route, for tests and timing only; the pipeline never passes it.
The thresholds are card timings (PERF.md §6).

Float atomics add a cell's deposits in an order that changes from run to
run, so two runs can differ in the last bit of a cell.  A caller that
needs the same sums on every run asks for the third route, ``"sorted"``
(``SORTED``): the wrapper sorts the deposits by (row, id), stably, and
the kernel sums each cell's run of deposits in deposit order on one
thread, with no atomics — deterministic, and bit-equal to the plain
version.  The single-bank raster takes it (``dsp.reassign``), so an
export and a render of the same file agree pixel for pixel.
"""

from __future__ import annotations

import math

import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)

# float32 cells one block's shared memory holds (227 KB on the H100):
# the bound of B2's row route and of B6's large route
SMEM_BINS = 232448 // 4
ROUTES = ("row", "global")    # the atomic routes, chosen by route_of
SORTED = "sorted"             # the deterministic route, on request
ROW_THREADS = 512         # histogram.cu kRowThreads
GLOBAL_THREADS = 256      # histogram.cu kGlobalThreads
SMS = 132                 # the H100's streaming multiprocessors
ROW_MIN_ROWS = 2 * SMS    # row: two blocks an SM from the rows alone
ROW_MAX_BINS = SMEM_BINS // 4     # row: four blocks of 512 an SM
GLOBAL_BLOCKS = 8 * SMS   # global: blocks at most (8 of 256 an SM)


def route_of(rows: int, m: int, num_bins: int) -> str:
    """B2's route for ``rows`` rows of ``m`` deposits into ``num_bins``
    cells: by shape only."""
    del m                     # the measured crossovers did not move with m
    if rows >= ROW_MIN_ROWS and num_bins <= ROW_MAX_BINS:
        return "row"
    return "global"


def global_blocks(rows: int, m: int) -> int:
    """The global route's grid: a 16-byte vector of deposits a thread,
    at most ``GLOBAL_BLOCKS`` blocks (a grid-stride loop beyond)."""
    vectors = -(-(rows * m) // 4)
    return max(1, min(-(-vectors // GLOBAL_THREADS), GLOBAL_BLOCKS))


def histogram_plain(ids: torch.Tensor, vals: torch.Tensor, num_bins: int,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """``histogram_reference``: per leading row, Σ vals into cells by id
    (into ``out`` in place where given), each cell adding in deposit
    order.  A dropped id adds value 0 to a spare cell, so a NaN/Inf behind
    it never lands."""
    lead = ids.shape[:-1]
    b = math.prod(lead)
    ok = (ids >= 0) & (ids < num_bins)
    v = torch.where(ok, vals, torch.zeros_like(vals)).reshape(-1)
    if out is not None:                  # the spare cell: 0 into cell 0
        safe = torch.where(ok, ids, 0).to(torch.int64).reshape(b, -1)
        safe = safe + (torch.arange(b, device=ids.device)
                       * num_bins)[:, None]
        out.view(-1).index_add_(0, safe.reshape(-1), v)
        return out
    safe = torch.where(ok, ids, num_bins).to(torch.int64).reshape(b, -1)
    safe = safe + (torch.arange(b, device=ids.device)
                   * (num_bins + 1))[:, None]
    hist = torch.zeros(b * (num_bins + 1), dtype=torch.float32,
                       device=ids.device)
    hist.index_add_(0, safe.reshape(-1), v)
    return hist.view(b, num_bins + 1)[:, :num_bins].reshape(
        lead + (num_bins,))


@counted
def histogram(ids: torch.Tensor, vals: torch.Tensor, num_bins: int,
              passes: int = 2, *, route: str | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """ids (..., M) int32, vals (..., M) float32 → (..., num_bins) float32.

    An id outside [0, num_bins) contributes nothing, even when its value
    is NaN or Inf.  ``passes`` is accepted for the JAX signature and is
    moot here: the kernel adds in float32, each add exact to one rounding
    (the TPU kernel split values into bf16 terms).  ``route`` ("row" or
    "global") overrides ``route_of``, for tests and timing; ``"sorted"``
    asks for the deterministic route.  ``out``, a
    contiguous float32 (..., num_bins) tensor, is added into in place and
    returned (the global route: its atomics add into whatever the output
    holds) — the live step's ring; the sorted route adds into it too."""
    del passes
    if ids.device.type == "cpu":
        return histogram_plain(ids, vals, num_bins, out)
    what = "histogram"
    require_cuda(ids, what)
    require(ids.dtype == torch.int32 and vals.dtype == torch.float32, what,
            "ids must be int32 and vals float32")
    require(ids.shape == vals.shape and vals.device == ids.device, what,
            "ids and vals must share shape and device")
    require(ids.is_contiguous() and vals.is_contiguous(), what,
            "ids and vals must be contiguous")
    require(0 < num_bins < 2**31, what,
            f"num_bins={num_bins} outside (0, 2**31)")
    require(route is None or route in ROUTES + (SORTED,), what,
            f"route {route!r} not in {ROUTES + (SORTED,)}")
    lead = ids.shape[:-1]
    rows = math.prod(lead)
    m = ids.shape[-1] if ids.dim() else 1
    if route == SORTED:
        return _sorted(ids, vals, num_bins, out, lead, rows)
    route = route or ("global" if out is not None
                      else route_of(rows, m, num_bins))
    require(route == "global" or num_bins <= SMEM_BINS, what,
            f"the row route holds at most {SMEM_BINS} cells in shared "
            f"memory, not {num_bins}")
    if out is None:
        alloc = torch.empty if route == "row" else torch.zeros
        out = alloc(lead + (num_bins,), dtype=torch.float32,
                    device=ids.device)
    else:
        require(route == "global" and out.dtype == torch.float32
                and out.shape == lead + (num_bins,) and out.is_contiguous()
                and out.device == ids.device, what,
                f"out must be a contiguous float32 {lead + (num_bins,)} "
                f"tensor on the ids' device, added into by the global route")
    a0 = ids.data_ptr() % 16
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, m,
            num_bins, ROUTES.index(route), global_blocks(rows, m), a0 // 4,
            int(vals.data_ptr() % 16 == a0), launch_stream(ids))
    kernels_build.check(rc, what)
    histogram.launches += 1
    histogram.route_launches[route] += 1
    return out


histogram.route_launches = dict.fromkeys(ROUTES + (SORTED,), 0)


def _sorted(ids, vals, num_bins: int, out, lead: tuple, rows: int):
    """B2's sorted route (see the module docstring): keys row·num_bins + id
    (−1 where dropped) sorted stably, the values gathered into that order,
    one launch that sums each cell's run."""
    what = "histogram"
    if out is None:
        out = torch.zeros(lead + (num_bins,), dtype=torch.float32,
                          device=ids.device)
    else:
        require(out.dtype == torch.float32 and out.is_contiguous()
                and out.shape == lead + (num_bins,)
                and out.device == ids.device, what,
                f"out must be a contiguous float32 {lead + (num_bins,)} "
                f"tensor on the ids' device")
    kt = torch.int32 if rows * num_bins < 2**31 else torch.int64
    base = (torch.arange(rows, dtype=kt, device=ids.device)
            * num_bins).reshape(lead + (1,))
    ok = (ids >= 0) & (ids < num_bins)
    keys, order = torch.sort(
        torch.where(ok, ids.to(kt) + base, -1).reshape(-1), stable=True)
    svals = vals.reshape(-1)[order]
    n = keys.numel()
    blocks = max(1, min(-(-n // GLOBAL_THREADS), GLOBAL_BLOCKS))
    with torch.cuda.device(ids.device):
        rc = kernels_build.library().emspec_histogram_sorted(
            keys.data_ptr(), keys.element_size(), svals.data_ptr(),
            out.data_ptr(), n, blocks, launch_stream(ids))
    kernels_build.check(rc, what)
    histogram.launches += 1
    histogram.route_launches[SORTED] += 1
    return out
