"""Comparison of quantized scatters (DESIGN.md §9 methodology).

A reassigned power grid is a histogram of quantized deposits: a half-ulp
difference in Δt/hop or in log2 f̂ legitimately moves a whole deposit one
cell.  Grids are therefore held to total-energy equality plus agreement
of their 3×3 max-filters, cell by cell — except for the few cells a moved
deposit disturbs, whose number is bounded instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class GridCompare(NamedTuple):
    energy_rel: float      # |Σwant − Σgot| / Σwant
    maxf_rel: float        # max |maxf(want) − maxf(got)| / peak
    maxf_frac: float       # share of cells whose max-filters differ > atol
    ok: bool


def max_filter3(grid: torch.Tensor) -> torch.Tensor:
    """3×3 max-filter over the last two axes (edges see only the grid)."""
    g = grid.reshape((-1, 1) + tuple(grid.shape[-2:]))
    return F.max_pool2d(g, 3, stride=1, padding=1).reshape(grid.shape)


def compare_grids(want: torch.Tensor, got: torch.Tensor, *,
                  energy_rtol: float = 1e-4, maxf_atol: float = 1e-3,
                  maxf_frac: float = 1e-4) -> GridCompare:
    """``want``/``got``: (..., A, B) non-negative grids.  Passes when the
    total energies agree to ``energy_rtol`` and the 3×3 max-filters agree
    to ``maxf_atol``·peak on all but a ``maxf_frac`` share of the cells."""
    want = want.double()
    got = got.double()
    peak = float(want.max())
    e_w, e_g = float(want.sum()), float(got.sum())
    energy_rel = abs(e_w - e_g) / max(e_w, 1e-300)
    d = (max_filter3(want) - max_filter3(got)).abs()
    maxf_rel = float(d.max()) / max(peak, 1e-300)
    frac = float((d > maxf_atol * peak).double().mean())
    ok = energy_rel <= energy_rtol and frac <= maxf_frac
    return GridCompare(energy_rel, maxf_rel, frac, ok)


def compare_vis(want: torch.Tensor, got: torch.Tensor, *,
                atol: float = 2.0 / 255.0, frac: float = 1e-4):
    """Display values (t, ..., rows): 3×3 (time × row) max-filters within
    ``atol`` (two display quanta) on all but a ``frac`` share of cells —
    a moved deposit changes the dB value of a faint cell by far more, so
    the cells it touches are counted, not bounded.  → (ok, max, share)."""
    w = max_filter3(want.double().movedim(0, -2))
    g = max_filter3(got.double().movedim(0, -2))
    d = (w - g).abs()
    share = float((d > atol).double().mean())
    return share <= frac, float(d.max()), share
