"""Post-processing chain: linear power → display value in [0, 1]
(``emspec.post.chain``; the canonical stage order is its docstring's).

1. ``P *= low_end_ramp(f)``   2. ``P *= gain``   3. ``v = 10·log10(P + 1e-12)``
4. AGC ``v += strength·(0 − ref)``, ``ref`` an EMA of the per-column peak
5. gate ``v → −200`` below ``gate_db``   6. ``vis = clip((v + range)/range, 0, 1)``
7. smoothing ``y = α·y + (1−α)·vis``   8. ``vis = clip(y·2·brightness, 0, 1)``

The batch chain runs the two EMAs as a sequential loop over columns, the
same per-element operations in the same order as ``postprocess_column``;
the associative scan and the time-sharded chain are later work
(ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emspec.config import Settings
from emspec_torch.tables import low_end_ramp

DB_EPS = 1e-12
DB_FLOOR = -200.0
AGC_TARGET_DB = 0.0
# stays a PYTHON float: ``1.0 - AGC_DECAY`` folds in float64 exactly as the
# JAX chain writes it (chain.py:202-204)
AGC_DECAY = 0.99


class PostParams(NamedTuple):
    """Continuous post-chain parameters as 0-d / (rows,) float32 tensors
    on the pipeline's device — moving a slider swaps tensors, nothing else."""
    gain: torch.Tensor
    db_range: torch.Tensor
    noise_gate_db: torch.Tensor
    agc_strength: torch.Tensor
    agc_enabled: torch.Tensor
    smoothing: torch.Tensor
    brightness: torch.Tensor
    low_end_ramp: torch.Tensor      # (rows,)

    @staticmethod
    def from_settings(s: Settings, freqs_hz: np.ndarray,
                      device) -> "PostParams":
        f32 = lambda v: torch.tensor(np.float32(v), device=device)
        return PostParams(
            gain=f32(s.gain),
            db_range=f32(s.db_range),
            noise_gate_db=f32(s.noise_gate_db),
            agc_strength=f32(s.agc_strength),
            agc_enabled=f32(1.0 if s.auto_gain else 0.0),
            smoothing=f32(s.smoothing),
            brightness=f32(s.brightness),
            low_end_ramp=torch.from_numpy(low_end_ramp(
                freqs_hz, s.low_end_boost, s.low_end_cutoff)).to(device),
        )


class PostState(NamedTuple):
    """Streaming state carried hop→hop."""
    smooth: torch.Tensor    # (..., rows)
    agc_ref: torch.Tensor   # (...,)

    @staticmethod
    def init(shape_rows: tuple, device) -> "PostState":
        *lead, _rows = shape_rows
        return PostState(
            smooth=torch.zeros(shape_rows, dtype=torch.float32, device=device),
            agc_ref=torch.full(tuple(lead), AGC_TARGET_DB,
                               dtype=torch.float32, device=device),
        )


def _ema_seq(y0: torch.Tensor, alpha, xs: torch.Tensor):
    """Leading-axis EMA ``y_t = α·y_{t-1} + (1−α)·x_t`` → (ys, y_final),
    one column at a time (bit-identical to the per-column step: the same
    multiply, then the same add, written straight into ``ys``)."""
    b = (1.0 - alpha) * xs
    ys = torch.empty_like(b)
    y = y0
    for i in range(xs.shape[0]):
        torch.mul(y, alpha, out=ys[i])
        y = ys[i].add_(b[i])
    return ys, (y.clone() if xs.shape[0] else y)


def _boost_db_peak(power, p: PostParams, global_agc: bool, lead_axes: tuple):
    """Stages 1-3 + the pre-AGC per-column peak (``lead_axes``: the axes of
    ``peak_db`` that the global-AGC option couples)."""
    boosted = power * p.low_end_ramp * p.gain                      # 1-2
    v_db = 10.0 * torch.log10(boosted + DB_EPS)                    # 3
    peak_db = torch.amax(v_db, dim=-1)
    if global_agc and lead_axes:
        peak_db = torch.amax(peak_db, dim=lead_axes,
                             keepdim=True).expand(peak_db.shape)
    return v_db, peak_db


def _agc_gate_norm(v_db, refs, p: PostParams):
    """Stages 4-6 given the AGC reference."""
    offset = p.agc_enabled * p.agc_strength * (AGC_TARGET_DB - refs)
    v_db = v_db + offset[..., None]                                # 4
    v_db = torch.where(v_db < p.noise_gate_db,
                       torch.full_like(v_db, DB_FLOOR), v_db)      # 5
    return torch.clamp((v_db - (AGC_TARGET_DB - p.db_range)) / p.db_range,
                       0.0, 1.0)                                   # 6


def _brightness_clip(smoothed, p: PostParams):
    return torch.clamp(smoothed * (2.0 * p.brightness), 0.0, 1.0)  # 8


def postprocess_batch(power_ts: torch.Tensor, state: PostState, p: PostParams,
                      global_agc: bool = False):
    """Whole-signal chain: (t, ..., rows) power → (t, ..., rows) vis."""
    v_db, peak_db = _boost_db_peak(
        power_ts, p, global_agc, tuple(range(1, power_ts.ndim - 1)))
    refs, ref_final = _ema_seq(state.agc_ref, AGC_DECAY, peak_db)
    vis = _agc_gate_norm(v_db, refs, p)                            # 4-6
    smoothed, smooth_final = _ema_seq(state.smooth, p.smoothing, vis)  # 7
    out = _brightness_clip(smoothed, p)                            # 8
    return out, PostState(smooth=smooth_final, agc_ref=ref_final)


def postprocess_column(power: torch.Tensor, state: PostState, p: PostParams,
                       global_agc: bool = False):
    """One hop: power column (..., rows) → display values + new state."""
    v_db, peak_db = _boost_db_peak(
        power, p, global_agc, tuple(range(power.ndim - 1)))        # 1-3
    new_ref = AGC_DECAY * state.agc_ref + (1.0 - AGC_DECAY) * peak_db
    vis = _agc_gate_norm(v_db, new_ref, p)                         # 4-6
    smoothed = p.smoothing * state.smooth + (1.0 - p.smoothing) * vis  # 7
    out = _brightness_clip(smoothed, p)                            # 8
    return out, PostState(smooth=smoothed, agc_ref=new_ref)
