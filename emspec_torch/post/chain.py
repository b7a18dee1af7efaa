"""Post-processing chain: linear power → display value in [0, 1]
(``emspec.post.chain``; the canonical stage order is its docstring's).

1. ``P *= low_end_ramp(f)``   2. ``P *= gain``   3. ``v = 10·log10(P + 1e-12)``
4. AGC ``v += strength·(0 − ref)``, ``ref`` an EMA of the per-column peak
5. gate ``v → −200`` below ``gate_db``   6. ``vis = clip((v + range)/range, 0, 1)``
7. smoothing ``y = α·y + (1−α)·vis``   8. ``vis = clip(y·2·brightness, 0, 1)``

The batch chain is sequential by default, bit-equal to scanning
``postprocess_column`` over the columns.  On the card it is the fused
kernels of ``dsp.kernels.post`` around the chunk-parallel scan of
``dsp.kernels.ema``: ``post_head`` (stages 1–3 and the row peak), the
global AGC's coupling in torch where it is on, ``ema_scan`` over the AGC
series, ``post_tail`` (stages 4–8 around the smoothing scan).  On the CPU
it is the torch stages with each EMA one scan (``_ema_scan``, the plain
loop).  ``associative=True`` composes the affine recurrences in ⌈log2 t⌉
doubling passes of plain torch on any device (on no path).
``postprocess_batch_timeshard`` is the chain of one time chunk
of a sharded render (``emspec_torch.parallel.TimeParallelRenderer``):
each EMA scans its chunk from zero, one gather of the chunk finals over
the time axis gives the chunk's incoming state, and the affine
correction re-bases the series.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emspec_torch.config import Settings
from emspec_torch.dsp.kernels.ema import ema_scan
from emspec_torch.dsp.kernels.post import (
    AGC_TARGET_DB, agc_gate_norm, boost_db, brightness_clip, post_head,
    post_tail)
from emspec_torch.tables import low_end_ramp

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


def _ema_scan(y0: torch.Tensor, alpha, xs: torch.Tensor,
              associative: bool):
    """Leading-axis EMA ``y_t = α·y_{t-1} + (1−α)·x_t`` → (ys, y_final)
    (``emspec.post.chain._ema_scan``).

    associative=False: the sequential scan, ``α·y`` then ``+ b`` a step —
    kernel ``ema_scan`` on the card, its plain loop on the CPU — bit-equal
    to the column-by-column evolution of :func:`postprocess_column`.

    associative=True: the affine maps ``y ↦ a·y + b`` composed as
    ``(a2·a1, a2·b1 + b2)`` in ⌈log2 t⌉ doubling passes of plain torch
    (each pass composes every column with the one ``d`` before it), then
    ``ys = A·y0 + B``.  Reassociation changes float32 rounding by
    ~log2(t)·ε relative, the JAX docstring's bound for its own
    associative scan (which composes in another order)."""
    b = (1.0 - alpha) * xs
    t = xs.shape[0]
    if t == 0:
        return b, y0                  # a length-0 scan: carry unchanged
    if not associative:
        return ema_scan(y0, alpha, b)
    A = torch.empty_like(b)
    if isinstance(alpha, torch.Tensor):
        A.copy_(alpha)                # the slider's device value, no host read
    else:
        A.fill_(alpha)                # a float: no host-to-device copy
    B = b
    d = 1
    while d < t:
        B = torch.cat([B[:d], A[d:] * B[:-d] + B[d:]])
        A = torch.cat([A[:d], A[d:] * A[:-d]])
        d *= 2
    ys = A * y0 + B
    return ys, ys[-1]


def _couple(peak_db, global_agc: bool, lead_axes: tuple, peak_reduce):
    """The global AGC: every column's peak over the ``lead_axes`` (the
    channels), completed across the other channel shards of a sharded run
    by ``peak_reduce`` (an in-place max over their group)."""
    if not (global_agc and lead_axes):
        return peak_db
    peak = torch.amax(peak_db, dim=lead_axes, keepdim=True)
    if peak_reduce is not None:
        peak = peak_reduce(peak)
    return peak.expand(peak_db.shape)


def _boost_db_peak(power, p: PostParams, global_agc: bool, lead_axes: tuple,
                   peak_reduce=None):
    """Stages 1-3 + the pre-AGC per-column peak (``lead_axes``: the axes of
    ``peak_db`` that the global-AGC option couples; ``peak_reduce``: see
    :func:`_couple`)."""
    v_db = boost_db(power, p.low_end_ramp, p.gain)                 # 1-3
    return v_db, _couple(torch.amax(v_db, dim=-1), global_agc, lead_axes,
                         peak_reduce)


def postprocess_batch(power_ts: torch.Tensor, state: PostState, p: PostParams,
                      global_agc: bool = False,
                      associative: bool | None = None, peak_reduce=None):
    """Whole-signal chain: (t, ..., rows) power → (t, ..., rows) vis.

    ``associative`` picks the form of both EMAs (:func:`_ema_scan`);
    ``None`` (or False) means sequential on every device — bit-identical
    to scanning :func:`postprocess_column` over t: the fused kernels on
    the card (:func:`_fused_batch`), the torch stages on the CPU.  The
    JAX package's default (the associative form on its TPU, at t ≥ 1024
    for the smoothing) is a TPU measurement and is not carried over.
    ``peak_reduce``: see :func:`_couple`."""
    assoc = bool(associative)
    lead_axes = tuple(range(1, power_ts.ndim - 1))
    if not assoc and power_ts.device.type != "cpu":
        return _fused_batch(power_ts, state, p, global_agc, lead_axes,
                            peak_reduce)
    v_db, peak_db = _boost_db_peak(power_ts, p, global_agc, lead_axes,
                                   peak_reduce)
    refs, ref_final = _ema_scan(state.agc_ref, AGC_DECAY, peak_db, assoc)
    vis = agc_gate_norm(v_db, refs, p)                             # 4-6
    smoothed, smooth_final = _ema_scan(state.smooth, p.smoothing, vis,
                                       assoc)                      # 7
    out = brightness_clip(smoothed, p)                             # 8
    return out, PostState(smooth=smooth_final, agc_ref=ref_final)


def _fused_batch(power_ts, state: PostState, p: PostParams,
                 global_agc: bool, lead_axes: tuple, peak_reduce):
    """The sequential batch chain on the card: ``post_head``, the global
    AGC's coupling (torch, only where it is on), ``ema_scan`` over the AGC
    series, ``post_tail``: five kernel launches (``post_head`` and each
    scan's two passes), two more of torch's (``amax``, the product)
    where the global AGC couples the channels.  ``b = (1 − 0.99)·peak`` is
    rounded as :func:`_ema_scan` rounds it: by ``post_head`` itself, or
    by torch after the coupling."""
    if global_agc and lead_axes:
        peak = _couple(post_head(power_ts, p.low_end_ramp, p.gain),
                       global_agc, lead_axes, peak_reduce)
        b_ref = (1.0 - AGC_DECAY) * peak
    else:
        b_ref = post_head(power_ts, p.low_end_ramp, p.gain,
                          scale=1.0 - AGC_DECAY)
    refs, ref_final = ema_scan(state.agc_ref, AGC_DECAY, b_ref)
    out, smooth_final = post_tail(power_ts, refs, state.smooth, p)
    return out, PostState(smooth=smooth_final, agc_ref=ref_final)


def postprocess_column(power: torch.Tensor, state: PostState, p: PostParams,
                       global_agc: bool = False, peak_reduce=None):
    """One hop: power column (..., rows) → display values + new state."""
    v_db, peak_db = _boost_db_peak(
        power, p, global_agc, tuple(range(power.ndim - 1)),
        peak_reduce)                                               # 1-3
    new_ref = AGC_DECAY * state.agc_ref + (1.0 - AGC_DECAY) * peak_db
    vis = agc_gate_norm(v_db, new_ref, p)                          # 4-6
    smoothed = p.smoothing * state.smooth + (1.0 - p.smoothing) * vis  # 7
    out = brightness_clip(smoothed, p)                             # 8
    return out, PostState(smooth=smoothed, agc_ref=new_ref)


def _affine_chunk_in(y0, fin_all, alpha_L, d: int):
    """Incoming EMA state of time chunk ``d`` (``emspec.post.chain.
    _affine_chunk_in``).  With a constant α a chunk of L steps is the
    affine map ``y_out = α^L·y_in + B``, ``B`` its zero-initialised final
    (``fin_all[k]`` for chunk k, gathered over the time axis), so

        y_in(d) = α^(L·d)·y0 + Σ_{k<d} α^(L·(d−1−k))·B_k

    computed on every rank from the same gathered finals.  ``alpha_L`` is
    α^L as a 0-d float32 tensor."""
    n = fin_all.shape[0]
    k = torch.arange(n, device=fin_all.device)
    expo = torch.clamp(d - 1 - k, min=0).to(torch.float32)
    w = torch.where(k < d, torch.pow(alpha_L, expo), 0.0)
    w = w.reshape((n,) + (1,) * (fin_all.ndim - 1))
    return torch.pow(alpha_L, float(d)) * y0 + torch.sum(w * fin_all, dim=0)


def postprocess_batch_timeshard(power_local: torch.Tensor, state0: PostState,
                                p: PostParams, axis, global_agc: bool = False,
                                valid_count: int | None = None, ch_axis=None):
    """Post chain of one contiguous (L, ..., rows) time chunk of a sharded
    render (``emspec.post.chain.postprocess_batch_timeshard``).

    ``axis`` is the time axis as this rank sees it (``parallel.MeshAxis``:
    ``index``, the chunk's place, and ``all_gather``); ``ch_axis``, on a
    (ch × t) mesh, the channel axis, over which the global AGC's peak
    takes one ``all_reduce_max``.  ``state0`` is the global initial state
    of this rank's channels.  Each EMA scans the chunk from zero — the
    sequential scan, kernel ``ema_scan`` on the card — one gather ships
    the chunk finals, and ``y_t = α^(t+1)·y_in + y_t(0)`` re-bases the
    series: two gathers in all.  The re-base reassociates the float32
    recurrence (~1e-6, as the associative scan).

    Returns (vis (L, ..., rows), the state after the chunk's last valid
    column: ``valid_count`` columns of a chunk past the signal's end are
    real, the rest padding whose evolution must not reach the final
    state)."""
    L = power_local.shape[0]
    dev = power_local.device
    reduce = (ch_axis.all_reduce_max if global_agc and ch_axis is not None
              else None)
    v_db, peak_db = _boost_db_peak(
        power_local, p, global_agc, tuple(range(1, power_local.ndim - 1)),
        reduce)
    steps = torch.arange(1, L + 1, dtype=torch.float32, device=dev)
    lead1 = (L,) + (1,) * (peak_db.ndim - 1)

    refs0, ref_fin0 = _ema_scan(torch.zeros_like(state0.agc_ref), AGC_DECAY,
                                peak_db, False)
    # 0-d constants filled on the device: a host tensor's copy would wait
    # for the queue
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    ref_in = _affine_chunk_in(
        state0.agc_ref, axis.all_gather(ref_fin0),
        f32(np.float32(AGC_DECAY ** L)), axis.index)
    refs = (torch.pow(f32(np.float32(AGC_DECAY)), steps).reshape(lead1)
            * ref_in + refs0)
    vis = agc_gate_norm(v_db, refs, p)                             # 4-6

    smooth0, smooth_fin0 = _ema_scan(torch.zeros_like(state0.smooth),
                                     p.smoothing, vis, False)
    s_in = _affine_chunk_in(
        state0.smooth, axis.all_gather(smooth_fin0),
        torch.pow(p.smoothing, float(L)), axis.index)
    spow = torch.pow(p.smoothing, steps).reshape(
        (L,) + (1,) * (smooth0.ndim - 1))
    smoothed = spow * s_in + smooth0                               # 7
    out = brightness_clip(smoothed, p)                             # 8
    idx = L - 1 if valid_count is None else min(max(valid_count - 1, 0),
                                                L - 1)
    return out, PostState(smooth=smoothed[idx], agc_ref=refs[idx])
