"""The batch post chain's fused kernels (source
``emspec_torch/csrc/post_chain.cu``, the scan core
``csrc/ema_chunk.cuh``), each beside its plain PyTorch version, and the
chain's elementwise stages those plain versions and
``post.chain`` share.

* ``post_head(power, ramp, gain, scale=None)``: stages 1–3 and the row
  peak of every column, (t, ..., rows) → (t, ...) — the peak, or
  ``scale``·peak (the AGC series' scan input ``(1 − 0.99)·peak`` where
  no global AGC couples the channels).  Counterpart of
  ``emspec/post/chain.py::_boost_db_peak`` without the coupling.
* ``post_tail(power, refs, y0, p)``: stages 1–3 again and 4–8 around the
  smoothing EMA, (t, ..., rows) power and the AGC series ``refs``
  (t, ...) → (vis, the smoothing state after the last column).
  Counterpart of ``_agc_gate_norm``, the smoothing ``_ema_scan`` and
  ``_brightness_clip`` (XLA in the JAX package).  Its kernel scans in one
  of two forms, chosen on the device from α (``pipelined`` mirrors the
  rule): chunk-parallel (``ema``'s speculate, verify and repair) where
  |α| ≤ 0.5, and above, where a silent stretch holds the state on a
  nonzero subnormal fixed point that no speculation from 0 meets, each
  column walked once from y0 by a block's chain warp while its other
  warps stage the inputs (``csrc/post_chain.cu``).

Both round as torch's eager ops do, so the card's batch chain equals the
live column-by-column chain bit for bit.  ``p`` is the chain's
``PostParams`` (0-d float32 tensors and the (rows,) ramp on power's
device); the smoothing α is read by the kernel, never on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)
from emspec_torch.dsp.kernels.ema import (
    ema_scan_plain, repair_counter, scan_scratch)

DB_EPS = 1e-12
DB_FLOOR = -200.0
AGC_TARGET_DB = 0.0
_SCALARS = ("gain", "db_range", "noise_gate_db", "agc_strength",
            "agc_enabled", "smoothing", "brightness")


def boost_db(power, ramp, gain):
    """Stages 1–3: ``10·log10(P·ramp·gain + 1e-12)``."""
    boosted = power * ramp * gain                                  # 1-2
    return 10.0 * torch.log10(boosted + DB_EPS)                    # 3


def agc_gate_norm(v_db, refs, p):
    """Stages 4-6 given the AGC reference."""
    offset = p.agc_enabled * p.agc_strength * (AGC_TARGET_DB - refs)
    v_db = v_db + offset[..., None]                                # 4
    v_db = torch.where(v_db < p.noise_gate_db,
                       torch.full_like(v_db, DB_FLOOR), v_db)      # 5
    return torch.clamp((v_db - (AGC_TARGET_DB - p.db_range)) / p.db_range,
                       0.0, 1.0)                                   # 6


def brightness_clip(smoothed, p):
    return torch.clamp(smoothed * (2.0 * p.brightness), 0.0, 1.0)  # 8


def pipelined(alpha, window: int | None = None) -> bool:
    """Whether ``post_tail``'s kernel takes its pipelined form: where
    zero inputs leave ``y ← RN(α·y)`` a nonzero fixed point (|α| > 0.5,
    or α NaN) and ``window`` is not forced.  The kernel decides from the
    α it reads on the device; this mirror of its rule takes the float, for
    tests and measurements (the chain never reads α on the host)."""
    return window is None and not abs(float(np.float32(alpha))) <= 0.5


def post_head_plain(power: torch.Tensor, ramp: torch.Tensor,
                    gain: torch.Tensor, scale: float | None = None):
    peak = torch.amax(boost_db(power, ramp, gain), dim=-1)
    return peak if scale is None else scale * peak


def post_tail_plain(power: torch.Tensor, refs: torch.Tensor,
                    y0: torch.Tensor, p):
    vis = agc_gate_norm(boost_db(power, p.low_end_ramp, p.gain), refs, p)
    ys, y_final = ema_scan_plain(y0, p.smoothing,
                                 (1.0 - p.smoothing) * vis)        # 7
    return brightness_clip(ys, p), y_final


def _require_scalars(tensors, dev, what: str) -> None:
    require(all(x.dtype == torch.float32 and x.dim() == 0
                and x.device == dev for x in tensors), what,
            "the gain and the other parameters must be 0-d float32 tensors "
            "on power's device")


def _require_power(power, ramp, what: str) -> None:
    require_cuda(power, what)
    require(power.dtype == torch.float32 and power.dim() >= 2
            and power.shape[-1] >= 1 and ramp.dtype == torch.float32
            and tuple(ramp.shape) == (power.shape[-1],)
            and ramp.device == power.device, what,
            "power must be float32 (t, ..., rows), rows ≥ 1, and the ramp "
            "float32 (rows,) on its device")


@counted
def post_head(power: torch.Tensor, ramp: torch.Tensor, gain: torch.Tensor,
              scale: float | None = None) -> torch.Tensor:
    """(t, ..., rows) float32 power → (t, ...) float32 peak dB, or
    ``scale``·peak (a Python float, rounded to float32 as torch rounds a
    scalar factor)."""
    if power.device.type == "cpu":
        return post_head_plain(power, ramp, gain, scale)
    what = "post_head"
    _require_power(power, ramp, what)
    _require_scalars((gain,), power.device, what)
    power = power.contiguous()
    ramp = ramp.contiguous()
    rows = power.shape[-1]
    out = torch.empty(power.shape[:-1], dtype=torch.float32,
                      device=power.device)
    vec = (rows % 4 == 0 and power.data_ptr() % 16 == 0
           and ramp.data_ptr() % 16 == 0)
    with torch.cuda.device(power.device):
        rc = kernels_build.library().emspec_post_head(
            power.data_ptr(), ramp.data_ptr(), gain.data_ptr(),
            out.data_ptr(), out.numel(), rows,
            0.0 if scale is None else float(scale), int(scale is not None),
            int(vec), launch_stream(power))
    kernels_build.check(rc, what)
    post_head.launches += 1
    return out


@counted
def post_tail(power: torch.Tensor, refs: torch.Tensor, y0: torch.Tensor, p,
              *, window: int | None = None):
    """(t, ..., rows) float32 power, the AGC series ``refs`` (t, ...), the
    smoothing state ``y0`` (..., rows) → (vis (t, ..., rows), the state
    after the last column); with t = 0 the state is ``y0`` itself.
    ``window``: as ``ema_scan``'s (a test hook; forced, it keeps the
    chunk-parallel form at every α, so 0 makes every chunk repair)."""
    if power.device.type == "cpu":
        return post_tail_plain(power, refs, y0, p)
    what = "post_tail"
    _require_power(power, p.low_end_ramp, what)
    dev = power.device
    _require_scalars([getattr(p, k) for k in _SCALARS], dev, what)
    require(refs.dtype == torch.float32 and refs.device == dev
            and tuple(refs.shape) == tuple(power.shape[:-1])
            and y0.dtype == torch.float32 and y0.device == dev
            and tuple(y0.shape) == tuple(power.shape[1:]), what,
            "refs must be float32 (t, ...) and y0 float32 (..., rows) on "
            "power's device")
    require(window is None or window >= 0, what, "window must be ≥ 0")
    t = power.shape[0]
    if t == 0:
        return torch.empty_like(power), y0
    c = math.prod(power.shape[1:])
    power = power.contiguous()
    refs = refs.contiguous()
    y0c = y0.contiguous()
    ramp = p.low_end_ramp.contiguous()
    out = torch.empty_like(power)
    y_final = torch.empty_like(y0c)
    L, scratch = scan_scratch(t, c, power)
    with torch.cuda.device(dev):
        rc = kernels_build.library().emspec_post_tail(
            power.data_ptr(), refs.data_ptr(), y0c.data_ptr(),
            ramp.data_ptr(), *(getattr(p, k).data_ptr() for k in _SCALARS),
            out.data_ptr(), y_final.data_ptr(), scratch.data_ptr(),
            repair_counter(dev).data_ptr(),
            -1 if window is None else window, t, c, power.shape[-1], L,
            launch_stream(power))
    kernels_build.check(rc, what)
    post_tail.launches += 1
    if c:
        post_tail.pass_launches["speculate"] += 1
        post_tail.pass_launches["repair"] += int(t > L)
    return out, y_final


# as ``ema_scan.pass_launches``: the speculate and the repair launches
# (in the pipelined form the first returns at once where there are two
# chunks and the second walks the columns)
post_tail.pass_launches = {"speculate": 0, "repair": 0}
