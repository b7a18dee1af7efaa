"""EMA scan kernel wrapper — the batch post chain's two recurrences
(counterpart of the sequential ``lax.scan`` in
``emspec/post/chain.py::_ema_scan``, which the JAX package leaves to XLA;
source ``emspec_torch/csrc/ema_scan.cu`` on the core
``csrc/ema_chunk.cuh``).

``ys[i] = α·ys[i−1] + b[i]`` over the leading axis, ``ys[−1] = y0``, one
IEEE multiply then one IEEE add a step: bit-equal to the column-by-column
evolution of ``post.chain.postprocess_column`` and to the plain loop
(``ema_scan_plain``) on the same device.  ``b = (1 − α)·xs`` is the
caller's (a torch op, written as the live step writes it).  α is either a
Python float (the AGC decay, passed by value) or a 0-d float32 tensor on
the input's device (the smoothing slider, read by the kernel from device
memory: no host read).

The kernel is chunk-parallel and exact by construction: chunks of
``chunk_len(t, C)`` steps speculate from a warm-up window set by α
(``window_len``), a second launch verifies every chunk boundary bit for
bit and repairs the chunks that failed (``csrc/ema_chunk.cuh``).  The
card counts the chunks it repaired (``repair_counter``);
``tests/test_torch_post_fused.py`` mirrors the schedule on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from emspec_torch import kernels_build
from emspec_torch.device import as_device
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)

MIN_CHUNK = 16            # the shortest chunk, in steps
TARGET_THREADS = 65536    # chunks × columns the chunk length aims at

_REPAIRED: dict = {}      # device → its uint64 count of repaired chunks


def chunk_len(t: int, c: int) -> int:
    """The chunk length L of a (t, C) scan, from the shape alone: about
    ``TARGET_THREADS`` (chunk, column) threads, a multiple of 8, at least
    ``MIN_CHUNK``."""
    chunks = -(-TARGET_THREADS // max(c, 1))
    per = -(-t // chunks)
    return max(MIN_CHUNK, -(-per // 8) * 8)


def window_len(alpha: float, s: int, forced: int | None = None) -> int:
    """The warm-up W of a chunk starting at step s ≥ 1 (ema_chunk.cuh
    ``window_len``: ⌈24 / −log2|α| + 4 / (1 − |α|)⌉, capped at s; here in
    numpy float32, whose log2 may round apart from the card's ``log2f``
    and move W by one step, which changes no result)."""
    if forced is not None:
        return min(forced, s)
    m = np.float32(abs(np.float32(alpha)))
    if m == 0:
        return 1
    if not m < 1:
        return s
    f32 = np.float32
    with np.errstate(over="ignore", divide="ignore"):
        w = np.ceil(f32(24) / -np.log2(m) + f32(4) / (f32(1) - m))
    return s if w >= s else int(w)


def repair_counter(device) -> torch.Tensor:
    """The device's count of repaired chunks, a one-element int64 tensor
    that both scans (``ema_scan``, ``post.post_tail``) add to: zero it
    before a run, read it after (a host read: measurement only)."""
    dev = as_device(device)
    if dev not in _REPAIRED:
        _REPAIRED[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _REPAIRED[dev]


def scan_scratch(t: int, c: int, like: torch.Tensor):
    """(L, the kernel's rec and fin scratch: 2·K·C float32)."""
    L = chunk_len(t, c)
    return L, torch.empty(2 * -(-t // L) * c, dtype=torch.float32,
                          device=like.device)


def ema_scan_plain(y0: torch.Tensor, alpha, b: torch.Tensor):
    """The loop: one column at a time, ``α·y`` then ``+ b[i]``, written
    straight into ``ys`` → (ys, y_final)."""
    ys = torch.empty_like(b)
    y = y0
    for i in range(b.shape[0]):
        torch.mul(y, alpha, out=ys[i])
        y = ys[i].add_(b[i])
    return ys, (y.clone() if b.shape[0] else y)


@counted
def ema_scan(y0: torch.Tensor, alpha, b: torch.Tensor, *,
             window: int | None = None):
    """y0 (...,) float32, α (a float or a 0-d float32 tensor), b (t, ...)
    float32 → (ys (t, ...), y_final (...)); with t = 0, ys is empty and
    y_final is ``y0`` itself, as a length-0 scan leaves its carry.
    ``window`` forces W for every chunk (a test hook: 0 makes every
    boundary fail and every chunk go to the repair)."""
    if b.device.type == "cpu":
        return ema_scan_plain(y0, alpha, b)
    what = "ema_scan"
    require_cuda(b, what)
    require(b.dtype == torch.float32 and y0.dtype == torch.float32
            and b.dim() >= 1 and tuple(y0.shape) == tuple(b.shape[1:])
            and y0.device == b.device, what,
            "b must be float32 (t, ...) and y0 float32 (...) on its device")
    tensor_alpha = isinstance(alpha, torch.Tensor)
    require(not tensor_alpha or (alpha.dtype == torch.float32
                                 and alpha.dim() == 0
                                 and alpha.device == b.device), what,
            "a tensor α must be a 0-d float32 tensor on b's device")
    require(window is None or window >= 0, what, "window must be ≥ 0")
    t = b.shape[0]
    if t == 0:
        return b, y0
    c = math.prod(b.shape[1:])
    b = b.contiguous()
    y0c = y0.contiguous()
    ys = torch.empty_like(b)
    y_final = torch.empty_like(y0c)
    L, scratch = scan_scratch(t, c, b)
    alpha_ptr = alpha.data_ptr() if tensor_alpha else None
    alpha_val = 0.0 if tensor_alpha else float(alpha)
    with torch.cuda.device(b.device):
        rc = kernels_build.library().emspec_ema_scan(
            b.data_ptr(), y0c.data_ptr(), alpha_ptr, alpha_val,
            ys.data_ptr(), y_final.data_ptr(), scratch.data_ptr(),
            repair_counter(b.device).data_ptr(),
            -1 if window is None else window, t, c, L, launch_stream(b))
    kernels_build.check(rc, what)
    ema_scan.launches += 1
    if c:
        ema_scan.pass_launches["speculate"] += 1
        ema_scan.pass_launches["repair"] += int(t > L)
    return ys, y_final


# the kernel launches behind ``launches`` (one a call): the speculate
# pass, and the verify-and-repair pass wherever there are two chunks
ema_scan.pass_launches = {"speculate": 0, "repair": 0}
