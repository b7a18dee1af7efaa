"""EMA scan kernel wrapper — the batch post chain's two recurrences
(counterpart of the sequential ``lax.scan`` in
``emspec/post/chain.py::_ema_scan``, which the JAX package leaves to XLA;
source ``emspec_torch/csrc/ema_scan.cu``).

``ys[i] = α·ys[i−1] + b[i]`` over the leading axis, ``ys[−1] = y0``, one
IEEE multiply then one IEEE add a step: bit-equal to the column-by-column
evolution of ``post.chain.postprocess_column`` and to the plain loop
(``ema_scan_plain``) on the same device.  ``b = (1 − α)·xs`` is the
caller's (a torch op, written as the live step writes it).  α is either a
Python float (the AGC decay, passed by value) or a 0-d float32 tensor on
the input's device (the smoothing slider, read by the kernel from device
memory: no host read).
"""

from __future__ import annotations

import math

import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)

THREADS = 64              # ema_scan.cu kThreads: one thread a column
UNROLL = 16               # ema_scan.cu kUnroll: steps a stage
STAGES = 8                # ema_scan.cu kStages: stages in the load ring


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
def ema_scan(y0: torch.Tensor, alpha, b: torch.Tensor):
    """y0 (...,) float32, α (a float or a 0-d float32 tensor), b (t, ...)
    float32 → (ys (t, ...), y_final (...)); with t = 0, ys is empty and
    y_final is ``y0`` itself, as a length-0 scan leaves its carry."""
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
    t = b.shape[0]
    if t == 0:
        return b, y0
    b = b.contiguous()
    y0c = y0.contiguous()
    ys = torch.empty_like(b)
    y_final = torch.empty_like(y0c)
    alpha_ptr = alpha.data_ptr() if tensor_alpha else None
    alpha_val = 0.0 if tensor_alpha else float(alpha)
    with torch.cuda.device(b.device):
        rc = kernels_build.library().emspec_ema_scan(
            b.data_ptr(), y0c.data_ptr(), alpha_ptr, alpha_val,
            ys.data_ptr(), y_final.data_ptr(), t, math.prod(b.shape[1:]),
            launch_stream(b))
    kernels_build.check(rc, what)
    ema_scan.launches += 1
    return ys, y_final
