"""Kernel B5 wrapper — fused triple windowing
(counterpart of ``emspec/dsp/pallas/window.py::windowed_frames``; source
``emspec_torch/csrc/window.cu``)."""

from __future__ import annotations

import functools

import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)
from emspec_torch.dsp.windows import window_triple


@functools.lru_cache(maxsize=None)
def _w3(n: int, device: str) -> torch.Tensor:
    """(3, n) float32 [h, t·h, dh/dn] (``emspec.dsp.windows.window_triple``)."""
    return torch.from_numpy(window_triple(n)).to(device)


def w3_table(n: int, device) -> torch.Tensor:
    return _w3(n, str(torch.device(device)))


def windowed_frames_plain(frames: torch.Tensor) -> torch.Tensor:
    """frames (..., T, N) or (N,) → (3, ..., T, N) or (3, N):
    ``frames[None] * w3`` broadcast over the frame axes."""
    n = frames.shape[-1]
    w3 = w3_table(n, frames.device)
    return frames[None] * w3.reshape((3,) + (1,) * (frames.dim() - 1) + (n,))


@counted
def windowed_frames(frames: torch.Tensor) -> torch.Tensor:
    """frames (..., T, N) or (N,) float32 → (3, ...) float32, bit-equal to
    :func:`windowed_frames_plain`.  The frames may be a strided view (the
    framing ``unfold``) as long as each frame is contiguous."""
    if frames.device.type == "cpu":
        return windowed_frames_plain(frames)
    what = "windowed_frames"
    require_cuda(frames, what)
    require(frames.dim() >= 1 and frames.dtype == torch.float32
            and frames.stride(-1) == 1, what,
            "frames must be float32 (..., N) with unit last stride")
    n = frames.shape[-1]
    f3 = (frames.reshape(1, 1, n) if frames.dim() == 1
          else frames[None] if frames.dim() == 2
          else frames.reshape((-1,) + frames.shape[-2:]))
    out = torch.empty((3,) + frames.shape, dtype=torch.float32,
                      device=frames.device)
    w3 = w3_table(n, frames.device)
    with torch.cuda.device(frames.device):
        rc = kernels_build.library().emspec_window(
            f3.data_ptr(), f3.shape[0], f3.shape[1], f3.stride(0),
            f3.stride(1), w3.data_ptr(), out.data_ptr(), n,
            launch_stream(frames))
    kernels_build.check(rc, what)
    windowed_frames.launches += 1
    return out
