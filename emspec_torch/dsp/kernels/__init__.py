"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterparts of ``emspec/dsp/pallas``).

Every wrapper routes by the device of its input: a CPU tensor goes to the
plain version in the same module, a CUDA tensor to the kernel — or the
wrapper raises.  There is no fallback from a failed build or launch.
Each wrapper keeps a plain-int launch counter (``wrapper.launches``) that
rises only where it launches its kernel.
"""

from __future__ import annotations

import torch


def launch_stream(t: torch.Tensor):
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{t.device}")


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")
