"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterparts of ``emspec/dsp/pallas``).

Every wrapper routes by the device of its input: a CPU tensor goes to the
plain version in the same module, a CUDA tensor to the kernel — or the
wrapper raises.  There is no fallback from a failed build or launch.
Each wrapper keeps a plain-int launch counter (``wrapper.launches``) that
rises only where it launches its kernel (``counted`` sets it up).  The
counters rise at Python call time, so a CUDA graph's replays launch
kernels that no wrapper sees: its owner reads ``launch_counts`` around
the capture and adds the rise on each replay (``add_launch_counts``).
"""

from __future__ import annotations

import torch

_COUNTED: list = []


def counted(fn):
    """Give a kernel wrapper its launch counter ``fn.launches`` (0)."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """Every counted wrapper's launches, and each entry of the counter
    dicts a wrapper keeps beside them (``histogram.route_launches`` by
    route, ``deposits_ids.form_launches`` by form), keyed (wrapper, dict
    name or None, key or None)."""
    out = {}
    for fn in _COUNTED:
        out[fn, None, None] = fn.launches
        for name, counts in vars(fn).items():
            if name.endswith("_launches") and isinstance(counts, dict):
                for key, n in counts.items():
                    out[fn, name, key] = n
    return out


def add_launch_counts(delta: dict, times: int = 1) -> None:
    """Add ``times``·``delta`` (a difference of two ``launch_counts``)."""
    for (fn, name, key), n in delta.items():
        if name is None:
            fn.launches += times * n
        else:
            getattr(fn, name)[key] += times * n


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
