"""Frame extraction (``emspec.dsp.frame``).

Frame ``t`` covers samples ``[t*hop, t*hop + n)``; its center
``t*hop + n/2`` is the time its column represents.  ``frame_signal``
returns a strided ``unfold`` view — no copy; the deposits kernel reads
frames straight from the signal, and only a consumer that needs
contiguous rows copies.
"""

from __future__ import annotations

import torch


def num_frames(num_samples: int, n: int, hop: int) -> int:
    """Frames that fit fully inside ``num_samples`` (no padding)."""
    if num_samples < n:
        return 0
    return (num_samples - n) // hop + 1


def signal_blocks(x: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """(..., samples) → (..., rows, hop) hop-aligned blocks, frame ``t``
    being rows ``t..t+m-1`` concatenated (m = ⌈n/hop⌉), zero-padded at
    the end where ``hop`` does not divide ``n``.  The pruned-DFT block
    product (``dsp.stft.stft_triple_stencil_blocks``) folds the framing
    into its sum over these rows."""
    t = num_frames(x.shape[-1], n, hop)
    m = -(-n // hop)
    rows = max(t + m - 1, 0)
    need = rows * hop
    pad = need - x.shape[-1]
    if pad > 0:
        x = torch.nn.functional.pad(x, (0, pad))
    elif pad < 0:
        x = x[..., :need]
    return x.reshape(x.shape[:-1] + (rows, hop))


def frame_signal(x: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """(..., samples) → (..., frames, n) overlapping frames (a view)."""
    t = num_frames(x.shape[-1], n, hop)
    if t <= 0:
        return x.new_zeros(x.shape[:-1] + (0, n))
    return x[..., :(t - 1) * hop + n].unfold(-1, n, hop)
