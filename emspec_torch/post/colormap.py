"""Colormap LUT application (``emspec.post.colormap.apply_lut``).

The (256, 4) uint8 table is data (``emspec_torch.tables.lut``): swapping
colormaps swaps a tensor.  Every lookup goes through
``lut_lookup`` — kernel B3 for a CUDA tensor, the plain gather for a CPU
tensor; there is no size threshold (the JAX one was measured on a TPU).
"""

from __future__ import annotations

import torch

from emspec_torch.dsp.kernels.lut import lut_lookup
from emspec_torch.tables import LUT_SIZE


def apply_lut(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """values in [0,1] (...,) + (256,4) uint8 table → (..., 4) uint8 RGBA."""
    idx = torch.clamp(torch.round(values * (LUT_SIZE - 1)).to(torch.int32),
                      0, LUT_SIZE - 1)
    return lut_lookup(idx.contiguous(), table)
