"""Colormap LUT application (``emspec.post.colormap.apply_lut``).

The (256, 4) uint8 table is data (``emspec_torch.tables.lut``): swapping
colormaps swaps a tensor.  The whole lookup — quantize to an index,
clamp, gather — is kernel B3's float32 form (``lut_values``) for a CUDA
tensor, one launch that reads 4 bytes and writes 4 bytes a pixel, and its
plain version for a CPU tensor; there is no size threshold (the JAX one
was measured on a TPU).
"""

from __future__ import annotations

import torch

from emspec_torch.dsp.kernels.lut import lut_values


def apply_lut(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """values in [0,1] (...,) + (256,4) uint8 table → (..., 4) uint8 RGBA."""
    return lut_values(values.contiguous(), table)
