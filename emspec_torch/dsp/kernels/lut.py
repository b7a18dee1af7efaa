"""Kernel B3 wrapper — colormap lookup ``table[idx]``
(counterpart of ``emspec/dsp/pallas/lut.py::lut_lookup``;
source ``emspec_torch/csrc/lut.cu``)."""

from __future__ import annotations

import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import launch_stream, require, require_cuda


def lut_lookup_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def lut_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """idx (...,) int32 in [0, 256) + table (256, 4) uint8 → (..., 4)
    uint8, bit-equal to ``table[idx]``."""
    if idx.device.type == "cpu":
        return lut_lookup_plain(idx, table)
    what = "lut_lookup"
    require_cuda(idx, what)
    require(idx.dtype == torch.int32 and idx.is_contiguous(), what,
            "idx must be contiguous int32")
    require(table.dtype == torch.uint8 and tuple(table.shape) == (256, 4)
            and table.is_contiguous() and table.device == idx.device
            and table.data_ptr() % 4 == 0, what,
            "table must be a contiguous (256, 4) uint8 tensor on idx's device")
    out = torch.empty(idx.shape + (4,), dtype=torch.uint8, device=idx.device)
    with torch.cuda.device(idx.device):
        rc = kernels_build.library().emspec_lut(
            idx.data_ptr(), table.data_ptr(), out.data_ptr(), idx.numel(),
            launch_stream(idx))
    kernels_build.check(rc, what)
    lut_lookup.launches += 1
    return out


lut_lookup.launches = 0
