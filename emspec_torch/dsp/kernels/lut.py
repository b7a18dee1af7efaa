"""Kernel B3 wrappers — colormap lookup into a (256, 4) uint8 RGBA table
(counterpart of ``emspec/dsp/pallas/lut.py::lut_lookup``; source
``emspec_torch/csrc/lut.cu``), on one kernel body for two inputs:

* ``lut_lookup(idx, table)``: int32 indices, ``table[idx]`` — the TPU
  kernel's contract;
* ``lut_values(values, table)``: float32 display values, the whole of
  ``apply_lut`` (quantize, clamp, look up) in one launch — what the
  pipeline runs.

Both move 4 pixels a thread with 16-byte loads and stores; the output
takes the input's 4-byte alignment, so an offset view takes the vector
loop too.
"""

from __future__ import annotations

import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)
from emspec_torch.tables import LUT_SIZE

THREADS = 256             # lut.cu kThreads
BLOCKS_PER_SM = 4


def lut_lookup_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def lut_values_plain(values: torch.Tensor, table: torch.Tensor
                     ) -> torch.Tensor:
    """``table[clip(round(values·255), 0, 255)]`` (``round`` half to even,
    as ``jnp.round``), clipped in float so no value overflows the index;
    NaN maps to entry 0, as the kernel and the card's int cast do."""
    idx = torch.clamp(torch.round(values * (LUT_SIZE - 1)), 0, LUT_SIZE - 1)
    return table[torch.nan_to_num(idx, nan=0.0).long()]


def launch_shape(npix: int, a0: int, sms: int) -> tuple[int, int]:
    """(head, blocks) of a launch on ``npix`` pixels whose input and output
    start ``a0`` 4-byte words past a 16-byte boundary: ``head`` pixels
    one at a time, then 16-byte vectors (and a tail of up to 3 pixels)
    over at most ``BLOCKS_PER_SM`` blocks an SM."""
    head = min((4 - a0) % 4, npix)
    vectors = -(-(npix - head) // 4)
    return head, max(1, min(-(-vectors // THREADS), BLOCKS_PER_SM * sms))


def _launch(entry: str, what: str, x: torch.Tensor, table: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    require_cuda(x, what)
    require(x.dtype == dtype and x.is_contiguous(), what,
            f"input must be contiguous {dtype}")
    require(table.dtype == torch.uint8
            and tuple(table.shape) == (LUT_SIZE, 4)
            and table.is_contiguous() and table.device == x.device
            and table.data_ptr() % 4 == 0, what,
            "table must be a contiguous (256, 4) uint8 tensor on the "
            "input's device")
    npix = x.numel()
    # the output starts at the input's offset within 16 bytes, so both
    # reach a 16-byte boundary after the same head of pixels
    a0 = x.data_ptr() % 16 // 4
    buf = torch.empty((npix + 3, 4), dtype=torch.uint8, device=x.device)
    out = buf[a0:a0 + npix]
    head, blocks = launch_shape(npix, a0, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        rc = getattr(kernels_build.library(), entry)(
            x.data_ptr(), table.data_ptr(), out.data_ptr(), npix, head,
            blocks, launch_stream(x))
    kernels_build.check(rc, what)
    return out.view(x.shape + (4,))


@counted
def lut_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """idx (...,) int32 in [0, 256) + table (256, 4) uint8 → (..., 4)
    uint8, bit-equal to ``table[idx]``."""
    if idx.device.type == "cpu":
        return lut_lookup_plain(idx, table)
    out = _launch("emspec_lut", "lut_lookup", idx, table, torch.int32)
    lut_lookup.launches += 1
    return out


@counted
def lut_values(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """values (...,) float32 + table (256, 4) uint8 → (..., 4) uint8,
    bit-equal to :func:`lut_values_plain`."""
    if values.device.type == "cpu":
        return lut_values_plain(values, table)
    out = _launch("emspec_lut_values", "lut_values", values, table,
                  torch.float32)
    lut_values.launches += 1
    return out
