"""Scrolling waterfall: a device-resident image ring
(``emspec.render.waterfall``).

The analysis hop is fixed; Scroll Speed is a display rate in pixel
columns per hop.  Speed 1 paints each emitted column once (bit-identical
to it), speed k > 1 paints it k times, and a speed below 1 paints every
⌈1/speed⌉-th hop the mean of the columns analyzed since the last paint —
taken before the colormap, on the ``vis`` values the stream emits beside
each RGBA column, so the painted pixel is ``LUT(mean(vis))`` (kernel B3's
``lut_values`` on the card) and stays on the palette.  Averaging RGBA is
the fallback where no vis or table is given (pre-rendered rasters).

The ring is a (width, rows, 4) uint8 tensor on ``device``; the write
head and the fractional phase are host scalars (the waterfall is driven
from the host, never from a graph).  A hop's ``steps`` slots are written
by one ``index_copy_``.
"""

from __future__ import annotations

import numpy as np
import torch

from emspec_torch.device import as_device
from emspec_torch.post.colormap import apply_lut

_MIXED = ("mixed vis/RGBA columns within one fractional-speed "
          "accumulation — pass vis_column (and set lut_table) "
          "consistently for every column")


class Waterfall:
    """Fixed-width scrolling raster of RGBA columns on ``device``.

    ``lut_table``: optional (256, 4) uint8 colormap table.  With it set,
    fractional-speed averaging runs on the vis values whenever the caller
    also passes ``vis_column``; assign a new table on a colormap change."""

    def __init__(self, width: int, rows: int, scroll_speed: float = 1.0,
                 lut_table=None, device="cuda"):
        self.width = int(width)
        self.rows = int(rows)
        self.scroll_speed = float(scroll_speed)
        self.device = as_device(device)
        self.lut_table = lut_table
        # unwritten slots are OPAQUE black: a part-filled waterfall reads
        # as "no signal yet", not as the viewer's background
        self._buf = torch.zeros((self.width, self.rows, 4), dtype=torch.uint8,
                                device=self.device)
        self._buf[..., 3] = 255
        self._head = 0
        self._phase = 0.0          # fractional columns owed
        self._acc = None           # float32 sum of columns since last paint
        self._acc_n = 0
        self._acc_is_vis = False   # True: _acc sums vis, not RGBA

    @property
    def lut_table(self):
        return self._lut_host

    @lut_table.setter
    def lut_table(self, table) -> None:
        self._lut_host = table
        if table is None:
            self._lut = None
        elif isinstance(table, torch.Tensor):
            self._lut = table.to(self.device, torch.uint8).contiguous()
        else:
            self._lut = torch.from_numpy(np.array(table, np.uint8)).to(
                self.device)

    def _on_device(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device).to(dtype)

    def add_column(self, rgba_column, vis_column=None) -> None:
        """rgba_column: (rows, 4) uint8; vis_column: the matching (rows,)
        float32 display values (``Column.vis``), for averaging before the
        colormap.  Paints 0 or more pixel columns by the scroll speed;
        stays on the device."""
        if rgba_column.ndim != 2:
            raise ValueError(
                f"add_column expects one (rows, 4) column, got shape "
                f"{tuple(rgba_column.shape)} — for multichannel streams "
                f"pass one channel (e.g. col.rgba[ch])")
        use_vis = vis_column is not None and self._lut is not None
        self._phase += self.scroll_speed
        steps = int(self._phase)
        self._phase -= steps
        if steps == 0:
            # fractional speed: bank this column for the next painted pixel
            if self._acc is not None and self._acc_is_vis != use_vis:
                raise ValueError(_MIXED)
            banked = self._on_device(vis_column if use_vis else rgba_column,
                                     torch.float32)
            if self._acc is None:
                self._acc = banked
                self._acc_n = 1
                self._acc_is_vis = use_vis
            else:
                self._acc = self._acc + banked
                self._acc_n += 1
            return
        if self._acc is not None:
            if self._acc_is_vis and use_vis:
                mean = (self._acc + self._on_device(vis_column, torch.float32)
                        ) / (self._acc_n + 1)
                column = apply_lut(mean, self._lut)
            elif not self._acc_is_vis and not use_vis:
                column = torch.round(
                    (self._acc + self._on_device(rgba_column, torch.float32))
                    / (self._acc_n + 1)).to(torch.uint8)
            else:
                raise ValueError(_MIXED)
            self._acc = None
            self._acc_n = 0
        else:
            column = self._on_device(rgba_column, torch.uint8)
        slots = torch.remainder(
            torch.arange(self._head, self._head + steps, device=self.device),
            self.width)
        self._buf.index_copy_(0, slots,
                              column.unsqueeze(0).expand(steps, -1, -1))
        self._head = (self._head + steps) % self.width

    def image(self) -> np.ndarray:
        """Host copy, oldest column left, bass at the bottom:
        (rows, width, 4)."""
        buf = self._buf.cpu().numpy()            # (width, rows, 4)
        ordered = np.concatenate([buf[self._head:], buf[:self._head]], axis=0)
        return ordered.transpose(1, 0, 2)[::-1]
