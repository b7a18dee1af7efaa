"""Numpy-only table functions of the port.

The originals live in ``emspec.post.colormap``, ``emspec.post.chain`` and
``emspec.pipeline``; the multires table functions are copied into
``emspec_torch.dsp.multires``.  The port imports nothing
of the JAX package, so these are line-for-line copies
(tests/test_torch_tables.py pins every one bit-equal to its original,
for every colormap).
"""

from __future__ import annotations

import functools

import numpy as np

from emspec_torch.post._cmap_data import rgb_table

LUT_SIZE = 256


@functools.lru_cache(maxsize=None)
def lut(name: str) -> np.ndarray:
    """(256, 4) uint8 RGBA lookup table (``emspec.post.colormap.lut``)."""
    if name == "grayscale":
        g = np.arange(LUT_SIZE, dtype=np.uint8)
        rgb = np.stack([g, g, g], axis=1)
    else:
        rgb = rgb_table(name)
    alpha = np.full((LUT_SIZE, 1), 255, dtype=np.uint8)
    out = np.concatenate([rgb, alpha], axis=1)
    out.setflags(write=False)
    return out


def low_end_ramp(freqs_hz: np.ndarray, boost: float,
                 cutoff_hz: float) -> np.ndarray:
    """Per-frequency bass-boost factor (``emspec.post.chain.low_end_ramp``)."""
    f = np.maximum(np.asarray(freqs_hz, np.float64), 1e-6)
    shape = np.clip(np.log2(cutoff_hz / f), 0.0, 1.0)
    return (1.0 + (float(boost) - 1.0) * shape).astype(np.float32)


def row_map_consts(row_freqs: np.ndarray, rows: int):
    """Enhanced-mode row map ``row = (log2 f − a)·b`` constants
    (``emspec.pipeline._row_map_consts``)."""
    a = np.log2(row_freqs[0])
    b = (rows - 1) / (np.log2(row_freqs[-1]) - np.log2(row_freqs[0]))
    return np.float32(a), np.float32(b)
