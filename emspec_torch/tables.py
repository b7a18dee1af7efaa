"""Numpy-only table functions the port needs from jax-importing modules.

The originals live in ``emspec.dsp.multires``, ``emspec.post.colormap``
and ``emspec.post.chain``, which import ``jax.numpy`` at the top.  The
machine that runs the port has no JAX, so importing them there fails;
these are line-for-line copies (tests/test_torch_tables.py pins every one
bit-equal to its original, for every colormap).
"""

from __future__ import annotations

import functools

import numpy as np

from emspec.post._cmap_data import rgb_table

LUT_SIZE = 256


def log_freq_axis(rows: int, f_min: float, f_max: float,
                  zoom: float = 1.0) -> np.ndarray:
    """Display-row center frequencies, log-spaced bottom→top
    (``emspec.dsp.multires.log_freq_axis``)."""
    lo, hi = np.log2(f_min), np.log2(f_max)
    hi_z = lo + (hi - lo) / max(zoom, 1e-3)
    return np.exp2(np.linspace(lo, hi_z, rows))


def band_weights(row_freqs: np.ndarray, sizes: tuple, crossover_low: float,
                 crossover_high: float, fade_octaves: float = 0.5) -> np.ndarray:
    """(num_banks, rows) partition-of-unity band weights
    (``emspec.dsp.multires.band_weights``)."""
    def lowpass(f, edge):
        x = np.log2(np.maximum(f, 1e-9) / edge) / fade_octaves
        x = np.clip(x + 0.5, 0.0, 1.0)
        return 0.5 * (1.0 + np.cos(np.pi * x))

    edges = [crossover_low, crossover_high]
    n_banks = len(sizes)
    w = np.zeros((n_banks, len(row_freqs)))
    prev_low = np.ones(len(row_freqs))
    for b in range(n_banks):
        if b < n_banks - 1 and b < len(edges):
            lp = lowpass(row_freqs, edges[b])
        else:
            lp = np.zeros(len(row_freqs)) if b < n_banks - 1 else None
        if b == n_banks - 1:
            w[b] = prev_low
        else:
            w[b] = prev_low * lp
            prev_low = prev_low * (1.0 - lp)
    return w


def band_weight_at(freqs_hz: np.ndarray, bank: int, n_banks: int,
                   crossover_low: float, crossover_high: float,
                   fade_octaves: float = 0.5) -> np.ndarray:
    """Bank ``bank``'s weight at arbitrary frequencies
    (``emspec.dsp.multires.band_weight_at``)."""
    return band_weights(freqs_hz, tuple(range(n_banks)) if n_banks else (),
                        crossover_low, crossover_high, fade_octaves)[bank]


def bank_offsets(sizes: tuple) -> tuple:
    """Per-bank start offset that center-aligns all banks' frames
    (``emspec.dsp.multires.bank_offsets``)."""
    n_max = max(sizes)
    return tuple((n_max - n) // 2 for n in sizes)


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
