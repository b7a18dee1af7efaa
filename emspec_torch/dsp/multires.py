"""Multi-resolution banks and the log-frequency merge (``emspec.dsp.multires``).

All banks share one hop and are center-aligned: with ``N_max`` the
largest bank, bank b's frame t covers ``[(N_max−N_b)//2 + t·hop, … + N_b)``.
The merge onto the display rows is a precomputed gather + lerp per row,

    out[r] = Σ_b band_w[b,r] · (w0[b,r]·S_b[i0[b,r]] + (1−w0[b,r])·S_b[i0[b,r]+1]) / N_b²

with raised-cosine band crossfades forming a partition of unity.  The
tables are host numpy (they depend on continuous params only, so a slider
move rebuilds a few KB of tables and nothing else); ``merge_columns``
takes them as tensors on the spectra's device.  The numpy table
functions are line-for-line copies of the originals
(``tests/test_torch_tables.py`` and ``tests/test_torch_copies.py`` pin
them bit-equal).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def log_freq_axis(rows: int, f_min: float, f_max: float,
                  zoom: float = 1.0) -> np.ndarray:
    """Display-row center frequencies, log-spaced bottom→top."""
    lo, hi = np.log2(f_min), np.log2(f_max)
    hi_z = lo + (hi - lo) / max(zoom, 1e-3)
    return np.exp2(np.linspace(lo, hi_z, rows))


def band_weights(row_freqs: np.ndarray, sizes: tuple, crossover_low: float,
                 crossover_high: float, fade_octaves: float = 0.5) -> np.ndarray:
    """(num_banks, rows) partition-of-unity band weights."""
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
    """Bank ``bank``'s weight at arbitrary frequencies."""
    return band_weights(freqs_hz, tuple(range(n_banks)) if n_banks else (),
                        crossover_low, crossover_high, fade_octaves)[bank]


def bank_offsets(sizes: tuple) -> tuple:
    """Per-bank start offset that center-aligns all banks' frames."""
    n_max = max(sizes)
    return tuple((n_max - n) // 2 for n in sizes)


class MergeTables(NamedTuple):
    """Per-bank gather/lerp tables."""
    row_freqs: np.ndarray          # (rows,)
    i0: tuple                      # per bank: (rows,) int32 lower bin index
    w0: tuple                      # per bank: (rows,) float32 lower bin weight
    band_w: tuple                  # per bank: (rows,) float32 band weight


def build_merge_tables(sizes: tuple, sample_rate: int, rows: int,
                       f_min: float, freq_scale: float,
                       crossover_low: float, crossover_high: float
                       ) -> MergeTables:
    """Numpy tables (``emspec.dsp.multires.build_merge_tables``)."""
    row_freqs = log_freq_axis(rows, f_min, sample_rate / 2.0, freq_scale)
    bw = band_weights(row_freqs, sizes, crossover_low, crossover_high)
    i0s, w0s = [], []
    for n in sizes:
        bin_hz = sample_rate / n
        pos = row_freqs / bin_hz                 # fractional bin per row
        k_count = n // 2 + 1
        # clip before the int cast: an extreme zoom can push pos past int32
        i0 = np.floor(np.clip(pos, 0, k_count - 2)).astype(np.int32)
        frac = np.clip(pos - i0, 0.0, 1.0)
        i0s.append(i0)
        w0s.append((1.0 - frac).astype(np.float32))
    return MergeTables(
        row_freqs=row_freqs,
        i0=tuple(i0s),
        w0=tuple(w0s),
        band_w=tuple(w.astype(np.float32) for w in bw),
    )


def band_support_hz(bank: int, n_banks: int, crossover_low: float,
                    crossover_high: float, nyquist: float,
                    fade_octaves: float = 0.5) -> tuple[float, float]:
    """[lo, hi] Hz outside which bank ``bank``'s weight is exactly zero
    (``emspec.dsp.multires.band_support_hz``)."""
    edges = [crossover_low, crossover_high]
    half = 2.0 ** (fade_octaves / 2.0)
    lo = 0.0 if bank == 0 else edges[bank - 1] / half
    hi = nyquist if bank == n_banks - 1 else edges[bank] * half
    return lo, hi


def merge_columns(bank_specs, tables: MergeTables) -> torch.Tensor:
    """Per-bank power spectra (..., K_b) → one log-f raster column
    (..., rows).  ``tables``' i0/w0/band_w are tensors on the spectra's
    device (``PipelineParams``).  Each bank is scaled 1/N_b² so a
    stationary tone shows equally bright through any bank."""
    acc = None
    for S, i0, w0, bw in zip(bank_specs, tables.i0, tables.w0, tables.band_w):
        n = (S.shape[-1] - 1) * 2
        lerp = (torch.index_select(S, -1, i0) * w0
                + torch.index_select(S, -1, i0 + 1) * (1.0 - w0))
        contrib = lerp * bw * (1.0 / float(n * n))
        acc = contrib if acc is None else acc + contrib
    return acc
