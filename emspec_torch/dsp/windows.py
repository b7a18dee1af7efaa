"""Analysis windows for STFT + time-frequency reassignment (a copy of
``emspec.dsp.windows``; ``tests/test_torch_copies.py`` pins it bit-equal).

The reassignment method (reference: README.md:11 "Reassignment Method —
Advanced frequency analysis for sharper spectral detail") needs three
windows per FFT size [NS north_star: "Hann plus the time-weighted t·h(t)
and derivative dh/dt auxiliary windows"]:

* ``h[n]``  — periodic Hann, ``0.5 - 0.5 cos(2πn/N)``;
* ``th[n]`` — time-weighted window ``(n - N/2)·h[n]``; the time variable is
  measured in **samples from the frame center** so the reassignment time
  correction Δt comes out directly in samples;
* ``dh[n]`` — the **analytic** derivative dh/dn = ``(π/N)·sin(2πn/N)``
  (units 1/sample).  Analytic, not finite-difference, for bit-stable
  parity with the float64 oracle (SURVEY.md §2.2).

All three are precomputed per FFT size in float64 and cast once.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _windows_np(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Float64 window triple (h, th, dh) of length ``n`` (cached)."""
    idx = np.arange(n, dtype=np.float64)
    phase = 2.0 * np.pi * idx / n
    h = 0.5 - 0.5 * np.cos(phase)              # periodic Hann
    th = (idx - n / 2.0) * h                   # time ramp in samples, centered
    dh = (np.pi / n) * np.sin(phase)           # analytic dh/dn
    return h, th, dh


def hann(n: int, dtype=np.float32) -> np.ndarray:
    return _windows_np(n)[0].astype(dtype)


def time_weighted_hann(n: int, dtype=np.float32) -> np.ndarray:
    return _windows_np(n)[1].astype(dtype)


def hann_derivative(n: int, dtype=np.float32) -> np.ndarray:
    return _windows_np(n)[2].astype(dtype)


def window_triple(n: int, dtype=np.float32) -> np.ndarray:
    """Stacked ``(3, n)`` array ``[h, th, dh]`` — the layout consumed by the
    fused windowing kernel B5 (one read of the frame, three writes)."""
    return np.stack(_windows_np(n)).astype(dtype)
