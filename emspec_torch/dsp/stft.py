"""Stencil-method reassignment spectra, plain PyTorch (``emspec.dsp.stft``).

Two real transforms per frame — raw and time-weighted (t·h) — as two
``torch.fft.rfft`` calls (the JAX package's ``fft_impl="xla"`` branch,
``stft.py:213-215``), never packed into one complex transform: at
N = 8192 the t·h spectrum carries ~N/7 times the raw one's energy and a
naive pack costs the raw spectrum ~10 bits.  ``X_h`` and ``X_dh`` then
follow exactly from 3-point periodic-Hann stencils on the raw spectrum.

These are the plain versions: they feed the deposits kernel's plain
reference (``emspec_torch.dsp.kernels.deposits``) and the CPU path.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from emspec.dsp.windows import time_weighted_hann


@functools.lru_cache(maxsize=None)
def _th_table(n: int, device: str) -> torch.Tensor:
    """float32 t·h window (the same table the JAX package applies)."""
    return torch.from_numpy(time_weighted_hann(n, np.float32)).to(device)


def th_window(n: int, device) -> torch.Tensor:
    return _th_table(n, str(torch.device(device)))


def stft_raw_pair(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw spectrum X, t·h spectrum X_th), each (..., n//2+1) complex64."""
    n = frames.shape[-1]
    th = th_window(n, frames.device)
    F = torch.fft.rfft(torch.stack([frames, frames * th]), dim=-1)
    return F[0], F[1]


def stencil_from_raw(X: torch.Tensor, X_th: torch.Tensor, n: int):
    """(raw, t·h) spectra → (X_h, X_th, X_dh); neighbours at k = −1 and
    N/2+1 come from Hermitian symmetry of the real input."""
    Xm1 = torch.cat([torch.conj(X[..., 1:2]), X[..., :-1]], dim=-1)
    Xp1 = torch.cat([X[..., 1:], torch.conj(X[..., -2:-1])], dim=-1)
    X_h = 0.5 * X - 0.25 * (Xm1 + Xp1)
    # X_dh = (−i·c)·(Xm1 − Xp1) in real arithmetic, c rounded to float32
    c = float(np.float32(0.5 * math.pi / n))
    d = Xm1 - Xp1
    X_dh = torch.complex(c * d.imag, -c * d.real)
    return X_h, X_th, X_dh


def stft_triple_stencil(frames: torch.Tensor):
    """Pre-cut frames (..., n) → (X_h, X_th, X_dh) (..., n//2+1)."""
    n = frames.shape[-1]
    X, X_th = stft_raw_pair(frames)
    return stencil_from_raw(X, X_th, n)
