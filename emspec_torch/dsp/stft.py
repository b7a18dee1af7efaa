"""Stencil-method reassignment spectra, plain PyTorch (``emspec.dsp.stft``).

Two real transforms per frame — raw and time-weighted (t·h) — as two
``torch.fft.rfft`` calls on the ``xla`` engine (``stft.py:213-215``).  The
``fourstep`` engine packs them into one complex four-step FFT, as the JAX
package does (``stft.py:210-212``): at N = 8192 the t·h spectrum carries
~N/7 times the raw one's energy, so that pack costs the raw spectrum
~10 bits — it is the reference's numeric spec of that engine, kept.
``X_h`` and ``X_dh`` then follow exactly from 3-point periodic-Hann
stencils on the raw spectrum.

The ``xla`` branch feeds the deposits kernel's plain reference
(``emspec_torch.dsp.kernels.deposits``) and the CPU path.  Its real FFT
is ``rfft``: batch-shape stable on the CPU (see there), so streaming ≡
batch holds bit for bit at every frame size.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from emspec_torch.dsp.fourstep import packed_pair_fft
from emspec_torch.dsp.windows import time_weighted_hann


@functools.lru_cache(maxsize=None)
def _th_table(n: int, device: str) -> torch.Tensor:
    """float32 t·h window (the same table the JAX package applies)."""
    return torch.from_numpy(time_weighted_hann(n, np.float32)).to(device)


def th_window(n: int, device) -> torch.Tensor:
    return _th_table(n, str(torch.device(device)))


def rfft(x: torch.Tensor) -> torch.Tensor:
    """``torch.fft.rfft`` over the last axis.  On the CPU each row is
    transformed alone: MKL's batched real FFT rounds differently from its
    one-row transform at n ≥ 16384 (the live step transforms one window,
    the batch path a stack of frames), and a row-by-row transform gives
    each frame the same bits in either.  A CUDA tensor is transformed in
    one call."""
    if x.device.type != "cpu" or x.dim() == 1 or x.numel() == 0:
        return torch.fft.rfft(x, dim=-1)
    rows = x.reshape(-1, x.shape[-1])
    return torch.stack([torch.fft.rfft(r) for r in rows]).reshape(
        x.shape[:-1] + (-1,))


def stft_raw_pair(frames: torch.Tensor, fft_impl: str = "xla"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw spectrum X, t·h spectrum X_th), each (..., n//2+1) complex64.
    ``fft_impl="fourstep"``: one packed complex four-step FFT of the pair
    (``emspec.dsp.stft.stft_raw_pair``'s fourstep branch)."""
    n = frames.shape[-1]
    th = th_window(n, frames.device)
    if fft_impl == "fourstep":
        return packed_pair_fft(frames, frames * th)
    F = rfft(torch.stack([frames, frames * th]))
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


def stft_triple_stencil(frames: torch.Tensor, fft_impl: str = "xla"):
    """Pre-cut frames (..., n) → (X_h, X_th, X_dh) (..., n//2+1)."""
    n = frames.shape[-1]
    X, X_th = stft_raw_pair(frames, fft_impl)
    return stencil_from_raw(X, X_th, n)
