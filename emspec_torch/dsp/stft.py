"""Short-time Fourier transforms (``emspec.dsp.stft``).

``stft``, ``power_spectrogram`` and ``stft_triple`` take a signal:
frames (``dsp.frame``) → window → the real FFT ``rfft_frames``.  The JAX
package leaves that FFT to XLA's ``jnp.fft.rfft``, whose bits do not
depend on the batch (``emspec/dsp/stft.py:191``); the port keeps that
property on every device: on the card it is the port's own kernel
(``dsp.kernels.rfft``: a frame's arithmetic depends on N alone, never on
the batch), on the CPU ``torch.fft.rfft`` row by row.  So a frame
transformed alone (a live hop) and the same frame in a batch get the
same bits, and streaming ≡ batch holds bit for bit at every frame size.
cuFFT is never called on a card's path: its bits depend on the batch.
``stft_triple``'s direct method windows the frames three ways with kernel
B5 on the card (``dsp.kernels.window``), its plain version on the CPU.

Stencil-method reassignment spectra:

Two real transforms per frame — raw and time-weighted (t·h) — as two
``rfft_frames`` calls on the ``xla`` engine (``stft.py:213-215``; the
card's kernel).  The ``fourstep`` engine packs them into one complex
four-step FFT, as the JAX package does (``stft.py:210-212``): at N =
8192 the t·h spectrum carries ~N/7 times the raw one's energy, so that
pack costs the raw spectrum ~10 bits — it is the reference's numeric
spec of that engine, kept.  ``X_h`` and ``X_dh`` then follow exactly from
3-point periodic-Hann stencils on the raw spectrum.

The pruned DFT (``stft_triple_stencil_sliced``/``_blocks``) computes
only the bins ``[k_lo, k_hi)`` of a band-sliced multires bank, as a
float32 matrix product (``torch.matmul``, TF32 off: ``device.py``)
against a DFT matrix built in float64 — the JAX package's formulation
(``stft.py:93-185``), which it runs outside any Pallas kernel.

``stft_triple_stencil_plain`` is the plain reference of the stencil
spectra (``torch.fft.rfft``, ``dsp.kernels.rfft.rfft_frames_plain``):
kernel B1's plain version calls it, so a card comparison of B1 against
its plain version holds B1 to the library FFT, never to another kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from emspec_torch.dsp.fourstep import packed_pair_fft
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.rfft import rfft_frames, rfft_frames_plain
from emspec_torch.dsp.kernels.window import windowed_frames
from emspec_torch.dsp.windows import hann, time_weighted_hann


@functools.lru_cache(maxsize=None)
def _th_table(n: int, device: str) -> torch.Tensor:
    """float32 t·h window (the same table the JAX package applies)."""
    return torch.from_numpy(time_weighted_hann(n, np.float32)).to(device)


def th_window(n: int, device) -> torch.Tensor:
    return _th_table(n, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _hann_table(n: int, device: str) -> torch.Tensor:
    """float32 periodic Hann (``emspec.dsp.windows.hann``)."""
    return torch.from_numpy(hann(n)).to(device)


def hann_window(n: int, device) -> torch.Tensor:
    return _hann_table(n, str(torch.device(device)))


def stft(x: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """(..., samples) → complex STFT (..., frames, n//2+1), Hann window."""
    frames = frame_signal(x, n, hop)
    return rfft_frames(frames, hann_window(n, frames.device))


def power_spectrogram(x: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """Natural-mode power spectrogram |X_h|², (..., frames, n//2+1)."""
    X = stft(x, n, hop)
    return X.real * X.real + X.imag * X.imag


def stft_triple(x: torch.Tensor, n: int, hop: int, method: str = "stencil"):
    """(X_h, X_th, X_dh) of a signal (..., samples), each (..., frames,
    n//2+1).  ``"direct"``: the frames windowed by [h, t·h, dh/dn] (B5 on
    the card) and three real FFTs; ``"stencil"``: two real FFTs (raw and
    t·h) and the exact periodic-Hann stencils.  The two differ by float32
    rounding only."""
    frames = frame_signal(x, n, hop)
    if method == "direct":
        X = rfft_frames(windowed_frames(frames))
        return X[0], X[1], X[2]
    return stft_triple_stencil(frames)


def stft_raw_pair(frames: torch.Tensor, fft_impl: str = "xla"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(raw spectrum X, t·h spectrum X_th), each (..., n//2+1) complex64.
    ``fft_impl="fourstep"``: one packed complex four-step FFT of the pair
    (``emspec.dsp.stft.stft_raw_pair``'s fourstep branch)."""
    n = frames.shape[-1]
    th = th_window(n, frames.device)
    if fft_impl == "fourstep":
        return packed_pair_fft(frames, frames * th)
    F = rfft_frames(torch.stack([frames, frames * th]))
    return F[0], F[1]


def _stencils(X, Xm1, Xp1, n: int):
    """3-point periodic-Hann stencils → (X_h, X_dh); X_dh = (−i·c)·(Xm1 −
    Xp1) in real arithmetic, c rounded to float32."""
    X_h = 0.5 * X - 0.25 * (Xm1 + Xp1)
    c = float(np.float32(0.5 * math.pi / n))
    d = Xm1 - Xp1
    return X_h, torch.complex(c * d.imag, -c * d.real)


def stencil_from_raw(X: torch.Tensor, X_th: torch.Tensor, n: int):
    """(raw, t·h) spectra → (X_h, X_th, X_dh); neighbours at k = −1 and
    N/2+1 come from Hermitian symmetry of the real input."""
    Xm1 = torch.cat([torch.conj(X[..., 1:2]), X[..., :-1]], dim=-1)
    Xp1 = torch.cat([X[..., 1:], torch.conj(X[..., -2:-1])], dim=-1)
    X_h, X_dh = _stencils(X, Xm1, Xp1, n)
    return X_h, X_th, X_dh


def stft_triple_stencil(frames: torch.Tensor, fft_impl: str = "xla"):
    """Pre-cut frames (..., n) → (X_h, X_th, X_dh) (..., n//2+1)."""
    n = frames.shape[-1]
    X, X_th = stft_raw_pair(frames, fft_impl)
    return stencil_from_raw(X, X_th, n)


def stft_triple_stencil_plain(frames: torch.Tensor):
    """``stft_triple_stencil`` through ``torch.fft.rfft`` on every device
    (``rfft_frames_plain``): the plain reference's spectra."""
    n = frames.shape[-1]
    F = rfft_frames_plain(torch.stack([frames,
                                       frames * th_window(n, frames.device)]))
    return stencil_from_raw(F[0], F[1], n)


def _dft_columns(n: int, k_lo: int, k_hi: int) -> np.ndarray:
    """float64 (n, 2(K+2)): [cos | sin] of the DFT at k = k_lo−1 … k_hi
    (the stencil neighbours included; k = −1 and N/2+1 need no Hermitian
    case here, the matrix is evaluated at those k)."""
    ks = np.arange(k_lo - 1, k_hi + 1)
    ang = (-2.0 * np.pi / n) * np.outer(np.arange(n), ks)
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1)


@functools.lru_cache(maxsize=None)
def _sliced_matrix(n: int, k_lo: int, k_hi: int, device: str):
    return torch.from_numpy(
        _dft_columns(n, k_lo, k_hi).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _block_matrices(n: int, k_lo: int, k_hi: int, hop: int, device: str):
    """(m, hop, 4(K+2)) float32: [cos | sin | th·cos | th·sin], the t·h
    window folded in (in float64), cut into m = ⌈n/hop⌉ row blocks (the
    last zero-padded)."""
    w = _dft_columns(n, k_lo, k_hi)
    th = time_weighted_hann(n, np.float64)
    w4 = np.concatenate([w, th[:, None] * w], axis=1)
    m = -(-n // hop)
    w4 = np.pad(w4, ((0, m * hop - n), (0, 0)))
    return torch.from_numpy(
        w4.reshape(m, hop, -1).astype(np.float32)).to(device)


def _sliced_triple(Xe, X_th, n: int):
    """(K+2) raw bins k_lo−1 … k_hi and the t·h bins → (X_h, X_th, X_dh)
    on k_lo … k_hi−1."""
    X_h, X_dh = _stencils(Xe[..., 1:-1], Xe[..., :-2], Xe[..., 2:], n)
    return X_h, X_th[..., 1:-1], X_dh


def stft_triple_stencil_sliced(frames: torch.Tensor, k_lo: int, k_hi: int):
    """Pruned-DFT reassignment spectra: bins [k_lo, k_hi) of (X_h, X_th,
    X_dh), (..., k_hi − k_lo), from frames (..., n) by one product of the
    raw and the t·h frames with the (n, 2(K+2)) DFT columns
    (``emspec.dsp.stft.stft_triple_stencil_sliced``)."""
    n = frames.shape[-1]
    lead = frames.shape[:-1]
    w = _sliced_matrix(n, k_lo, k_hi, str(frames.device))
    f2 = frames.reshape(-1, n)
    pair = torch.cat([f2, f2 * th_window(n, frames.device)])    # (2B, n)
    out = torch.matmul(pair, w)
    K2 = k_hi - k_lo + 2
    X = torch.complex(out[:, :K2], out[:, K2:]).reshape((2,) + lead + (K2,))
    return _sliced_triple(X[0], X[1], n)


def stft_triple_stencil_blocks(x2: torch.Tensor, t: int, n: int, k_lo: int,
                               k_hi: int):
    """``stft_triple_stencil_sliced`` of the ``t`` frames of n points whose
    hop blocks are ``x2 = frame.signal_blocks(x, n, hop)`` (..., rows,
    hop), without the frames: frames @ W = Σ_j x2[..., j:j+t, :] @
    W[j·hop:(j+1)·hop], m = ⌈n/hop⌉ products summed in float32, with the
    t·h window folded into W (``emspec.dsp.stft.stft_triple_stencil_blocks``).
    → (X_h, X_th, X_dh), each (..., t, k_hi − k_lo)."""
    hop = x2.shape[-1]
    wj = _block_matrices(n, k_lo, k_hi, hop, str(x2.device))
    acc = torch.matmul(x2[..., 0:t, :], wj[0])
    for j in range(1, wj.shape[0]):
        acc += torch.matmul(x2[..., j:j + t, :], wj[j])
    K2 = k_hi - k_lo + 2
    Xe = torch.complex(acc[..., :K2], acc[..., K2:2 * K2])
    X_th = torch.complex(acc[..., 2 * K2:3 * K2], acc[..., 3 * K2:])
    return _sliced_triple(Xe, X_th, n)

