"""Four-step (Bailey / Cooley–Tukey) FFT as two dense DFT products
(``emspec.dsp.fourstep``).

With x reshaped row-major to (N1, N2), n = N2·n1 + n2, k = k1 + N1·k2:

    A[k1, n2] = Σ_{n1} x[n1, n2]·W_{N1}^{n1·k1}        (product over n1)
    B[k1, n2] = A[k1, n2]·W_N^{n2·k1}                  (twiddle)
    X[k1, k2] = Σ_{n2} B[k1, n2]·W_{N2}^{n2·k2}        (product over n2)
    out[k1 + N1·k2] = X[k1, k2]

Steps 1–3 go through ``fft4_steps123``: kernel B4 for a CUDA tensor
(the two sub-DFTs as radix FFTs in shared memory), its plain float32
einsum/matmul version for a CPU tensor.  Step 4 is a
transpose and reshape here, as in the JAX package.  This engine runs
where the caller selects ``fft_impl="fourstep"``; it agrees with
``torch.fft`` to float32 rounding, and its CPU products may round
differently at different batch shapes, so streaming ≡ batch holds to
float32 rounding on it (bit for bit on the ``xla`` engine).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from emspec_torch.dsp.kernels.fourstep import fft4_steps123, tables

_FACTORS = {
    256: (16, 16),
    512: (16, 32), 1024: (32, 32), 2048: (32, 64), 4096: (64, 64),
    8192: (64, 128), 16384: (128, 128), 32768: (128, 256),
    65536: (256, 256), 131072: (256, 512), 262144: (512, 512),
}


def _tables(n: int) -> tuple:
    """(C1, S1, TWr, TWi, C2, S2) float32 numpy tables for size n, built
    in float64 (``emspec.dsp.fourstep._tables``)."""
    return tables(*_FACTORS[n])


def supported(n: int) -> bool:
    return n in _FACTORS


def fft_fourstep(z_r: torch.Tensor, z_i: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full complex DFT of z = z_r + i·z_i, shape (..., n) → (..., n)."""
    n = z_r.shape[-1]
    n1, n2 = _FACTORS[n]
    lead = z_r.shape[:-1]
    b = math.prod(lead)
    Xr, Xi = fft4_steps123(z_r.reshape(b, n1, n2).contiguous(),
                           z_i.reshape(b, n1, n2).contiguous())
    # step 4: out[k1 + N1·k2] → transpose (k2, k1) then flatten
    Xr = Xr.transpose(-1, -2).reshape(lead + (n,))
    Xi = Xi.transpose(-1, -2).reshape(lead + (n,))
    return Xr, Xi


def rfft_fourstep(x: torch.Tensor) -> torch.Tensor:
    """Real-input DFT → complex64 (..., n//2+1), matching ``torch.fft.rfft``.

    Even/odd samples become real/imag of one N/2-point complex four-step
    FFT, untangled by the Hermitian split; where N/2 has no factorization
    (N = 256) the full N-point transform of x + 0i runs instead."""
    n = x.shape[-1]
    h = n // 2
    if h not in _FACTORS:
        Xr, Xi = fft_fourstep(x, torch.zeros_like(x))
        return torch.complex(Xr[..., :h + 1], Xi[..., :h + 1])
    x2 = x.reshape(x.shape[:-1] + (h, 2))
    Zr, Zi = fft_fourstep(x2[..., 0], x2[..., 1])      # N/2-point complex
    # Hermitian split at k = 0..N/2 (indices (−k) mod N/2)
    Zr_k = torch.cat([Zr, Zr[..., :1]], dim=-1)         # Z(k), k=0..h
    Zi_k = torch.cat([Zi, Zi[..., :1]], dim=-1)
    Zr_c = torch.cat(                                   # Re Z(h−k), k=0..h
        [Zr[..., :1], torch.flip(Zr[..., 1:], (-1,)), Zr[..., :1]], dim=-1)
    Zi_c = -torch.cat(                                  # Im conj(Z(h−k))
        [Zi[..., :1], torch.flip(Zi[..., 1:], (-1,)), Zi[..., :1]], dim=-1)
    Er = 0.5 * (Zr_k + Zr_c)
    Ei = 0.5 * (Zi_k + Zi_c)
    Or = 0.5 * (Zi_k - Zi_c)                            # −i(Z−Zc)/2, real part
    Oi = 0.5 * (Zr_c - Zr_k)
    # X(k) = E(k) + W_N^k · O(k),  W_N^k = cos − i·sin
    c, s = _twiddles(h, str(x.device))
    Xr = Er + c * Or + s * Oi
    Xi = Ei + c * Oi - s * Or
    return torch.complex(Xr, Xi)


@functools.lru_cache(maxsize=None)
def _twiddles(h: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of 2πk/N, k = 0..N/2, built in float64, float32."""
    ang = np.pi * np.arange(h + 1) / h
    return tuple(torch.from_numpy(v.astype(np.float32)).to(device)
                 for v in (np.cos(ang), np.sin(ang)))


def packed_pair_fft(a: torch.Tensor, b: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """DFTs of two real signals via ONE complex four-step FFT of a + i·b,
    unpacked by the Hermitian split:
        A(k) = (Z(k) + conj(Z(N−k)))/2,  B(k) = −i·(Z(k) − conj(Z(N−k)))/2
    → complex64 (..., n//2+1) each.  Streaming and batch pack the same
    way (the JAX package's numeric spec of the fourstep stencil path)."""
    n = a.shape[-1]
    Zr, Zi = fft_fourstep(a, b)
    Zr_c = torch.cat([Zr[..., :1], torch.flip(Zr[..., 1:], (-1,))], dim=-1)
    Zi_c = -torch.cat([Zi[..., :1], torch.flip(Zi[..., 1:], (-1,))], dim=-1)
    k = n // 2 + 1
    Ar = 0.5 * (Zr[..., :k] + Zr_c[..., :k])
    Ai = 0.5 * (Zi[..., :k] + Zi_c[..., :k])
    Br = 0.5 * (Zi[..., :k] - Zi_c[..., :k])
    Bi = 0.5 * (Zr_c[..., :k] - Zr[..., :k])
    return torch.complex(Ar, Ai), torch.complex(Br, Bi)
