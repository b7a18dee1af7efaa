"""The port's real FFT wrapper — float32 frames (..., N) → the real DFT's
bins k = 0 … N/2, complex64 (..., N/2 + 1), or their power |X|² with
non-finite power zeroed (source ``emspec_torch/csrc/rfft.cu``).

Not a port of a Pallas kernel: it stands where the JAX package calls
XLA's ``jnp.fft.rfft`` (``emspec/pipeline.py:311`` natural mode,
``:402`` the direct method; ``emspec/dsp/stft.py:29``, ``:214``).  The
JAX package resolves natural mode and multires to that rfft because it
is bitwise batch-shape-stable, so its streaming ≡ batch is bit-exact
(``emspec/pipeline.py:203-207``).  On the card cuFFT is not: a frame
gets other bits by the number of frames in its batch.  This kernel's
arithmetic for a frame depends on N alone (``route_of``), never on the
batch or on the frame's place in it, so b = 1 gives frame f of any batch
bit for bit, and a live hop's spectra are the batch's.

Routes, by N alone: "full" (N = 256: the 256-point complex transform of
x + 0i, as ``dsp.fourstep.rfft_fourstep`` does where N/2 has no
factorization), "block" (N = 512 … 32768: one launch, each frame's
even/odd-packed N/2-point FFT in shared memory, kernel B4's radix body,
and the real-input unpack) and "large" (N = 65536 … 262144: pack, kernel
B4's steps 1–3 through ``fft4_steps123``, which counts its own launches,
then unpack).  ``rfft_frames.launches`` counts every call that launches,
``rfft_frames.route_launches`` by route.

Frames are read through their strides (each frame contiguous), so the
framing ``unfold`` view and the stream's window slices go in uncopied.
A float32 ``window`` (N,) is multiplied in as each sample loads (one
rounding, as ``frames * window``).  ``power=True`` stores
fl(fl(Re²) + fl(Im²)) — no FMA contraction, so it is what plain PyTorch
computes from the kernel's spectrum — zeroed where it is not finite
(``torch.where(isfinite)``): natural mode's ``_bank_power`` whole.

``rfft_frames_plain`` is the same function in plain PyTorch:
``torch.fft.rfft`` row by row on the CPU (MKL's batched real FFT rounds
differently from its one-row transform at n ≥ 16384; row by row gives
each frame the same bits in a batch and alone), one call on a CUDA
tensor.  It serves the CPU path, the tests and the plain references;
nothing on a card's main path calls it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from emspec_torch import kernels_build
from emspec_torch.dsp.fourstep import _FACTORS
from emspec_torch.dsp.kernels import (
    counted, launch_stream, require, require_cuda)
from emspec_torch.dsp.kernels.fourstep import (
    device_radix_tables, fft4_steps123)

MIN_N, MAX_N = 256, 262144
FULL_N = 256             # route "full": 16 × 16, the transform of x + 0i
BLOCK_MAX_N = 32768      # route "block": one (n1, n2 + 1) tile in a block
ROUTES = ("full", "block", "large")


def supported(n: int) -> bool:
    """Frame sizes the kernel holds: powers of two in [256, 262144]."""
    return MIN_N <= n <= MAX_N and (n & (n - 1)) == 0


def route_of(n: int) -> str:
    """The kernel's route for frames of n points: by size only, never by
    batch."""
    return ("full" if n == FULL_N else "block" if n <= BLOCK_MAX_N
            else "large")


def require_sizes(sizes, what: str) -> None:
    """Raise a ValueError naming the sizes the kernel does not hold."""
    bad = [n for n in sizes if not supported(n)]
    require(not bad, what, f"frame sizes {bad} outside the card's real FFT "
            f"(powers of two in [{MIN_N}, {MAX_N}])")


def scrubbed_power(X: torch.Tensor) -> torch.Tensor:
    """|X|² = X.real² + X.imag², non-finite power zeroed (for finite input
    an exact identity): ``emspec/pipeline.py:310-313``."""
    power = X.real * X.real + X.imag * X.imag
    return torch.where(torch.isfinite(power), power, torch.zeros_like(power))


def rfft_frames_plain(frames: torch.Tensor, window=None, *,
                      power: bool = False) -> torch.Tensor:
    """``torch.fft.rfft`` of ``frames * window`` over the last axis (row by
    row on the CPU, one call on a card), or its ``scrubbed_power``."""
    x = frames if window is None else frames * window
    if x.device.type == "cpu" and x.dim() > 1 and x.numel() > 0:
        rows = x.reshape(-1, x.shape[-1])
        X = torch.stack([torch.fft.rfft(r) for r in rows]).reshape(
            x.shape[:-1] + (-1,))
    else:
        X = torch.fft.rfft(x, dim=-1)
    return scrubbed_power(X) if power else X


@functools.lru_cache(maxsize=None)
def unpack_twiddles(n: int, device: str) -> torch.Tensor:
    """The real-input unpack's e^{−2πij/n}, j < n/2, built in float64,
    stored as float32 pairs (this kernel's and B1's)."""
    ang = -2.0 * np.pi * np.arange(n // 2) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


def factors(n: int) -> tuple:
    """(n1, n2) of the transform the route runs: the N-point one at 256,
    the N/2-point one above."""
    return _FACTORS[n] if n == FULL_N else _FACTORS[n // 2]


def _checked(frames: torch.Tensor, window, what: str) -> torch.Tensor:
    """Check a kernel call → the frames as a (lead, frames_per_lead, n)
    view read through its strides.  The size, type and layout checks come
    before the device's, so each refusal reads the same on any device."""
    n = frames.shape[-1] if frames.dim() else 0
    require(supported(n), what, f"n={n}: the kernel takes powers of two in "
            f"[{MIN_N}, {MAX_N}]")
    require(frames.dtype == torch.float32 and frames.stride(-1) == 1, what,
            f"frames must be float32 (..., {n}) with unit last stride, got "
            f"{frames.dtype}")
    require(window is None or (
        window.dtype == torch.float32 and tuple(window.shape) == (n,)
        and window.is_contiguous() and window.device == frames.device), what,
        f"window must be a contiguous float32 ({n},) tensor on the frames' "
        f"device")
    require_cuda(frames, what)
    return (frames.reshape(1, 1, n) if frames.dim() == 1
            else frames[None] if frames.dim() == 2
            else frames.reshape((-1,) + frames.shape[-2:]))


def _launch(frames: torch.Tensor, window, power: bool,
            what: str = "rfft_frames") -> torch.Tensor:
    """The kernel's call (a CUDA tensor only: anything else raises)."""
    f3 = _checked(frames, window, what)
    n = frames.shape[-1]
    out = torch.empty(frames.shape[:-1] + (n // 2 + 1,),
                      dtype=torch.float32 if power else torch.complex64,
                      device=frames.device)
    b = f3.shape[0] * f3.shape[1]
    if b == 0:
        return out
    route = route_of(n)
    n1, n2 = factors(n)
    lib = kernels_build.library()
    tw = unpack_twiddles(n, str(frames.device))
    sink = (None, out.data_ptr()) if power else (out.data_ptr(), None)
    win = None if window is None else window.data_ptr()
    lead = (f3.data_ptr(), f3.shape[0], f3.shape[1], f3.stride(0),
            f3.stride(1), win)
    with torch.cuda.device(frames.device):
        if route == "large":
            planes = torch.empty((2, b, n1, n2), dtype=torch.float32,
                                 device=frames.device)
            rc = lib.emspec_rfft_pack(*lead, planes[0].data_ptr(),
                                      planes[1].data_ptr(), n,
                                      launch_stream(frames))
            kernels_build.check(rc, what)
            xr, xi = fft4_steps123(planes[0], planes[1])
            rc = lib.emspec_rfft_unpack(xr.data_ptr(), xi.data_ptr(),
                                        tw.data_ptr(), *sink, b, n, n1, n2,
                                        launch_stream(frames))
        else:
            w512, tw4 = device_radix_tables(n1, n2, frames.device)
            rc = lib.emspec_rfft(*lead, w512.data_ptr(), tw4.data_ptr(),
                                 tw.data_ptr(), *sink, n, n1, n2,
                                 launch_stream(frames))
    kernels_build.check(rc, what)
    rfft_frames.launches += 1
    rfft_frames.route_launches[route] += 1
    return out


@counted
def rfft_frames(frames: torch.Tensor, window=None, *,
                power: bool = False) -> torch.Tensor:
    """frames (..., N) float32 → complex64 (..., N/2 + 1), or float32
    power with the scrub (``power``); ``window`` (N,) float32 or None.  A
    CPU tensor takes ``rfft_frames_plain``; a CUDA tensor the kernel, or
    the call raises (a size, type or layout it does not take)."""
    if frames.device.type == "cpu":
        return rfft_frames_plain(frames, window, power=power)
    return _launch(frames, window, power)


rfft_frames.route_launches = dict.fromkeys(ROUTES, 0)

