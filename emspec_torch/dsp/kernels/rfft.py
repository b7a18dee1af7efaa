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

Routes, by N alone (``route_of``): "full" (N = 256: the 256-point
complex transform of x + 0i, as ``dsp.fourstep.rfft_fourstep`` does
where N/2 has no factorization), "block" (N = 512 … ``CLUSTER_MIN_N``/2:
one launch, each frame's even/odd-packed N/2-point FFT in one block's
shared memory, kernel B4's radix body, and the real-input unpack) and
"cluster" (``CLUSTER_MIN_N`` … 262144: one launch, a frame a
thread-block cluster of ``cluster_plan``'s CTAs, ``csrc/rfft_cluster.cu``;
``cluster_occupancy`` asks the card first, and a size it cannot hold is
refused).  Kept for timing and comparison, reached only by the keyword
``route=`` (``routes_of``): "block" up to 32768 and "large" at 65536 …
262144 (pack, kernel B4's steps 1–3 through ``fft4_steps123``, which
counts its own launches, then unpack: the route before the cluster's).
Every route runs the same lines through the same passes and the same
unpack, so a frame gets the same bits on each.
``rfft_frames.launches`` counts every call that launches,
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

import ctypes
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
CLUSTER_MIN_N = 16384    # route "cluster" from here on (route_of)
LARGE_MIN_N = 65536      # route "large": three launches, forced only
ROUTES = ("full", "block", "cluster", "large")
# route "cluster": log2 of the CTAs a cluster, by N alone (the exchange
# needs >= 16 rows and columns a CTA, >= 128 threads, m/C points a CTA)
CLUSTER_LOG2C = {16384: 2, 32768: 3, 65536: 3, 131072: 4, 262144: 4}
MAX_SMEM = 232448        # a block's shared memory on the H100
TABLE = 512              # B4's W_512 table, float2 a point
CLUSTER_POINTS = 16      # FFT points a thread of the cluster kernel


def supported(n: int) -> bool:
    """Frame sizes the kernel holds: powers of two in [256, 262144]."""
    return MIN_N <= n <= MAX_N and (n & (n - 1)) == 0


def route_of(n: int) -> str:
    """The kernel's route for frames of n points: by size only, never by
    batch."""
    return ("full" if n == FULL_N else "block" if n < CLUSTER_MIN_N
            else "cluster")


def routes_of(n: int) -> tuple:
    """Every route that holds frames of n points, ``route_of``'s first:
    the others are reached only by ``route=``."""
    held = [r for r, ok in (
        ("full", n == FULL_N),
        ("block", FULL_N < n <= BLOCK_MAX_N),
        ("cluster", n in CLUSTER_LOG2C),
        ("large", LARGE_MIN_N <= n <= MAX_N)) if ok and supported(n)]
    return tuple(sorted(held, key=lambda r: r != route_of(n)))


def cluster_plan(n: int, log2c: int | None = None) -> dict:
    """Route "cluster"'s plan at n points (``csrc/rfft_cluster.cu``
    cplan): C = 2^log2c CTAs a cluster (``CLUSTER_LOG2C`` by N alone),
    W = n2/C columns before the exchange and A = n1/C rows after it, the
    padded strides W' and Q (A·W' = W·Q), threads and shared bytes a
    CTA."""
    log2c = CLUSTER_LOG2C[n] if log2c is None else log2c
    n1, n2 = factors(n)
    c = 1 << log2c
    w, a = n2 // c, n1 // c
    wp, q = (w + w // a, a + 1) if w % a == 0 else (w + 1, a + a // w)
    return dict(log2c=log2c, ctas=c, w=w, a=a, wp=wp, q=q,
                threads=n1 * n2 // c // CLUSTER_POINTS,
                smem=8 * (TABLE + n1 * wp))


def require_sizes(sizes, what: str) -> None:
    """Raise a ValueError naming the sizes the kernel does not hold."""
    bad = [n for n in sizes if not supported(n)]
    require(not bad, what, f"frame sizes {bad} outside the card's real FFT "
            f"(powers of two in [{MIN_N}, {MAX_N}])")


def require_card(sizes, device, what: str) -> None:
    """Raise a ValueError naming the sizes whose cluster the card cannot
    hold (``cluster_occupancy`` 0): never a quiet fall back to another
    route."""
    if not torch.cuda.is_available():
        return          # no card to ask: a launch there raises on its own
    bad = [n for n in sizes if supported(n) and route_of(n) == "cluster"
           and cluster_occupancy(n, device) == 0]
    require(not bad, what, f"frame sizes {bad}: the card holds no cluster "
            f"of {[cluster_plan(n)['ctas'] for n in bad]} CTAs for the real "
            f"FFT's route \"cluster\"")


def cluster_occupancy(n: int, device, log2c: int | None = None) -> int:
    """How many clusters of route "cluster" at n points the card holds at
    once (``cudaOccupancyMaxActiveClusters``); 0 where it refuses the
    cluster size."""
    plan = cluster_plan(n, log2c)
    return _cluster_occupancy(n, str(torch.device(device)), plan["log2c"])


@functools.lru_cache(maxsize=None)
def _cluster_occupancy(n: int, device: str, log2c: int) -> int:
    got = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = kernels_build.library().emspec_rfft_cluster_occupancy(
            *factors(n), log2c, ctypes.byref(got))
    kernels_build.check(rc, "cluster_occupancy")
    return got.value


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


def _checked(frames: torch.Tensor, window, what: str,
             route: str | None = None) -> torch.Tensor:
    """Check a kernel call → the frames as a (lead, frames_per_lead, n)
    view read through its strides.  The size, route, type and layout
    checks come before the device's, so each refusal reads the same on
    any device."""
    n = frames.shape[-1] if frames.dim() else 0
    require(supported(n), what, f"n={n}: the kernel takes powers of two in "
            f"[{MIN_N}, {MAX_N}]")
    require(route is None or route in routes_of(n), what,
            f"route={route!r} does not hold n={n} (routes {routes_of(n)})")
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
            what: str = "rfft_frames", route: str | None = None,
            log2c: int | None = None) -> torch.Tensor:
    """The kernel's call (a CUDA tensor only: anything else raises) on
    ``route_of``'s route, or ``route``; ``log2c`` sets route "cluster"'s
    CTAs a cluster (timing only: the bits do not depend on it)."""
    f3 = _checked(frames, window, what, route)
    n = frames.shape[-1]
    out = torch.empty(frames.shape[:-1] + (n // 2 + 1,),
                      dtype=torch.float32 if power else torch.complex64,
                      device=frames.device)
    b = f3.shape[0] * f3.shape[1]
    if b == 0:
        return out
    route = route or route_of(n)
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
        elif route == "cluster":
            plan = cluster_plan(n, log2c)
            require(cluster_occupancy(n, frames.device, plan["log2c"]) > 0,
                    what, f"the card holds no cluster of {plan['ctas']} "
                    f"CTAs")
            w512, tw4 = device_radix_tables(n1, n2, frames.device)
            rc = lib.emspec_rfft_cluster(*lead, w512.data_ptr(),
                                         tw4.data_ptr(), tw.data_ptr(),
                                         *sink, n, n1, n2, plan["log2c"],
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
def rfft_frames(frames: torch.Tensor, window=None, *, power: bool = False,
                route: str | None = None) -> torch.Tensor:
    """frames (..., N) float32 → complex64 (..., N/2 + 1), or float32
    power with the scrub (``power``); ``window`` (N,) float32 or None.  A
    CPU tensor takes ``rfft_frames_plain``; a CUDA tensor the kernel on
    ``route_of``'s route, or the call raises (a size, type or layout it
    does not take).  ``route`` forces another of ``routes_of(N)``, for
    timing and comparison (the same bits)."""
    if frames.device.type == "cpu":
        n = frames.shape[-1] if frames.dim() else 0
        require(route is None or route in routes_of(n), "rfft_frames",
                f"route={route!r} does not hold n={n} (routes "
                f"{routes_of(n)})")
        return rfft_frames_plain(frames, window, power=power)
    return _launch(frames, window, power, route=route)


rfft_frames.route_launches = dict.fromkeys(ROUTES, 0)
