"""Time-frequency reassignment — "Enhanced" mode (``emspec.dsp.reassign``).

Auger–Flandrin corrections from the three window STFTs, each bin's power
quantized to its reassigned cell ``(round(t + Δt/hop), round(k +
Δω·N/2π))`` of the (frames, bins) grid, and summed there.  The sum is
kernel B2 (``dsp.kernels.scatter.histogram``) over the absolute grid on
the card, ids ``t_bin·K + f_bin``, by its sorted route's tiles form (a
deposit lands within R = ceil(N / 2·hop) columns of its frame, since
``reassigned_bins`` drops every |Δt| > N/2): each cell adds its deposits
in (frame, bin) order, with no atomics and no sort, so two runs give the
same grid, bit for bit, and so the same image.  Its plain version on the
CPU adds in the same order, as the JAX package's ``segment_sum`` does.
"""

from __future__ import annotations

import math

import torch

from emspec_torch.dsp.kernels.scatter import SORTED, histogram
from emspec_torch.dsp.stft import stft_triple

# power at or below this (on |X_h|² of float32 frames in [-1, 1]) is
# dropped rather than reassigned: its corrections are noise
DEFAULT_POWER_FLOOR = 1e-12


def reassignment_corrections(X_h: torch.Tensor, X_th: torch.Tensor,
                             X_dh: torch.Tensor):
    """→ (power |X_h|², Δt samples, Δω rad/sample), all float32.

    Δt = Re(X_th·conj X_h)/|X_h|²,  Δω = −Im(X_dh·conj X_h)/|X_h|²."""
    re_h, im_h = X_h.real, X_h.imag
    power = re_h * re_h + im_h * im_h
    inv = 1.0 / torch.clamp(power, min=1e-30)
    dt = (X_th.real * re_h + X_th.imag * im_h) * inv
    dw = -(X_dh.imag * re_h - X_dh.real * im_h) * inv
    return power, dt, dw


def reassigned_bins(power: torch.Tensor, dt: torch.Tensor, dw: torch.Tensor,
                    n: int, hop: int, num_frames: int,
                    power_floor: float = DEFAULT_POWER_FLOOR):
    """Quantize (..., frames, K) corrections to integer (t_bin, f_bin)
    targets → (t_bin, f_bin, masked power): a cell outside the grid, a
    power at or below the floor, or |Δt| beyond the window's half support
    N/2 carries zero power and clamped indices.  The column offset is
    rounded relative (δ, then + t), so every path quantizes alike."""
    k_count = n // 2 + 1
    dev = power.device
    t_idx = torch.arange(num_frames, dtype=torch.int32, device=dev)[:, None]
    k_idx = torch.arange(k_count, dtype=torch.float32, device=dev)[None, :]
    t_bin = t_idx + torch.round(dt / float(hop)).to(torch.int32)
    f_hat = k_idx + dw * (float(n) / (2.0 * math.pi))
    f_bin = torch.round(f_hat).to(torch.int32)
    valid = ((power > power_floor)
             & (t_bin >= 0) & (t_bin < num_frames)
             & (f_bin >= 0) & (f_bin < k_count)
             & (torch.abs(dt) <= float(n) / 2.0))
    t_bin = torch.clamp(t_bin, 0, num_frames - 1)
    f_bin = torch.clamp(f_bin, 0, k_count - 1)
    return t_bin, f_bin, torch.where(valid, power, torch.zeros_like(power))


def scatter_segment_sum(t_bin: torch.Tensor, f_bin: torch.Tensor,
                        power: torch.Tensor, num_frames: int,
                        k_count: int, reach: int | None = None
                        ) -> torch.Tensor:
    """Σ power into the (..., num_frames, k_count) grid at (t_bin, f_bin),
    per leading row: one launch of B2's sorted route over every row on the
    card (the same sums on every run) — its tiles form where ``reach``
    bounds |t_bin − frame| of every deposit of nonzero power, whose
    (num_frames, k_count) deposits are the grid's own shape.  A deposit of
    zero power (an invalid one) takes id −1 and adds nothing: adding +0.0
    changes no cell, and the clamped edge cells, where every invalid
    deposit lands, never see it."""
    lead = t_bin.shape[:-2]
    ids = torch.where(power != 0, t_bin * k_count + f_bin, -1)
    bound = {} if reach is None else dict(reach=reach, frame_len=k_count)
    out = histogram(ids.reshape(lead + (-1,)).contiguous(),
                    power.reshape(lead + (-1,)).contiguous(),
                    num_frames * k_count, route=SORTED, **bound)
    return out.reshape(lead + (num_frames, k_count))


def reassigned_spectrogram(x: torch.Tensor, n: int, hop: int,
                           power_floor: float = DEFAULT_POWER_FLOOR
                           ) -> torch.Tensor:
    """(..., samples) → reassigned power spectrogram (..., frames, n//2+1):
    window STFTs → corrections → quantize → sum.

    The spectra are the JAX package's stencil method on the CPU; on the
    card the direct method, whose three windows are one pass of kernel B5
    (one read of the frames, three windowed writes) before three real
    FFTs.  The two differ by float32 rounding only, which moves a
    deposit only where it sits on a rounding edge (compared by energy and
    max-filters, ``emspec_torch.validate``)."""
    method = "direct" if x.device.type == "cuda" else "stencil"
    X_h, X_th, X_dh = stft_triple(x, n, hop, method)
    t = X_h.shape[-2]
    power, dt, dw = reassignment_corrections(X_h, X_th, X_dh)
    t_bin, f_bin, p = reassigned_bins(power, dt, dw, n, hop, t, power_floor)
    return scatter_segment_sum(t_bin, f_bin, p, t, n // 2 + 1,
                               reach=-(-n // (2 * hop)))
