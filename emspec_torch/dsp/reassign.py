"""Auger–Flandrin reassignment corrections (``emspec.dsp.reassign``)."""

from __future__ import annotations

import torch


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
