"""Offline single-bank raster: audio → display RGBA image on a linear
frequency axis (``emspec.render.raster``).

Time runs horizontally, frequency vertically with bass at the bottom.
Enhanced mode sums reassigned deposits (``dsp.reassign``: kernel B5's
window triple, three real FFTs, corrections, kernel B2 over the absolute
(frames, bins) grid on the card); natural mode is the Hann power
spectrogram.  Then the batch post chain (``post.chain``, the EMA scan
kernel on the card) and the colormap (kernel B3).  Everything runs on
``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from emspec_torch.config import MODE_ENHANCED, Settings
from emspec_torch.device import DTYPE, as_device
from emspec_torch.dsp.reassign import reassigned_spectrogram
from emspec_torch.dsp.stft import power_spectrogram
from emspec_torch.post.chain import PostParams, PostState, postprocess_batch
from emspec_torch.post.colormap import apply_lut
from emspec_torch.tables import lut


def analyze(x: torch.Tensor, s: Settings) -> torch.Tensor:
    """(samples,) → linear power spectrogram (frames, bins) of the mode."""
    n, hop = s.fft_size, s.hop if s.hop > 0 else s.fft_size // 4
    if s.mode == MODE_ENHANCED:
        return reassigned_spectrogram(x, n, hop)
    return power_spectrogram(x, n, hop)


def postprocess(power_tk: torch.Tensor, freqs_hz: np.ndarray, s: Settings,
                params: PostParams | None = None) -> torch.Tensor:
    """Batch post chain over (..., frames, bins) power → (frames, ...,
    bins) vis (state evolution bit-identical to the streaming chain's)."""
    p = params or PostParams.from_settings(s, freqs_hz, power_tk.device)
    state = PostState.init(power_tk.shape[:-2] + (power_tk.shape[-1],),
                           power_tk.device)
    cols_first = (torch.swapaxes(power_tk, 0, -2)
                  if power_tk.ndim > 2 else power_tk)
    vis, _ = postprocess_batch(cols_first.contiguous(), state, p,
                               s.agc_global)
    return vis


@functools.lru_cache(maxsize=8)
def _tables(s: Settings, device: str) -> tuple:
    """The host-built tables of one Settings bundle on ``device``: bin
    frequencies, post params and the colormap — built once, so a
    directory of files or a sweep renders without rebuilding them."""
    n = s.fft_size
    freqs = np.arange(n // 2 + 1) * (s.sample_rate / n)
    return (freqs, PostParams.from_settings(s, freqs, device),
            torch.from_numpy(lut(s.colormap).copy()).to(device))


def _render(x, s: Settings, device) -> tuple:
    """The one analysis → post → colormap computation that both
    ``render_image`` and ``render_vis`` read → (vis, rgba) on ``device``."""
    dev = as_device(device)
    freqs, params, table = _tables(s, str(dev))
    xt = (x.to(device=dev, dtype=DTYPE) if isinstance(x, torch.Tensor)
          else torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev))
    vis = postprocess(analyze(xt, s), freqs, s, params)
    return vis, apply_lut(vis, table)


def render_image(x, s: Settings, device="cuda") -> np.ndarray:
    """(samples,) float32 audio → (bins, frames, 4) uint8 RGBA image, bass
    at the bottom."""
    _, rgba = _render(x, s, device)
    return rgba.cpu().numpy().transpose(1, 0, 2)[::-1]


def render_vis(x, s: Settings, device="cuda") -> np.ndarray:
    """(samples,) audio → (bins, frames) float32 pre-LUT display values in
    [0, 1], bins ascending: the quantity ``render_image`` colours, from the
    same computation, so ``apply_lut(render_vis(x).T)`` is its image."""
    vis, _ = _render(x, s, device)
    return vis.cpu().numpy().T
