"""Offline animation of the scrolling waterfall
(``emspec.render.animate``).

Frame ``k`` is the waterfall a live viewer at ``fps`` sees at time
``k / fps``: the state after ``k · sample_rate / fps`` input samples went
through the real streaming path (the port's ``Stream`` and
``Waterfall``, the objects ``python -m emspec_torch stream`` drives: each
cell's sums in bin order, the same on every run).  So the LAST frame (after the flush) equals that command's
snapshot PNG of the same audio.  Frames stream out of a generator, so
the APNG writer compresses them one at a time.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from emspec_torch.config import Settings


def frame_count(n_samples: int, sample_rate: int, fps: float) -> int:
    """Frames :func:`animate_frames` yields: one per started display tick
    of the audio's duration (≥ 1 for any non-empty audio)."""
    return max(1, math.ceil(n_samples * fps / sample_rate))


def animate_frames(audio: np.ndarray, settings: Settings, fps: float = 30.0,
                   width: int = 1024, device="cuda") -> Iterator[np.ndarray]:
    """Yield (H, W, 4) uint8 display frames of ``audio`` at ``fps``, on
    ``device``.

    ``audio``: (n,) for one channel, or (channels, n) matching
    ``settings.channels`` for a tiled per-channel view (one waterfall a
    channel, composed with ``render.png.tile_images``).  The final frame
    includes the stream's flush."""
    from emspec_torch.render.png import tile_images
    from emspec_torch.render.waterfall import Waterfall
    from emspec_torch.stream import Stream
    from emspec_torch.tables import lut

    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps}")
    s = settings
    nch = s.channels
    if (audio.ndim == 2) != (nch > 1) or (audio.ndim == 2
                                          and audio.shape[0] != nch):
        raise ValueError(
            f"audio shape {audio.shape} does not match settings.channels="
            f"{nch} — pass (channels, n) iff channels > 1")
    stream = Stream(s, device)
    wfs = [Waterfall(width, s.raster_height, s.scroll_speed,
                     lut_table=lut(s.colormap), device=device)
           for _ in range(nch)]

    def paint(col):
        one = col.rgba.ndim == 2
        for c, wf in enumerate(wfs):
            wf.add_column(col.rgba if one else col.rgba[c],
                          col.vis if one else col.vis[c])

    n = audio.shape[-1]
    n_frames = frame_count(n, s.sample_rate, fps)
    fed = 0
    for k in range(1, n_frames + 1):
        # audio consumed by display time k/fps; the last tick feeds the
        # remainder so float rounding can never strand samples
        target = n if k == n_frames else min(
            n, int(round(k * s.sample_rate / fps)))
        if target > fed:
            for col in stream.push(audio[..., fed:target]):
                paint(col)
            fed = target
        if k == n_frames:
            for col in stream.flush():
                paint(col)
        yield tile_images([wf.image() for wf in wfs])
