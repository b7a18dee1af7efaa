"""Application controller: the app shell minus the window
(``emspec.app``), on ``device`` (the card unless the caller asks for the
CPU).

* Continuous params (gain, dB range, gate, smoothing, AGC strength,
  brightness, low-end boost, freq scale, colormap, scroll speed) take
  effect next hop: the ``Stream.params`` setter copies the new values
  into the tensors the stream's CUDA graph captured, and nothing is
  re-captured (``stream.captures`` stays).
* Structural params (FFT size, mode, multires, channels, sample rate)
  build a new ``Stream`` (its pipeline ideally warmed by ``prewarm``:
  then the stall is its warm-up hops and its capture) BEFORE any of
  ``self`` changes, swap it in, keep the display, and ``close`` the old
  stream so its graph's memory pool is released.
* Presets Add/Edit/Delete persist JSON; Enhanced/Natural switches the
  reassignment branch; the ``live_state.json`` watcher pauses and
  resumes the stream.

Columns stay device tensors into the ``Waterfall``; ``image()`` is the
one device→host copy, what a window would blit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from emspec_torch.config import PresetStore, Settings, is_structural_change
from emspec_torch.device import as_device
from emspec_torch.integrations.live_state import LiveStateWatcher
from emspec_torch.render.waterfall import Waterfall
from emspec_torch.stream import Stream
from emspec_torch.tables import lut
from emspec_torch.utils.notes import describe_frequency


class EmSpecApp:
    """Headless application driver over the streaming pipeline."""

    def __init__(self, settings: Settings | None = None,
                 user_dir: str | Path = ".emspec",
                 prewarm_sizes: tuple | None = None, device="cuda"):
        self.device = as_device(device)
        self.user_dir = Path(user_dir)
        self.presets = PresetStore(self.user_dir / "presets.json")
        self.settings = settings or self.presets.get("Default")
        self.stream = Stream(self.settings, self.device)
        self.waterfall = Waterfall(self.settings.raster_width,
                                   self.settings.raster_height,
                                   self.settings.scroll_speed,
                                   lut_table=lut(self.settings.colormap),
                                   device=self.device)
        # optional window-shell hooks (a native window mirrors the Info
        # View with a real minimize/restore); the stream pause/resume
        # happens first either way, on whichever stream is current
        self.on_minimized = None
        self.on_restored = None
        self.watcher = LiveStateWatcher(
            self.user_dir / "live_state.json",
            on_minimized=self._handle_minimized,
            on_restored=self._handle_restored)
        self._warm_future = None
        if prewarm_sizes:
            from emspec_torch.pipeline import prewarm
            self._warm_future = prewarm(self.settings, prewarm_sizes,
                                        device=self.device)

    # ------------------------------------------------------------- audio in
    def push_audio(self, samples: np.ndarray) -> int:
        """Feed captured samples; paints finished columns into the
        waterfall. Returns the number of columns painted."""
        self.watcher.poll()
        return self._paint(self.stream.push(samples))

    def _drain_until(self, deadline: float) -> tuple[int, bool]:
        """The web shell's drain tick: the pending hops up to the first
        hop boundary past ``deadline`` (a ``time.perf_counter`` value,
        one hop at least), painted → (columns painted, whether hops are
        still pending).  ``push_audio`` drains them all."""
        self.watcher.poll()
        st = self.stream
        if st._paused:
            return 0, False
        return self._paint(st._drain(deadline)), st.hop_pending()

    def _paint(self, cols) -> int:
        ch = self.settings.display_channel
        for c in cols:
            # single view: display_channel is continuous, a slice of the
            # columns (the analysis always runs every channel)
            one = c.rgba.ndim == 2
            self.waterfall.add_column(
                c.rgba if one else c.rgba[ch],
                c.vis if one else c.vis[ch])
        return len(cols)

    def image(self) -> np.ndarray:
        """(rows, width, 4) uint8 — what a window would blit."""
        return self.waterfall.image()

    # ------------------------------------------------------------ shutdown
    def close(self) -> None:
        """Abandon queued prewarm jobs, so process exit is not held behind
        the rest of the FFT-size dropdown."""
        if self._warm_future is not None:
            self._warm_future.cancel()
            self._warm_future = None

    # ------------------------------------------------------- window mirror
    def _handle_minimized(self) -> None:
        self.stream.pause()
        if self.on_minimized is not None:
            self.on_minimized()

    def _handle_restored(self) -> None:
        self.stream.resume()
        if self.on_restored is not None:
            self.on_restored()

    # ------------------------------------------------------------- settings
    def apply_settings(self, new: Settings) -> str:
        """Apply a settings change as the settings panel does.
        Returns "continuous" | "structural" | "noop"."""
        old = self.settings
        if new == old:
            return "noop"
        # exception safety: build everything the new settings need
        # before changing any of self, so a construction error leaves the
        # app on its old, consistent state
        if is_structural_change(old, new):
            table = lut(new.colormap)
            stream = Stream(new, self.device)
            if (new.raster_width != old.raster_width
                    or new.raster_height != old.raster_height):
                waterfall = Waterfall(new.raster_width, new.raster_height,
                                      new.scroll_speed, lut_table=table,
                                      device=self.device)
            else:
                waterfall = self.waterfall
            if self.stream._paused:
                stream.pause()
            replaced = self.stream
            self.settings = new
            self.stream = stream
            self.waterfall = waterfall
            self.waterfall.scroll_speed = new.scroll_speed
            self.waterfall.lut_table = table
            replaced.close()
            return "structural"
        # continuous: new values into the stream's own (captured) tensors
        params = self.stream.pipe.params(new)
        table = lut(new.colormap)
        self.settings = new
        self.stream.params = params
        self.waterfall.scroll_speed = new.scroll_speed
        self.waterfall.lut_table = table
        return "continuous"

    def set(self, **changes) -> str:
        """Slider-style convenience: ``app.set(gain=5.0)``."""
        return self.apply_settings(self.settings.replace(**changes))

    # -------------------------------------------------------------- presets
    def save_preset(self, name: str) -> None:
        self.presets.add(name, self.settings)

    def load_preset(self, name: str) -> str:
        return self.apply_settings(self.presets.get(name))

    def delete_preset(self, name: str) -> None:
        self.presets.delete(name)

    # ---------------------------------------------------------------- hover
    def _axis(self) -> np.ndarray:
        """Row frequencies at the CURRENT zoom (Freq Scale is continuous,
        so never the pipeline's construction-time tables)."""
        from emspec_torch.dsp.multires import log_freq_axis
        s = self.settings
        return log_freq_axis(s.raster_height, s.freq_min, s.freq_max,
                             s.freq_scale)

    def hover(self, row: int) -> str:
        """Shift+hover readout for a display row."""
        return describe_frequency(float(self._axis()[row]))

    def axis_ticks(self) -> list:
        """Frequency-ruler ticks of the log axis at the current zoom:
        ``[{"frac": 0..1 bottom→top, "label": "1 kHz"}, …]`` at round
        frequencies inside the visible axis, thinned to at most 9."""
        freqs = self._axis()
        f0, f1 = float(freqs[0]), float(freqs[-1])
        lo, hi = (f0, f1) if f1 > f0 else (f1, f0)
        ticks = []
        for f in (20, 30, 50, 100, 200, 300, 500, 1_000, 2_000, 3_000,
                  5_000, 10_000, 20_000, 40_000, 80_000):
            if not (lo <= f <= hi):
                continue
            frac = (np.log2(f) - np.log2(f0)) / (np.log2(f1) - np.log2(f0))
            if not (0.0 <= frac <= 1.0):
                continue
            label = (f"{f // 1000} kHz" if f >= 1000 else f"{f} Hz")
            ticks.append({"frac": round(float(frac), 5), "label": label})
        while len(ticks) > 9:
            ticks = ticks[::2]
        return ticks
