"""Settings surface of the port (a copy of ``emspec.config``).

The port imports nothing of the JAX package, so it keeps its own copy of
``Settings``, the mode and size constants, ``STRUCTURAL_FIELDS``,
``is_structural_change`` and ``PresetStore``; ``tests/test_torch_copies.py``
holds each to its original (field names, defaults, validation, and a
presets file written by either package loading in the other).

Structural fields change shapes or precomputed tables and build a new
``Pipeline``; continuous fields become tensors of ``PipelineParams``, so
moving a slider swaps tensors and rebuilds nothing.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

# FFT sizes offered by the settings dropdown (512..32768) and the scaling
# extension to 262144.
FFT_SIZES = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072,
             262144)

# Analysis modes (reference: settings.png "Enhanced" / "Natural" buttons).
MODE_ENHANCED = "enhanced"  # reassignment on  (README.md:11)
MODE_NATURAL = "natural"    # plain |STFT|^2

COLORMAPS = ("inferno", "magma", "viridis", "plasma", "turbo", "grayscale")


@dataclasses.dataclass(frozen=True)
class Settings:
    """Complete settings surface. Field defaults replicate the reference
    defaults observable in assets/settings.png (v0.4.3)."""

    # -------- structural (recompile on change) --------
    fft_size: int = 4096                # "FFT Size" dropdown
    sample_rate: int = 48_000           # input stream rate
    channels: int = 1                   # input channel count
    mode: str = MODE_ENHANCED           # "enhanced" (reassign) | "natural"
    multires: bool = True               # Enhanced Low-End Response (README.md:10)
    multires_sizes: tuple = (8192, 2048, 512)   # low/mid/high banks [NS configs[2]]
    raster_height: int = 512            # log-frequency rows of the display raster
    raster_width: int = 1024            # time columns of the scrolling waterfall
    hop: int = 0                        # samples per hop; 0 = auto (fft_size // 4
                                        # of the *smallest* active bank)

    # -------- continuous (no recompile; members of Params) --------
    colormap: str = "inferno"           # "Colormap" (LUT swap is data)
    brightness: float = 0.44            # "Brightness 44%": 0.5 = neutral, x2 scale
    db_range: float = 58.0              # "dB Range" — visible dynamic window
    gain: float = 3.5                   # "Gain" — linear power multiplier
    freq_scale: float = 1.0             # "Freq Scale" — log-axis zoom factor
    low_end_boost: float = 3.9          # "Low End Boost" — bass power gain
    noise_gate_db: float = -65.0        # "Noise Gate" — hide below threshold
    agc_strength: float = 1.0           # "AGC Strength"
    smoothing: float = 0.0              # temporal EMA coefficient alpha
    scroll_speed: float = 1.0           # waterfall columns per hop
    display_channel: int = 0            # which channel the single-view
                                        # display shows (continuous: a host-
                                        # side slice, never recompiles; the
                                        # analysis always runs all channels)

    # -------- toggles --------
    auto_gain: bool = True              # "Auto Gain" button = AGC enabled
    on_top: bool = False                # window always-on-top (shell flag; no-op here)
    agc_global: bool = False            # couple AGC across channels (one brightness
                                        # for the whole display; cross-chip collective
                                        # when channels are sharded) [INF]

    # -------- analysis detail knobs (rebuild-specific, documented [INF]) --------
    freq_min: float = 20.0              # bottom of the log-frequency axis
    fft_impl: str = "auto"              # FFT engine: "auto" (= "xla" in
                                        # the port, Pipeline.fft_impl),
                                        # "fourstep" (DFT-GEMM four-step,
                                        # kernel B4 on the card) or "xla"
                                        # (the port's direct real FFT: its
                                        # kernel on the card, torch.fft on
                                        # the CPU).  Streaming == batch is
                                        # bit-exact for "xla" on both;
                                        # "fourstep" agrees to float32
                                        # rounding, tested.
    fft_method: str = "stencil"         # reassignment FFT formulation:
                                        # "stencil" (2 rffts + exact Hann
                                        # stencils) or "direct" (3 rffts)
    scatter: str = "auto"               # reassignment scatter backend:
                                        # "auto" (relative histogram, kernel
                                        # B2, on the card), "pallas",
                                        # or "segment_sum" (SURVEY §7 hard
                                        # part 1: keep both, parity-tested)
    scatter_passes: int = 2             # pallas scatter bf16 split terms:
                                        # 2 (default) bounds the histogram
                                        # error at 2^-16 relative; 1 is a
                                        # display-grade mode (~4e-3 rel,
                                        # invisible through the 8-bit LUT;
                                        # measured only +6% on stress — the
                                        # kernel is not purely pass-bound);
                                        # 3 is f32-exact
    crossover_low: float = 200.0        # multires band edge: 8192-bank below
    crossover_high: float = 2000.0      # multires band edge: 512-bank above
    low_end_cutoff: float = 200.0       # Low-End-Boost ramp corner frequency
    reassign_floor_db: float = -120.0   # drop reassigned energy below this power

    # every float-valued knob: a hostile/typo'd value (string, None,
    # NaN, inf) must fail HERE with a clean ValueError — at the
    # ``replace()`` boundary, before any pipeline state mutates — not
    # as an arbitrary exception deep inside table construction (the
    # web shell turns these into 400s; found by a hostile-settings
    # barrage against the live /api/settings endpoint)
    _FLOAT_FIELDS = ("brightness", "db_range", "gain", "freq_scale",
                     "low_end_boost", "noise_gate_db", "agc_strength",
                     "smoothing", "scroll_speed", "freq_min",
                     "crossover_low", "crossover_high", "low_end_cutoff",
                     "reassign_floor_db")

    def __post_init__(self):
        import math

        import numpy as _np
        for fname in self._FLOAT_FIELDS:
            v = getattr(self, fname)
            # bound at float32 range, not float64: the params pytree is
            # f32 on device, so an f64-finite 1e308 would silently
            # overflow to inf past this gate.  numpy scalars are
            # legitimate library inputs (np.float64 subclasses float;
            # np.float32/np.int64 do not subclass anything).
            if not isinstance(v, (int, float, _np.integer, _np.floating)) \
                    or isinstance(v, bool) \
                    or not math.isfinite(v) or abs(v) > 3.0e38:
                raise ValueError(
                    f"{fname} must be a finite number (float32 range), "
                    f"got {v!r}")
        for fname, lo in (("raster_height", 2), ("raster_width", 1),
                          ("sample_rate", 1), ("hop", 0)):
            v = getattr(self, fname)
            if not isinstance(v, (int, _np.integer)) or isinstance(v, bool) \
                    or v < lo:
                raise ValueError(f"{fname} must be an int >= {lo}, got {v!r}")
        if self.db_range <= 0:
            raise ValueError(f"db_range must be > 0, got {self.db_range}")
        if self.scroll_speed <= 0:
            raise ValueError(
                f"scroll_speed must be > 0, got {self.scroll_speed}")
        if not (0.02 <= self.freq_scale <= 100.0):
            # zoom < 0.02 stretches the ~10-octave audio span past
            # exp2's float64 range (log_freq_axis would emit inf rows)
            raise ValueError(
                f"freq_scale must be in [0.02, 100], got {self.freq_scale}")
        for fname in ("freq_min", "crossover_low", "crossover_high",
                      "low_end_cutoff"):
            if getattr(self, fname) <= 0:
                raise ValueError(
                    f"{fname} must be > 0, got {getattr(self, fname)}")
        if self.fft_size not in FFT_SIZES:
            raise ValueError(f"fft_size must be one of {FFT_SIZES}, got {self.fft_size}")
        if self.mode not in (MODE_ENHANCED, MODE_NATURAL):
            raise ValueError(f"mode must be 'enhanced' or 'natural', got {self.mode!r}")
        if self.colormap not in COLORMAPS:
            raise ValueError(f"colormap must be one of {COLORMAPS}, got {self.colormap!r}")
        if self.channels < 1:
            raise ValueError("channels must be >= 1")
        if not (0 <= self.display_channel < self.channels):
            raise ValueError(
                f"display_channel {self.display_channel} out of range for "
                f"{self.channels} channel(s)")
        if not (0.0 <= self.smoothing < 1.0):
            raise ValueError("smoothing must be in [0, 1)")
        if self.scatter not in ("auto", "pallas", "segment_sum"):
            raise ValueError(f"unknown scatter backend: {self.scatter!r}")
        if self.scatter_passes not in (1, 2, 3):
            raise ValueError("scatter_passes must be 1, 2 or 3")
        if self.fft_method not in ("stencil", "direct"):
            raise ValueError(f"unknown fft_method: {self.fft_method!r}")
        if self.fft_impl not in ("auto", "fourstep", "xla"):
            raise ValueError(f"unknown fft_impl: {self.fft_impl!r}")
        for n in self.multires_sizes:
            # power-of-two ≥ 256: every kernel tile policy (Pallas windowing
            # n_tile, fourstep factorization, frame slice-concat) assumes it
            if n < 256 or (n & (n - 1)) != 0:
                raise ValueError(
                    f"multires_sizes must be powers of two >= 256, got {n}")

    # ---- derived quantities ----
    @property
    def active_fft_sizes(self) -> tuple:
        """FFT banks the pipeline runs: the multires triple or the single size."""
        return tuple(self.multires_sizes) if self.multires else (self.fft_size,)

    @property
    def hop_samples(self) -> int:
        """Samples advanced per raster column (auto: quarter of smallest bank)."""
        if self.hop > 0:
            return self.hop
        return min(self.active_fft_sizes) // 4

    @property
    def freq_max(self) -> float:
        return self.sample_rate / 2.0

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)

    # ---- (de)serialization: the preset/"checkpoint" contract (§5.4) ----
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["multires_sizes"] = list(d["multires_sizes"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Settings":
        known = {f.name for f in dataclasses.fields(cls)}
        clean: dict[str, Any] = {k: v for k, v in d.items() if k in known}
        if "multires_sizes" in clean:
            clean["multires_sizes"] = tuple(clean["multires_sizes"])
        return cls(**clean)


STRUCTURAL_FIELDS = frozenset({
    "fft_size", "sample_rate", "channels", "mode", "multires",
    "multires_sizes", "raster_height", "raster_width", "hop", "agc_global",
    "scatter", "scatter_passes", "fft_method", "fft_impl",
    # analysis-geometry knobs: they shape the precomputed merge tables and
    # the per-bank band-support slices, so changing them re-specializes
    # (freq_scale zoom stays continuous — support is zoom-independent)
    "freq_min", "crossover_low", "crossover_high",
})


def is_structural_change(old: Settings, new: Settings) -> bool:
    """True iff switching ``old`` → ``new`` requires a new ``Pipeline``
    (SURVEY.md §3.3 continuous-vs-structural split)."""
    return any(getattr(old, f) != getattr(new, f) for f in STRUCTURAL_FIELDS)


# ---------------------------------------------------------------------------
# Presets: named Settings bundles persisted as JSON (reference: README.md:16
# "Add/Edit/Delete" preset buttons; settings.png dropdown "Default").
# ---------------------------------------------------------------------------

class PresetStore:
    """JSON-backed preset CRUD. Falls back to defaults on parse error
    (failure-recovery contract, SURVEY.md §5.3)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._presets: dict[str, Settings] = {"Default": Settings()}
        if self.path.exists():
            try:
                raw = json.loads(self.path.read_text())
                self._presets = {name: Settings.from_dict(d) for name, d in raw.items()}
                self._presets.setdefault("Default", Settings())
            except (json.JSONDecodeError, TypeError, ValueError, KeyError):
                # corrupt store → defaults (never crash the app on bad JSON)
                self._presets = {"Default": Settings()}

    def names(self) -> list[str]:
        return sorted(self._presets)

    def get(self, name: str) -> Settings:
        return self._presets[name]

    def add(self, name: str, settings: Settings) -> None:
        self._presets[name] = settings
        self._save()

    # "Edit" in the reference UI is an overwrite of an existing name.
    edit = add

    def delete(self, name: str) -> None:
        if name == "Default":
            raise ValueError("the Default preset cannot be deleted")
        del self._presets[name]
        self._save()

    def _save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {name: s.to_dict() for name, s in self._presets.items()}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
        tmp.replace(self.path)
