"""Pipeline: settings → hop→raster functions (``emspec.pipeline``).

The ported slice is the main path: enhanced (reassigned) mode, one bank,
the stencil method.  Its chain, in batch and per hop:

  frames → deposits (kernel B1, ``dsp.kernels.deposits``)
         → relative histogram (kernel B2, ``dsp.kernels.scatter``)
         → static shift-add fold (batch) / roll into the pending ring
           (stream) → post chain (``post.chain``) → colormap (kernel B3).

``scatter="auto"`` takes that chain on CUDA and the absolute-grid
``segment_sum`` (``index_add_``) on the CPU; both stay selectable
(``"pallas"`` is the JAX package's name for the relative-histogram
route).  Kernel wrappers route by tensor device: on the CPU the same
calls run their plain PyTorch versions.

Settings outside the slice raise ``NotImplementedError`` on every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from emspec.config import MODE_ENHANCED, STRUCTURAL_FIELDS, Settings
from emspec_torch.device import DTYPE, as_device
from emspec_torch.dsp.frame import frame_signal, num_frames
from emspec_torch.dsp.kernels.deposits import (
    MAX_N, MIN_N, deposits_ids, deposits_plain, supported)
from emspec_torch.dsp.kernels.scatter import histogram, histogram_plain
from emspec_torch.post.chain import (
    PostParams, PostState, postprocess_batch, postprocess_column)
from emspec_torch.post.colormap import apply_lut
from emspec_torch.tables import (
    band_weight_at, log_freq_axis, lut, row_map_consts)


class PipelineParams(NamedTuple):
    """Everything continuous, as tensors on the pipeline's device:
    swapping any of them (slider moves, colormap change, Freq-Scale zoom)
    re-uses the same code with no host sync."""
    post: PostParams
    lut: torch.Tensor          # (256, 4) uint8
    logmap_a: torch.Tensor     # 0-d: row = (log2 f − a)·b
    logmap_b: torch.Tensor     # 0-d
    power_floor: torch.Tensor  # 0-d: drop |X_h|² at or below this


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to emspec_torch yet (ROADMAP.md, 'Modules "
        f"still to port'); use the emspec package")


class Pipeline:
    """The single-bank enhanced pipeline on one device."""

    def __init__(self, settings: Settings, device):
        s = settings
        if s.multires:
            raise _not_ported("multires=True")
        if s.mode != MODE_ENHANCED:
            raise _not_ported(f"mode={s.mode!r}")
        if s.fft_method != "stencil":
            raise _not_ported(f"fft_method={s.fft_method!r}")
        if s.fft_impl == "fourstep":
            raise _not_ported("fft_impl='fourstep'")
        if not supported(s.fft_size):
            raise _not_ported(f"fft_size={s.fft_size} (kernel B1 holds "
                              f"{MIN_N}..{MAX_N})")
        self.settings = s
        self.device = as_device(device)
        self.n_max = s.fft_size
        self.hop = s.hop_samples
        self.rows = s.raster_height
        self.row_freqs = log_freq_axis(self.rows, s.freq_min,
                                       s.sample_rate / 2.0, s.freq_scale)
        # deposits carry no band weight: the single-bank weight must be 1
        probe = band_weight_at(np.linspace(1.0, s.sample_rate / 2.0, 64), 0,
                               1, s.crossover_low, s.crossover_high)
        if not np.all(probe == 1.0):
            raise AssertionError("single-bank band weight != 1")

    @property
    def use_relative_scatter(self) -> bool:
        """B1 → B2 → fold (``"auto"`` on CUDA, or ``"pallas"``); else the
        plain deposits and the absolute-grid segment sum."""
        s = self.settings.scatter
        if s == "auto":
            return self.device.type == "cuda"
        return s == "pallas"

    @property
    def reach(self) -> int:
        """R: the most columns time reassignment can move energy
        (|Δt| ≤ N/2 ⇒ |δ| ≤ round(N/(2·hop)))."""
        return int(np.round(self.n_max / (2.0 * self.hop)))

    # ---------------- params ----------------
    def params(self, settings: Settings | None = None) -> PipelineParams:
        """The continuous-param tuple (cheap; call on slider moves)."""
        s = settings or self.settings
        row_freqs = self.row_freqs
        if s.freq_scale != self.settings.freq_scale:
            row_freqs = log_freq_axis(self.rows, s.freq_min,
                                      s.sample_rate / 2.0, s.freq_scale)
        a, b = row_map_consts(row_freqs, self.rows)
        dev = self.device
        scalar = lambda v: torch.tensor(np.float32(v), device=dev)
        return PipelineParams(
            post=PostParams.from_settings(s, row_freqs, dev),
            lut=torch.from_numpy(lut(s.colormap).copy()).to(dev),
            logmap_a=scalar(a), logmap_b=scalar(b),
            power_floor=scalar(10.0 ** (s.reassign_floor_db / 10.0)),
        )

    # ---------------- analysis ----------------
    def _deposits(self, frames, p: PipelineParams):
        """Plain deposits (row, δ, contrib), each (..., N/2+1)."""
        return deposits_plain(frames, p.logmap_a, p.logmap_b, p.power_floor,
                              n=self.n_max, hop=self.hop,
                              sr=float(self.settings.sample_rate),
                              rows=self.rows)

    def _deposit_ids_rel(self, frames, p: PipelineParams):
        """Relative-histogram inputs (ids = (δ+R)·rows + row, contrib):
        kernel B1 for a CUDA tensor, its plain version on the CPU."""
        return deposits_ids(frames, p.logmap_a, p.logmap_b, p.power_floor,
                            n=self.n_max, hop=self.hop,
                            sr=float(self.settings.sample_rate),
                            rows=self.rows, reach=self.reach)

    def _scatter_segment_sum(self, rows_i, delta, contrib, t_count, lead):
        """Absolute (t, rows) grid, one flattened segment sum per lead row;
        each cell adds its deposits in (frame, bin) order."""
        t_idx = torch.arange(t_count, dtype=torch.int32,
                             device=contrib.device)[:, None]
        col = t_idx + delta
        ids = torch.where((col >= 0) & (col < t_count),
                          col * self.rows + rows_i, -1)
        out = histogram_plain(ids.reshape(lead + (-1,)),
                              contrib.reshape(lead + (-1,)),
                              t_count * self.rows)
        return out.reshape(lead + (t_count, self.rows))

    def _scatter_relative(self, ids_rel, contrib, t_count):
        """Per-frame relative histograms (B2) + the static shift-add fold
        out[u] = Σ_δ hist[u−δ, δ].  Terms are added in ascending source
        frame (descending δ), the order the streaming ring accumulates
        them, so the two paths agree bit for bit where the histograms do."""
        R, rows = self.reach, self.rows
        P = 2 * R + 1
        hist = histogram(ids_rel, contrib, P * rows,
                         passes=self.settings.scatter_passes)
        hist = hist.reshape(hist.shape[:-1] + (P, rows)).movedim(-3, 0)
        pad = hist.new_zeros((R,) + hist.shape[1:])
        hp = torch.cat([pad, hist, pad])                     # (t+2R, ..., P, rows)
        out = None
        for j in reversed(range(P)):
            term = hp[2 * R - j:2 * R - j + t_count, ..., j, :]
            out = term.clone() if out is None else out + term
        return out.movedim(0, -2)                            # (..., t, rows)

    def _enhanced_power(self, x, t_count, p: PipelineParams):
        """Reassigned 2-D histogram on the (t, rows) display grid."""
        frames = frame_signal(x, self.n_max, self.hop)
        if self.use_relative_scatter:
            ids_rel, contrib = self._deposit_ids_rel(frames, p)
            return self._scatter_relative(ids_rel, contrib, t_count)
        rows_i, delta, contrib = self._deposits(frames, p)
        return self._scatter_segment_sum(rows_i, delta, contrib, t_count,
                                         x.shape[:-1])

    # ---------------- full batch path ----------------
    def _batch_vis(self, x, p: PipelineParams, state: PostState,
                   t_count: int):
        power = self._enhanced_power(x, t_count, p)          # (..., t, rows)
        cols_first = power.movedim(-2, 0).contiguous()       # (t, ..., rows)
        vis, state = postprocess_batch(cols_first, state, p.post,
                                       self.settings.agc_global)
        rgba = apply_lut(vis, p.lut)                         # (t, ..., rows, 4)
        return vis, rgba, state

    def num_columns(self, num_samples: int) -> int:
        return num_frames(num_samples, self.n_max, self.hop)

    def to_device(self, x) -> torch.Tensor:
        """Audio (numpy or tensor) → float32 tensor on this device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=DTYPE)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)

    def process(self, x, params: PipelineParams | None = None,
                state: PostState | None = None):
        """Whole-signal batch processing: x (..., samples) →
        (vis (t, ..., rows), rgba uint8 (t, ..., rows, 4), final PostState)."""
        x = self.to_device(x)
        t_count = self.num_columns(x.shape[-1])
        if t_count <= 0:
            raise ValueError(
                f"need at least {self.n_max} samples, got {x.shape[-1]}")
        p = params or self.params()
        st = state or PostState.init(x.shape[:-1] + (self.rows,), self.device)
        return self._batch_vis(x, p, st, t_count)

    # ---------------- streaming path ----------------
    def _stream_step(self, carry, window, p: PipelineParams):
        """One hop: add this frame's deposits to the pending ring of
        P = 2R+1 columns, then emit column t−R (no later frame can reach
        it).  ``t`` is a host int.  The carry's ring is updated in place
        on the segment-sum route: pass each carry to one step only."""
        t, acc, post = carry                     # acc: (P, ..., rows)
        R, rows = self.reach, self.rows
        P = 2 * R + 1
        lead = window.shape[:-1]
        if self.use_relative_scatter:
            ids_rel, contrib = self._deposit_ids_rel(window, p)
            if t < R:
                # t + δ ≥ 0 ⟺ id ≥ (R − t)·rows (row < rows): drop the rest
                ids_rel = torch.where(ids_rel >= (R - t) * rows, ids_rel, -1)
            hist = histogram(ids_rel, contrib, P * rows,
                             passes=self.settings.scatter_passes)
            dep = hist.reshape(lead + (P, rows)).movedim(-2, 0)
            # slot of offset δ is (t+δ) mod P: roll by (t − R) mod P
            acc = acc + torch.roll(dep, t - R, 0)
        else:
            rows_i, delta, contrib = self._deposits(window, p)
            contrib = torch.where(t + delta >= 0, contrib,
                                  torch.zeros_like(contrib))
            slot = torch.remainder(t + delta, P).to(torch.int64)
            n_lead = acc[0].numel() // rows
            lane = (torch.arange(n_lead, device=acc.device) * rows
                    ).reshape(lead + (1,))
            flat = slot * (n_lead * rows) + lane + rows_i
            # in place, in bin order: each cell adds in the batch's order
            acc.view(-1).index_add_(0, flat.reshape(-1), contrib.reshape(-1))
        emit_slot = (t - R) % P
        if t >= R:
            vis, post = postprocess_column(acc[emit_slot], post, p.post,
                                           self.settings.agc_global)
        else:
            vis = torch.zeros(lead + (rows,), dtype=DTYPE, device=acc.device)
        rgba = apply_lut(vis, p.lut)
        acc[emit_slot] = 0.0                     # slot reused by t+R+1
        return (t + 1, acc, post), (vis, rgba, t - R)

    def _stream_step_rolling(self, carry, block, p: PipelineParams):
        """Per-hop step whose analysis window is carry state: ``block`` is
        only the ``hop`` new samples, window' = concat(window[hop:], block)."""
        window, inner = carry
        window = torch.cat([window[..., self.hop:], block], dim=-1)
        inner, out = self._stream_step(inner, window, p)
        return (window, inner), out

    def init_stream_carry(self, lead: tuple = ()):
        P = 2 * self.reach + 1
        return (0,
                torch.zeros((P,) + lead + (self.rows,), dtype=DTYPE,
                            device=self.device),
                PostState.init(lead + (self.rows,), self.device))

    def init_roll_carry(self, lead: tuple = ()):
        """Carry for :meth:`_stream_step_rolling`: (window, inner)."""
        return (torch.zeros(lead + (self.n_max,), dtype=DTYPE,
                            device=self.device),
                self.init_stream_carry(lead))


@functools.lru_cache(maxsize=32)
def _cached_pipeline(settings: Settings, device: str) -> Pipeline:
    return Pipeline(settings, device)


def _structural_projection(s: Settings) -> Settings:
    """Settings with every continuous field at its default (cache key)."""
    defaults = Settings()
    cont = {f.name: getattr(defaults, f.name)
            for f in dataclasses.fields(Settings)
            if f.name not in STRUCTURAL_FIELDS}
    return s.replace(**cont)


def get_pipeline(settings: Settings, device) -> Pipeline:
    """Pipeline cache keyed by the structural projection and the device.
    The returned ``.settings`` carries default continuous values: build
    params from YOUR settings (``pipe.params(settings)``)."""
    return _cached_pipeline(_structural_projection(settings),
                            str(as_device(device)))
