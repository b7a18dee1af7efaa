"""Pipeline: settings → hop→raster functions (``emspec.pipeline``).

Ported paths, in batch (``process``) and per hop (``_stream_step``):

* **enhanced, one bank, stencil method** (the main path):
  frames → deposits (kernel B1, ``dsp.kernels.deposits``) → relative
  histogram (kernel B2, ``dsp.kernels.scatter``) → static shift-add fold
  (batch) / roll into the pending ring (stream) → post chain
  (``post.chain``) → colormap (kernel B3).
* **enhanced, one bank, direct method**: frames → triple windowing
  (kernel B5, ``dsp.kernels.window``) → three real FFTs (``torch.fft`` or
  the four-step engine, kernel B4) → corrections → quantize → B2 → fold →
  post → B3.
* **natural, one bank or the multires banks**: per-bank Hann |X|² with
  the non-finite scrub (``torch.fft`` or the four-step engine, B4) →
  gather/lerp merge onto the log rows (``dsp.multires``) → post → B3.

``fft_impl="auto"`` resolves to ``"xla"`` (``torch.fft``) on every device
(see ``Pipeline.fft_impl``).  ``scatter="auto"`` takes the relative
histogram (B2) on CUDA and the absolute-grid ``segment_sum``
(``index_add_``) on the CPU; both stay selectable (``"pallas"`` is the
JAX package's name for the relative-histogram route).  Kernel wrappers
route by tensor device: on the CPU the same calls run their plain
PyTorch versions.  With the stencil method the card always takes the
fused kernel B1, whatever ``fft_impl`` says, as the JAX package's
``_use_fused_deposits`` does on its accelerator; the CPU runs the
engine's unfused chain, as the JAX package does on its CPU.

The stencil method runs at every size of ``FFT_SIZES``: on the card B1
takes N ≤ 16384 in one block a frame, N = 32768 in a two-CTA cluster a
frame, and larger frames through its large-frame route (pack → B4 →
finish).  B2 takes every relative space (2R+1)·rows, above a block's
shared memory too.  Enhanced multires raises ``NotImplementedError`` on
every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from emspec_torch.config import MODE_ENHANCED, STRUCTURAL_FIELDS, Settings
from emspec_torch.device import DTYPE, as_device
from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import frame_signal, num_frames
from emspec_torch.dsp.kernels.deposits import deposits_ids, quantize_deposits
from emspec_torch.dsp.kernels.scatter import histogram, histogram_plain
from emspec_torch.dsp.kernels.window import windowed_frames
from emspec_torch.dsp.multires import (
    MergeTables, band_support_hz, band_weight_at, bank_offsets,
    build_merge_tables, merge_columns)
from emspec_torch.dsp.reassign import reassignment_corrections
from emspec_torch.dsp.stft import rfft, stft_triple_stencil
from emspec_torch.dsp.windows import hann
from emspec_torch.post.chain import (
    PostParams, PostState, postprocess_batch, postprocess_column)
from emspec_torch.post.colormap import apply_lut
from emspec_torch.tables import lut, row_map_consts


class PipelineParams(NamedTuple):
    """Everything continuous, as tensors on the pipeline's device:
    swapping any of them (slider moves, colormap change, Freq-Scale zoom)
    re-uses the same code with no host sync."""
    post: PostParams
    lut: torch.Tensor          # (256, 4) uint8
    logmap_a: torch.Tensor     # 0-d: row = (log2 f − a)·b
    logmap_b: torch.Tensor     # 0-d
    power_floor: torch.Tensor  # 0-d: drop |X_h|² at or below this
    # natural-mode merge tables and enhanced band weights, per bank
    i0: tuple                  # (rows,) int32 lower bin index
    w0: tuple                  # (rows,) float32 lower bin weight
    band_rows: tuple           # (rows,) float32 band weight per row
    band_bins: tuple           # (K_b,) float32 band weight per source bin


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to emspec_torch yet (ROADMAP.md, 'Modules "
        f"still to port'); use the emspec package")


class Pipeline:
    """Analysis + display pipeline for one structural configuration on one
    device (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, settings: Settings, device="cuda"):
        s = settings
        enhanced = s.mode == MODE_ENHANCED
        if enhanced and s.multires:
            raise _not_ported("enhanced multires (mode='enhanced', "
                              "multires=True)")
        self.settings = s
        self.device = as_device(device)
        self.sizes = s.active_fft_sizes
        self.hop = s.hop_samples
        self.offsets = bank_offsets(self.sizes)
        self.n_max = max(self.sizes)
        self.rows = s.raster_height
        self.tables = build_merge_tables(
            self.sizes, s.sample_rate, self.rows, s.freq_min, s.freq_scale,
            s.crossover_low, s.crossover_high)
        self.row_freqs = self.tables.row_freqs
        # per-bank bin range with nonzero band weight (the enhanced
        # deposits' band weights are evaluated on it)
        self.k_slices = []
        n_banks = len(self.sizes)
        for b, n in enumerate(self.sizes):
            k_count = n // 2 + 1
            if n_banks == 1:
                self.k_slices.append((0, k_count))
                continue
            lo_hz, hi_hz = band_support_hz(
                b, n_banks, s.crossover_low, s.crossover_high,
                s.sample_rate / 2.0)
            bin_hz = s.sample_rate / n
            self.k_slices.append(
                (max(int(np.floor(lo_hz / bin_hz)) - 1, 0),
                 min(int(np.ceil(hi_hz / bin_hz)) + 2, k_count)))
        if n_banks == 1:
            # kernel B1 carries no band weight: the single-bank weight is 1
            probe = band_weight_at(np.linspace(1.0, s.sample_rate / 2.0, 64),
                                   0, 1, s.crossover_low, s.crossover_high)
            if not np.all(probe == 1.0):
                raise AssertionError("single-bank band weight != 1")
        self.fft_impl                      # raises on an unsupported size

    @property
    def fft_impl(self) -> str:
        """Resolved FFT engine, ``"fourstep"`` or ``"xla"`` (``torch.fft``).

        ``"auto"`` resolves to ``"xla"`` on every device: the JAX
        package's auto policy (four-step for enhanced single-bank on its
        accelerator, ``pipeline.py:195-223``) is a TPU measurement and is
        not carried over.  So kernel B4 runs where the caller selects
        ``fft_impl="fourstep"``, as on the TPU."""
        s = self.settings.fft_impl
        if s == "auto":
            return "xla"
        if s == "fourstep" and not all(fourstep.supported(n)
                                       for n in self.sizes):
            raise ValueError(
                f"fourstep FFT unsupported for sizes {self.sizes}")
        return s

    @property
    def use_fused_deposits(self) -> bool:
        """Kernel B1 for the stencil method's deposits: on the card, for
        either engine (the JAX package fuses on its accelerator); the CPU
        runs the engine's unfused chain."""
        return (self.settings.fft_method == "stencil"
                and self.device.type == "cuda")

    @property
    def use_relative_scatter(self) -> bool:
        """Deposit ids → B2 → fold (``"auto"`` on CUDA, at every relative
        space, or ``"pallas"``); else the absolute-grid segment sum."""
        s = self.settings.scatter
        if s == "auto":
            return self.device.type == "cuda"
        return s == "pallas"

    @property
    def reach(self) -> int:
        """R: the most columns time reassignment can move energy
        (|Δt| ≤ N/2 ⇒ |δ| ≤ round(N/(2·hop))); natural mode moves none."""
        if self.settings.mode != MODE_ENHANCED:
            return 0
        return max(int(np.round(n / (2.0 * self.hop))) for n in self.sizes)

    # ---------------- params ----------------
    def params(self, settings: Settings | None = None) -> PipelineParams:
        """The continuous-param tuple (cheap; call on slider moves)."""
        s = settings or self.settings
        tables = self.tables
        if s.freq_scale != self.settings.freq_scale:
            tables = build_merge_tables(
                self.sizes, s.sample_rate, self.rows, s.freq_min,
                s.freq_scale, s.crossover_low, s.crossover_high)
        a, b = row_map_consts(tables.row_freqs, self.rows)
        dev = self.device
        scalar = lambda v: torch.tensor(np.float32(v), device=dev)
        per_bank = lambda arrays: tuple(torch.from_numpy(v).to(dev)
                                        for v in arrays)
        n_banks = len(self.sizes)
        band_bins = [band_weight_at(
            np.arange(k_lo, k_hi) * (s.sample_rate / n), bank, n_banks,
            s.crossover_low, s.crossover_high).astype(np.float32)
            for bank, (n, (k_lo, k_hi)) in enumerate(zip(self.sizes,
                                                          self.k_slices))]
        return PipelineParams(
            post=PostParams.from_settings(s, tables.row_freqs, dev),
            lut=torch.from_numpy(lut(s.colormap).copy()).to(dev),
            logmap_a=scalar(a), logmap_b=scalar(b),
            power_floor=scalar(10.0 ** (s.reassign_floor_db / 10.0)),
            i0=per_bank(tables.i0), w0=per_bank(tables.w0),
            band_rows=per_bank(tables.band_w), band_bins=per_bank(band_bins),
        )

    # ---------------- analysis ----------------
    def _bank_frames(self, x, t_count: int) -> list:
        """Center-aligned per-bank frames: bank b frame t covers
        [offset_b + t·hop, … + N_b), so all banks share column centers."""
        out = []
        for n, off in zip(self.sizes, self.offsets):
            end = off + (t_count - 1) * self.hop + n
            out.append(frame_signal(x[..., off:end], n, self.hop))
        return out

    def _bank_windows(self, window) -> list:
        """One analysis window (..., N_max) → per-bank slices (..., N_b)."""
        return [window[..., off:off + n]
                for n, off in zip(self.sizes, self.offsets)]

    def _rfft(self, x):
        if self.fft_impl == "fourstep":
            return fourstep.rfft_fourstep(x)
        return rfft(x)

    def _bank_power(self, frames, n: int):
        """Hann |X|² of one bank's frames or window — shared by the batch
        and streaming natural paths.  Non-finite power is zeroed: one
        NaN/Inf sample would otherwise NaN its frame's spectrum and, via
        ``peak_db``, poison the AGC reference for good; for finite input
        the ``where`` is an exact identity (``pipeline.py:288-313``)."""
        X = self._rfft(frames * _hann(n, str(frames.device)))
        power = X.real * X.real + X.imag * X.imag
        return torch.where(torch.isfinite(power), power,
                           torch.zeros_like(power))

    def _merge(self, specs, p: PipelineParams):
        return merge_columns(specs, MergeTables(
            self.row_freqs, p.i0, p.w0, p.band_rows))

    def _natural_power(self, x, t_count: int, p: PipelineParams):
        specs = [self._bank_power(frames, n) for frames, n in
                 zip(self._bank_frames(x, t_count), self.sizes)]
        return self._merge(specs, p)                          # (..., t, rows)

    def _spectra(self, frames):
        """(X_h, X_th, X_dh) of one bank's frames by the chosen method."""
        if self.settings.fft_method == "stencil":
            return stft_triple_stencil(frames, self.fft_impl)
        Xs = self._rfft(windowed_frames(frames))    # B5 on the card
        return Xs[0], Xs[1], Xs[2]

    def _deposits(self, frames, p: PipelineParams):
        """Unfused single-bank deposits (row, δ, contrib), (..., N/2+1)."""
        return quantize_deposits(
            *reassignment_corrections(*self._spectra(frames)), p.logmap_a,
            p.logmap_b, p.power_floor, n=self.n_max, hop=self.hop,
            sr=float(self.settings.sample_rate), rows=self.rows,
            band=p.band_bins[0])

    def _deposit_ids_rel(self, frames, p: PipelineParams):
        """Relative-histogram inputs (ids = (δ+R)·rows + row, contrib):
        kernel B1 where ``use_fused_deposits``, else the unfused chain."""
        if self.use_fused_deposits:
            return deposits_ids(frames, p.logmap_a, p.logmap_b,
                                p.power_floor, n=self.n_max, hop=self.hop,
                                sr=float(self.settings.sample_rate),
                                rows=self.rows, reach=self.reach)
        rows_i, delta, contrib = self._deposits(frames, p)
        return (delta + self.reach) * self.rows + rows_i, contrib

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
        power = (self._enhanced_power(x, t_count, p)
                 if self.settings.mode == MODE_ENHANCED
                 else self._natural_power(x, t_count, p))    # (..., t, rows)
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
        """One hop: add this frame's deposits (enhanced) or its merged
        column (natural, R = 0) to the pending ring of P = 2R+1 columns,
        then emit column t−R (no later frame can reach it).

        ``t`` is a 0-d int32 tensor on the pipeline's device, as in the
        JAX step: no Python branch or host read touches it, so one hop is
        a fixed sequence of launches that a CUDA graph can capture
        (``stream.Stream``).  Every carry tensor (t, the ring, the post
        state) is updated in place and returned: pass each carry to one
        step only."""
        t, acc, post = carry                     # acc: (P, ..., rows)
        R, rows = self.reach, self.rows
        P = 2 * R + 1
        lead = window.shape[:-1]
        t_emit = t - R                           # the column this hop emits
        if self.settings.mode != MODE_ENHANCED:
            specs = [self._bank_power(win, n) for win, n in
                     zip(self._bank_windows(window), self.sizes)]
            col = self._merge(specs, p)
            acc.index_add_(0, _slot(t, P), col.unsqueeze(0))
        elif self.use_relative_scatter:
            ids_rel, contrib = self._deposit_ids_rel(window, p)
            # t + δ ≥ 0 ⟺ id ≥ (R − t)·rows (row < rows): drop the rest
            # (an identity from t = R on: ids below 0 add nothing anyway)
            min_id = torch.clamp(R - t, min=0) * rows
            ids_rel = torch.where(ids_rel >= min_id, ids_rel, -1)
            hist = histogram(ids_rel, contrib, P * rows,
                             passes=self.settings.scatter_passes)
            dep = hist.reshape(lead + (P, rows)).movedim(-2, 0)
            # slot of offset δ is (t+δ) mod P: roll by (t − R) mod P, as
            # a gather (pure data movement, bit-exact)
            src = torch.remainder(
                torch.arange(P, device=acc.device) - t_emit, P)
            acc.add_(torch.index_select(dep, 0, src))
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
        # the chain always runs; its result is kept from t = R on
        emit_slot = _slot(t_emit, P)
        vis, new_post = postprocess_column(acc.index_select(0, emit_slot)[0],
                                           post, p.post,
                                           self.settings.agc_global)
        do_emit = t >= R
        for old, new in zip(post, new_post):
            torch.where(do_emit, new, old, out=old)
        vis = torch.where(do_emit, vis, 0.0)
        rgba = apply_lut(vis, p.lut)
        acc.index_fill_(0, emit_slot, 0.0)       # slot reused by t+R+1
        t.add_(1)
        return (t, acc, post), (vis, rgba, t_emit)

    def _stream_step_rolling(self, carry, block, p: PipelineParams):
        """Per-hop step whose analysis window is carry state: ``block`` is
        only the ``hop`` new samples, window' = concat(window[hop:], block),
        written into the carry's own window tensor."""
        window, inner = carry
        window.copy_(torch.cat([window[..., self.hop:], block], dim=-1))
        inner, out = self._stream_step(inner, window, p)
        return (window, inner), out

    def init_stream_carry(self, lead: tuple = ()):
        P = 2 * self.reach + 1
        return (torch.zeros((), dtype=torch.int32, device=self.device),
                torch.zeros((P,) + lead + (self.rows,), dtype=DTYPE,
                            device=self.device),
                PostState.init(lead + (self.rows,), self.device))

    def init_roll_carry(self, lead: tuple = ()):
        """Carry for :meth:`_stream_step_rolling`: (window of ``n_max``
        samples, the largest bank's, inner)."""
        return (torch.zeros(lead + (self.n_max,), dtype=DTYPE,
                            device=self.device),
                self.init_stream_carry(lead))


def _slot(t: torch.Tensor, P: int) -> torch.Tensor:
    """Ring slot ``t mod P`` of a 0-d device counter, as a (1,) int64
    index on its device."""
    return torch.remainder(t, P).to(torch.int64).reshape(1)


@functools.lru_cache(maxsize=None)
def _hann(n: int, device: str) -> torch.Tensor:
    """float32 periodic Hann (``emspec.dsp.windows.hann``)."""
    return torch.from_numpy(hann(n)).to(device)


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


def get_pipeline(settings: Settings, device="cuda") -> Pipeline:
    """Pipeline cache keyed by the structural projection and the device.
    The returned ``.settings`` carries default continuous values: build
    params from YOUR settings (``pipe.params(settings)``)."""
    return _cached_pipeline(_structural_projection(settings),
                            str(as_device(device)))
