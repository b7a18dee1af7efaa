"""Pipeline: settings → hop→raster functions (``emspec.pipeline``).

Ported paths, in batch (``process``) and per hop (``_stream_step``):

* **enhanced, stencil method**, one bank or the multires banks (the
  display default, ``Settings()``): per bank, frames → deposits of the
  bank's band-support bins with its band weight (kernel B1 with a bin
  window, ``dsp.kernels.deposits``) → one id space for all banks →
  histogram (kernel B2, ``dsp.kernels.scatter``) → post chain
  (``post.chain``) → colormap (kernel B3).  The batch path sums the
  histogram per frame and folds it (relative), or straight into the
  (t, rows) grid (absolute); the live step rolls a relative histogram
  into its pending ring.
* **enhanced, direct method**: frames → triple windowing (kernel B5,
  ``dsp.kernels.window``) → three real FFTs (the port's real FFT kernel,
  ``dsp.kernels.rfft``, or the four-step engine, kernel B4) → the bank's
  bins → corrections → quantize → B2 → post → B3.
* **natural, one bank or the multires banks**: per-bank Hann |X|² with
  the non-finite scrub (the real FFT kernel's power form, Hann applied as
  it loads, or the four-step engine, B4) → gather/lerp merge onto the log
  rows (``dsp.multires``) → post → B3.

``fft_impl="auto"`` resolves to ``"xla"`` on every device (see
``Pipeline.fft_impl``): the port's direct real FFT — the kernel
``dsp.kernels.rfft`` on the card, ``torch.fft.rfft`` row by row on the
CPU — never cuFFT, whose bits depend on the batch.  Kernel wrappers
route by tensor device: on the CPU the same calls run their plain
PyTorch versions.  With the stencil method the card takes the fused
kernel B1 for every bank it holds (512–262144 points), whatever
``fft_impl`` says, as the JAX package's ``_use_fused_deposits`` does on
its accelerator; a bank of 256 points runs the unfused chain (routing by
size only), its two spectra through the real FFT kernel.  The JAX
package's pruned-DFT product for long banks (``_use_pruned_dft``) is
not routed: on an H100 it lost to B1's windowed form at every default
bank (PERF.md §6); ``dsp.stft`` keeps it.  The CPU runs the engine's
unfused chain — full spectra, the bank's bins sliced out, corrections,
quantization with the band weight — as the JAX package does on its CPU.

Scatter (``Settings.scatter``): ``"pallas"`` (the JAX package's name for
the relative histogram) sums per frame into (2R+1)·rows cells and folds;
``"segment_sum"`` sums into the absolute (t, rows) grid; ``"auto"`` takes
the absolute grid on the CPU, the relative histogram for one bank on the
card, and in batch the absolute grid for several banks on the card
(``use_relative_batch``), live the relative histogram — where a caller
asks for B2's atomic routes (``exact_sums=False``).  Every sum is kernel
B2 on the card.  By default (``exact_sums=True``: ``process``,
``_batch_vis``, ``_stream_step``, and so ``stream.Stream``, the app, the
bench, the file renders and ``parallel``'s classes) every cell adds its
deposits in (frame, bin) order, the CPU's order: the batch sums into the
absolute grid through B2's sorted route bounded by the reach (its batch
form for crowded columns or its tiles form, by shape:
``scatter.sorted_form``), the live step adds each hop into its ring
through B2's ring form.  So two runs give the same bits, and the stream's
columns are the batch's bit for bit, on the card as on the CPU, at every
``fft_impl`` and in every mode (the JAX package's streaming ≡ batch):
every spectrum comes from a kernel whose arithmetic for a frame depends
on its size alone (B1, the real FFT kernel, B4).  ``exact_sums=False``
takes the atomic routes, whose float atomics add a cell's deposits in
another order each run.

``prewarm`` warms the live app's structural variants ahead of a swap
(a ``WarmHandle`` over the queued jobs, one worker thread).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from emspec_torch.config import MODE_ENHANCED, STRUCTURAL_FIELDS, Settings
from emspec_torch.device import CARD_LOCK, DTYPE, as_device
from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import frame_signal, num_frames
from emspec_torch.dsp.kernels import deposits
from emspec_torch.dsp.kernels import rfft as rfft_kernel
from emspec_torch.dsp.kernels.deposits import deposits_ids, quantize_deposits
from emspec_torch.dsp.kernels.rfft import rfft_frames, scrubbed_power
from emspec_torch.dsp.kernels.scatter import (
    SORTED, histogram, histogram_ring, sorted_form)
from emspec_torch.dsp.kernels.window import windowed_frames
from emspec_torch.dsp.multires import (
    MergeTables, band_support_hz, band_weight_at, bank_offsets,
    build_merge_tables, log_freq_axis, merge_columns)
from emspec_torch.dsp.reassign import reassignment_corrections
from emspec_torch.dsp.stft import hann_window, stft_triple_stencil
from emspec_torch.post.chain import (
    PostParams, PostState, postprocess_batch, postprocess_column)
from emspec_torch.post.colormap import apply_lut
from emspec_torch.tables import lut, row_map_consts
from emspec_torch.utils.notes import describe_frequency

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


def _cat(parts: list) -> torch.Tensor:
    """Concatenate per-bank (..., K_b) tensors along the bins."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


class Pipeline:
    """Analysis + display pipeline for one structural configuration on one
    device (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, settings: Settings, device="cuda"):
        s = settings
        self.settings = s
        self.device = as_device(device)
        self.sizes = s.active_fft_sizes
        self.hop = s.hop_samples
        self.offsets = bank_offsets(self.sizes)
        self.n_max = max(self.sizes)
        # samples the live window rolls by a hop: the hop's new samples,
        # or at a hop past the largest frame the next window alone (the
        # samples between two windows are never analysed, in batch either)
        self.roll = min(self.hop, self.n_max)
        self.rows = s.raster_height
        self.tables = build_merge_tables(
            self.sizes, s.sample_rate, self.rows, s.freq_min, s.freq_scale,
            s.crossover_low, s.crossover_high)
        self.row_freqs = self.tables.row_freqs
        # per-bank bin range with nonzero band weight: the enhanced
        # deposits are computed and weighted on it alone
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
        if self.fft_impl == "xla" and self.device.type == "cuda":
            # the card's real FFT kernel holds 256–262144 points, and from
            # 65536 up a cluster the card must hold: refuse here, not at
            # the first spectrum (no fallback to cuFFT or another route)
            rfft_kernel.require_sizes(self.sizes, "Pipeline")
            rfft_kernel.require_card(self.sizes, self.device, "Pipeline")

    @property
    def fft_impl(self) -> str:
        """Resolved FFT engine, ``"fourstep"`` or ``"xla"``.

        ``"xla"`` is the port's direct real FFT: ``torch.fft.rfft`` row by
        row on the CPU, the real FFT kernel (``dsp.kernels.rfft``) on the
        card — the JAX package's batch-shape-stable ``jnp.fft.rfft``.
        ``"auto"`` resolves to ``"xla"`` on every device: the JAX
        package's auto policy (four-step for enhanced single-bank on its
        accelerator, ``pipeline.py:195-223``) is a TPU measurement and is
        not carried over.  So kernel B4 runs where the caller selects
        ``fft_impl="fourstep"``, as on the TPU.  On every engine a
        frame's spectrum depends on its size alone, never on the batch:
        the stream's columns are ``process``'s bit for bit on the card as
        on the CPU.  A bank the card's kernels do not hold (above 262144
        points) is refused with a ValueError when the pipeline is
        built."""
        s = self.settings.fft_impl
        if s == "auto":
            return "xla"
        if s == "fourstep" and not all(fourstep.supported(n)
                                       for n in self.sizes):
            raise ValueError(
                f"fourstep FFT unsupported for sizes {self.sizes}")
        return s

    def _use_fused_deposits(self, n: int) -> bool:
        """Kernel B1 for a bank's deposits: on the card, stencil method,
        for every size B1 holds (``deposits.supported``); the CPU runs the
        engine's unfused chain."""
        return (self.settings.fft_method == "stencil"
                and self.device.type == "cuda" and deposits.supported(n))

    @property
    def use_relative_scatter(self) -> bool:
        """Per-frame relative histograms (B2) + fold in batch and the
        relative ring update live (``"auto"`` on CUDA, or ``"pallas"``);
        else the absolute-grid sum (batch) and the ring's slot ids (live)."""
        s = self.settings.scatter
        if s == "auto":
            return self.device.type == "cuda"
        return s == "pallas"

    @property
    def use_relative_batch(self) -> bool:
        """The batch path's choice: ``use_relative_scatter``, but under
        ``"auto"`` several banks take the absolute grid, one B2 over
        (t, rows): at the display default on an H100, B1 included, it
        ran 4.6× faster than the relative histogram of 65 × 512 cells and
        its fold, and as fast as the JAX package's per-bank mixed scatter
        (PERF.md §6)."""
        return self.use_relative_scatter and not (
            self.settings.scatter == "auto" and len(self.sizes) > 1)

    @property
    def reach(self) -> int:
        """R: the most columns time reassignment can move energy
        (|Δt| ≤ N/2 ⇒ |δ| ≤ round(N/(2·hop))); natural mode moves none."""
        if self.settings.mode != MODE_ENHANCED:
            return 0
        return int(np.round(self.n_max / (2.0 * self.hop)))

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
    def _bank_inputs(self, x, t_count: int) -> list:
        """Center-aligned per-bank frames (views) of the batch path: bank
        b frame t covers [offset_b + t·hop, … + N_b), so all banks share
        column centers."""
        return [frame_signal(x[..., off:off + (t_count - 1) * self.hop + n],
                             n, self.hop)
                for n, off in zip(self.sizes, self.offsets)]

    def _bank_windows(self, window) -> list:
        """One analysis window (..., N_max) → per-bank slices (..., N_b)."""
        return [window[..., off:off + n]
                for n, off in zip(self.sizes, self.offsets)]

    def _rfft(self, x):
        if self.fft_impl == "fourstep":
            return fourstep.rfft_fourstep(x)
        return rfft_frames(x)

    def _bank_power(self, frames, n: int):
        """Hann |X|² of one bank's frames or window — shared by the batch
        and streaming natural paths.  Non-finite power is zeroed: one
        NaN/Inf sample would otherwise NaN its frame's spectrum and, via
        ``peak_db``, poison the AGC reference for good; for finite input
        the ``where`` is an exact identity (``pipeline.py:288-313``).  On
        the ``xla`` engine one call of the real FFT kernel's power form
        (Hann applied as the samples load, the scrub in its store)."""
        hann = hann_window(n, frames.device)
        if self.fft_impl == "fourstep":
            return scrubbed_power(fourstep.rfft_fourstep(frames * hann))
        return rfft_frames(frames, hann, power=True)

    def _merge(self, specs, p: PipelineParams):
        return merge_columns(specs, MergeTables(
            self.row_freqs, p.i0, p.w0, p.band_rows))

    def _natural_power(self, x, t_count: int, p: PipelineParams):
        specs = [self._bank_power(frames, n) for frames, n in
                 zip(self._bank_inputs(x, t_count), self.sizes)]
        return self._merge(specs, p)                          # (..., t, rows)

    def _bank_spectra(self, frames, bank: int):
        """(X_h, X_th, X_dh) of one bank on its bins [k_lo, k_hi): the
        chosen method's whole spectra, sliced (``pipeline.py:380-408``)."""
        k_lo, k_hi = self.k_slices[bank]
        if self.settings.fft_method == "stencil":
            X = stft_triple_stencil(frames, self.fft_impl)
        else:
            X = self._rfft(windowed_frames(frames))    # B5 on the card
        return tuple(a[..., k_lo:k_hi] for a in X)

    def _bank_deposits(self, frames, bank: int, p: PipelineParams):
        """Unfused deposits (row, δ, contrib) of one bank, each (..., K_b),
        contrib weighted by the bank's band (``_deposits_banked``)."""
        return quantize_deposits(
            *reassignment_corrections(*self._bank_spectra(frames, bank)),
            p.logmap_a, p.logmap_b, p.power_floor, n=self.sizes[bank],
            hop=self.hop, sr=float(self.settings.sample_rate),
            rows=self.rows, band=p.band_bins[bank],
            k_lo=self.k_slices[bank][0])

    def _bank_ids(self, inputs, p: PipelineParams, reaches) -> list:
        """Per bank (ids = (δ + R_b)·rows + row, contrib), each (..., K_b),
        with ``reaches[b]`` as R_b: kernel B1 with the bank's bin window
        and band weight where ``_use_fused_deposits``, else the unfused
        chain.  One bank's band weight is identically 1 (a partition of
        unity with one part), so it takes B1's whole-spectrum form."""
        out = []
        multibank = len(self.sizes) > 1
        for b, (f, n, R) in enumerate(zip(inputs, self.sizes, reaches)):
            if self._use_fused_deposits(n):
                k_lo, k_hi = self.k_slices[b]
                out.append(deposits_ids(
                    f, p.logmap_a, p.logmap_b, p.power_floor, n=n,
                    hop=self.hop, sr=float(self.settings.sample_rate),
                    rows=self.rows, reach=R, k_lo=k_lo, k_hi=k_hi,
                    band=p.band_bins[b] if multibank else None))
            else:
                row, delta, contrib = self._bank_deposits(f, b, p)
                out.append(((delta + R) * self.rows + row, contrib))
        return out

    def _deposit_ids_rel(self, inputs, p: PipelineParams):
        """Relative-histogram inputs of all banks, (ids = (δ+R)·rows +
        row, contrib) each (..., ΣK_b), with the pipeline's reach R."""
        ids, contrib = zip(*self._bank_ids(inputs, p,
                                           [self.reach] * len(self.sizes)))
        return _cat(list(ids)), _cat(list(contrib))

    def check_grid(self, t_count: int) -> None:
        """Raise a ValueError where the enhanced absolute grid of
        ``t_count`` columns would hold 2^31 cells a lane or more: its ids
        (t + δ)·rows + row are int32 (as in the JAX package), and would
        wrap.  Wide (8192 at hop 64) with 4,096 rows reaches it at 11.7
        minutes of 48 kHz audio."""
        if self.settings.mode == MODE_ENHANCED \
                and t_count * self.rows >= 2**31:
            raise ValueError(
                f"{t_count} columns of {self.rows} rows are "
                f"{t_count * self.rows} cells a channel: the enhanced grid "
                f"holds fewer than 2**31 (its ids are int32); render a "
                f"shorter span or fewer rows")

    def _absolute_ids(self, ids_rel, t_count: int, R: int):
        """Relative ids (δ + R)·rows + row of frames 0 … t_count−1, (...,
        t, K) → absolute-grid ids (t + δ)·rows + row.  A negative relative
        id (B1's invalid deposit) stays −1; a column outside [0, t_count)
        falls outside the grid, where the sum drops it.  Raises where the
        grid has 2^31 cells or more (``check_grid``)."""
        self.check_grid(t_count)
        base = ((torch.arange(t_count, dtype=torch.int32,
                              device=ids_rel.device) - R) * self.rows)
        return torch.where(ids_rel >= 0, ids_rel + base[:, None], -1)

    def _scatter_absolute(self, ids_abs, contrib, t_count: int,
                          exact: bool = False):
        """One sum (B2 on the card) of each lead row's deposits into its
        absolute (t, rows) grid; on the CPU each cell adds its deposits in
        (frame, bin) order, as the live step's ring does.  ``exact``: on
        the card too, through B2's sorted route with its bound (frame s's
        deposits land in columns s − R … s + R) — in its batch or tiles
        form, by shape (``scatter.sorted_form``) — so the sums are the
        same on every run."""
        lead = ids_abs.shape[:-2]
        k = ids_abs.shape[-1]
        bound = {}
        if exact:
            bound = dict(route=SORTED, reach=self.reach, frame_len=k,
                         column_len=self.rows, form=sorted_form(
                             t_count, k, self.reach, self.rows,
                             math.prod(lead)))
        out = histogram(ids_abs.reshape(lead + (-1,)),
                        contrib.reshape(lead + (-1,)), t_count * self.rows,
                        passes=self.settings.scatter_passes, **bound)
        return out.reshape(lead + (t_count, self.rows))

    def _scatter_relative(self, ids_rel, contrib, t_count, R=None):
        """Per-frame relative histograms (B2) + the static shift-add fold
        out[u] = Σ_δ hist[u−δ, δ], R defaulting to the pipeline's reach.
        Terms are added in ascending source frame (descending δ), the
        order the streaming ring accumulates them, so the two paths agree
        bit for bit where the histograms do."""
        R = self.reach if R is None else R
        rows = self.rows
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

    def _enhanced_power(self, x, t_count, p: PipelineParams,
                        frame_valid=None, exact_sums: bool = True):
        """Reassigned 2-D histogram on the (t, rows) display grid.

        ``frame_valid``: an optional (t,) mask; the deposits of a frame
        where it is 0 are dropped.  A time-sharded render
        (``parallel.TimeParallelRenderer``) analyses halo frames past the
        signal's frame range to recompute the deposits that cross its
        chunk's edges, and a trailing partial frame, which the whole
        batch never analyses, must not deposit.  ``exact_sums`` (the
        default): the absolute grid through B2's sorted route whatever
        the scatter setting (``process``); False: the scatter setting's
        route, B2's atomic ones on the card."""
        ids_rel, contrib = self._deposit_ids_rel(
            self._bank_inputs(x, t_count), p)
        if frame_valid is not None:
            ids_rel = torch.where(frame_valid[:, None] > 0, ids_rel, -1)
        if self.use_relative_batch and not exact_sums:
            return self._scatter_relative(ids_rel, contrib, t_count)
        return self._scatter_absolute(
            self._absolute_ids(ids_rel, t_count, self.reach), contrib,
            t_count, exact=exact_sums)

    # ---------------- full batch path ----------------
    def _batch_vis(self, x, p: PipelineParams, state: PostState,
                   t_count: int, peak_reduce=None, exact_sums: bool = True):
        """``peak_reduce``: the global AGC's peak across channel shards
        (``post.chain._couple``); ``exact_sums``: as in ``process``."""
        power = (self._enhanced_power(x, t_count, p, exact_sums=exact_sums)
                 if self.settings.mode == MODE_ENHANCED
                 else self._natural_power(x, t_count, p))    # (..., t, rows)
        cols_first = power.movedim(-2, 0).contiguous()       # (t, ..., rows)
        vis, state = postprocess_batch(cols_first, state, p.post,
                                       self.settings.agc_global,
                                       peak_reduce=peak_reduce)
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

    # ---------------- hover readout ----------------
    def _axis(self, freq_scale: float | None) -> np.ndarray:
        """Row-frequency axis at the zoom ``freq_scale`` (a continuous
        slider: pass the current value; ``self.row_freqs`` is the zoom the
        pipeline was built with)."""
        if freq_scale is None or freq_scale == self.settings.freq_scale:
            return self.row_freqs
        s = self.settings
        return log_freq_axis(self.rows, s.freq_min, s.sample_rate / 2.0,
                             freq_scale)

    def frequency_at_row(self, row: int,
                         freq_scale: float | None = None) -> float:
        """Display row (0 = bottom, bass) → its center frequency in Hz."""
        return float(self._axis(freq_scale)[row])

    def row_of_frequency(self, freq_hz: float,
                         freq_scale: float | None = None) -> int:
        """Nearest display row of a frequency (the hover's inverse map)."""
        f = self._axis(freq_scale)
        r = (np.log2(max(freq_hz, 1e-9)) - np.log2(f[0])) \
            / (np.log2(f[-1]) - np.log2(f[0])) * (self.rows - 1)
        return int(np.clip(round(r), 0, self.rows - 1))

    def describe_row(self, row: int, freq_scale: float | None = None) -> str:
        """The hover tooltip of a display row: frequency and note."""
        return describe_frequency(self.frequency_at_row(row, freq_scale))

    def process(self, x, params: PipelineParams | None = None,
                state: PostState | None = None, *, exact_sums: bool = True):
        """Whole-signal batch processing: x (..., samples) →
        (vis (t, ..., rows), rgba uint8 (t, ..., rows, 4), final PostState).

        ``exact_sums`` (the default): the enhanced grid's cells add their
        deposits in (frame, bin) order on every device (the absolute grid,
        B2's sorted route on the card), so two runs give the same bits and
        a stream's columns equal these bit for bit; False takes B2's
        atomic routes on the card (another last bit each run).  Raises a
        ValueError before any work where the enhanced grid would hold
        2^31 cells a channel or more (``check_grid``)."""
        t_count = self.num_columns(x.shape[-1])
        if t_count <= 0:
            raise ValueError(
                f"need at least {self.n_max} samples, got {x.shape[-1]}")
        self.check_grid(t_count)
        x = self.to_device(x)
        p = params or self.params()
        st = state or PostState.init(x.shape[:-1] + (self.rows,), self.device)
        return self._batch_vis(x, p, st, t_count, exact_sums=exact_sums)

    # ---------------- streaming path ----------------
    def _stream_step(self, carry, window, p: PipelineParams,
                     peak_reduce=None, exact_sums: bool = True):
        """One hop: add this frame's deposits (enhanced) or its merged
        column (natural, R = 0) to the pending ring of P = 2R+1 columns,
        then emit column t−R (no later frame can reach it).

        ``t`` is a 0-d int32 tensor on the pipeline's device, as in the
        JAX step: no Python branch or host read touches it, so one hop is
        a fixed sequence of launches that a CUDA graph can capture
        (``stream.Stream``).  Every carry tensor (t, the ring, the post
        state) is updated in place and returned: pass each carry to one
        step only.  ``peak_reduce``: as in :meth:`_batch_vis`.
        ``exact_sums`` (the default): the frame's deposits go into the
        ring through B2's ring form whatever the scatter setting (each
        cell adding them in bin order onto its value, so a column sums its
        deposits in the batch's (frame, bin) order: ``process``'s
        columns); the kernel computes the ring ids from the relative ids
        and ``t`` itself, one launch after B1.  False: the scatter
        setting's route (B2's atomic ones on the card)."""
        t, acc, post = carry                     # acc: (P, ..., rows)
        R, rows = self.reach, self.rows
        P = 2 * R + 1
        lead = window.shape[:-1]
        t_emit = t - R                           # the column this hop emits
        if self.settings.mode != MODE_ENHANCED:
            specs = [self._bank_power(win, n) for win, n in
                     zip(self._bank_windows(window), self.sizes)]
            col = self._merge(specs, p)
            _ring_add(acc, _slot(t, P), col.unsqueeze(0))
        elif self.use_relative_scatter and not exact_sums:
            ids_rel, contrib = self._deposit_ids_rel(
                self._bank_windows(window), p)
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
        elif exact_sums:
            ids_rel, contrib = self._deposit_ids_rel(
                self._bank_windows(window), p)
            # each lane's ring cells, each adding in bin order (B2's ring
            # form on the card: the ring ids computed in the kernel)
            histogram_ring(ids_rel, contrib, acc, t)
        else:
            ids_rel, contrib = self._deposit_ids_rel(
                self._bank_windows(window), p)
            # id = (δ + R)·rows + row; an id below 0 (B1's invalid
            # deposit) and a column t + δ below 0 are dropped
            delta = torch.div(ids_rel, rows, rounding_mode="floor") - R
            slot = torch.remainder(t + delta, P)
            n_lead = acc[0].numel() // rows
            lane = (torch.arange(n_lead, dtype=torch.int32,
                                 device=acc.device) * rows
                    ).reshape(lead + (1,))
            flat = slot * (n_lead * rows) + lane + torch.remainder(
                ids_rel, rows)
            flat = torch.where((ids_rel >= 0) & (t + delta >= 0), flat, -1)
            # added into the ring in place (B2 on the card), in bin order
            # on the CPU: each cell adds in the batch's order
            histogram(flat.reshape(-1), contrib.reshape(-1), acc.numel(),
                      out=acc.view(-1))
        # the chain always runs; its result is kept from t = R on
        emit_slot = _slot(t_emit, P)
        vis, new_post = postprocess_column(acc.index_select(0, emit_slot)[0],
                                           post, p.post,
                                           self.settings.agc_global,
                                           peak_reduce)
        do_emit = t >= R
        for old, new in zip(post, new_post):
            torch.where(do_emit, new, old, out=old)
        vis = torch.where(do_emit, vis, 0.0)
        rgba = apply_lut(vis, p.lut)
        acc.index_fill_(0, emit_slot, 0.0)       # slot reused by t+R+1
        t.add_(1)
        return (t, acc, post), (vis, rgba, t_emit)

    def _stream_step_rolling(self, carry, block, p: PipelineParams,
                             peak_reduce=None, exact_sums: bool = True):
        """Per-hop step whose analysis window is carry state: ``block`` is
        only the ``roll`` = min(hop, n_max) new samples, window' =
        concat(window[roll:], block), written into the carry's own window
        tensor."""
        window, inner = carry
        window.copy_(torch.cat([window[..., self.roll:], block], dim=-1))
        inner, out = self._stream_step(inner, window, p, peak_reduce,
                                       exact_sums)
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


def _ring_add(acc: torch.Tensor, slot: torch.Tensor,
              rows: torch.Tensor) -> None:
    """``acc[slot] += rows`` in place, one add a cell.  On the CPU this is
    the serial accumulating ``index_put_``: ``index_add_`` of a row into a
    2-D ring starts every intra-op thread for a few hundred floats, and
    with other processes on the host's cores a hop then waits ~140 ms for
    its threads (PERF.md §6).  The card keeps ``index_add_``."""
    if acc.device.type == "cpu":
        acc.index_put_((slot,), rows, accumulate=True)
    else:
        acc.index_add_(0, slot, rows)


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


class WarmHandle:
    """Handle over the queued per-variant warm jobs.  ``cancel()`` drops
    every variant that has not started yet, so an app quitting mid-warm
    does not hold interpreter exit behind the rest of the dropdown (one
    job in flight still finishes; the executor's exit join waits only for
    that)."""

    def __init__(self, futures):
        self.futures = list(futures)

    def result(self, timeout: float | None = None):
        import time as _time
        deadline = None if timeout is None else _time.monotonic() + timeout
        for f in self.futures:
            left = (None if deadline is None
                    else max(0.0, deadline - _time.monotonic()))
            f.result(left)

    def done(self) -> bool:
        return all(f.done() for f in self.futures)

    def cancel(self) -> None:
        for f in self.futures:
            f.cancel()


def prewarm(base: Settings, sizes: tuple | None = None,
            background: bool = True, device="cuda"):
    """Warm every FFT size of the dropdown so a size change stalls the
    live display as little as it can (``emspec.pipeline.prewarm``).

    Warms the single-bank variant for each ``size`` plus, for a multires
    ``base``, ``base`` itself.  Warming a variant on ``device`` builds
    the kernel library (on the card), builds its ``Pipeline`` (tables on
    the device, kept by ``get_pipeline``'s cache) and runs one eager
    ``_stream_step_rolling`` on a throwaway carry, which loads the kernel
    modules and fills the cached tables.  A graph cannot be
    captured ahead: it binds the static tensors of a ``Stream`` that does
    not exist yet, so the ``Stream`` a swap builds still runs its warm-up
    hops and captures.  Each job holds ``device.CARD_LOCK`` and runs on a
    side stream of its own, off the live stream's.  Returns a
    :class:`WarmHandle`, or None when ``background=False`` and warming
    ran inline."""
    from emspec_torch.config import FFT_SIZES

    dev = as_device(device)
    sizes = sizes or FFT_SIZES
    variants = [base.replace(multires=False, fft_size=n) for n in sizes]
    if base.multires:
        variants.append(base)

    def _warm_one(s: Settings) -> None:
        with CARD_LOCK:
            if dev.type != "cuda":
                _warm_step(s, dev)
                return
            from emspec_torch import kernels_build
            kernels_build.library()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _warm_step(s, dev)
            side.synchronize()

    if background:
        pool = _warm_pool()
        return WarmHandle([pool.submit(_warm_one, s) for s in variants])
    for s in variants:
        _warm_one(s)
    return None


def _warm_step(s: Settings, dev: torch.device) -> None:
    """One eager rolling step of ``s``'s pipeline on a throwaway carry."""
    pipe = get_pipeline(s, dev)
    lead = (s.channels,) if s.channels > 1 else ()
    carry = pipe.init_roll_carry(lead)
    block = torch.zeros(lead + (pipe.roll,), dtype=DTYPE, device=dev)
    pipe._stream_step_rolling(carry, block, pipe.params())


@functools.lru_cache(maxsize=1)
def _warm_pool():
    """One shared single-thread warmer: repeated ``prewarm`` calls queue on
    the same worker instead of each starting a thread."""
    import concurrent.futures
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="emspec_torch-prewarm")


def render_image_multires(x, settings: Settings, device="cuda") -> np.ndarray:
    """Audio → (rows, t, 4) uint8 RGBA log-frequency image, on ``device``.

    Multichannel input renders ``settings.display_channel`` (the single
    view of the app; ``render_images_channels`` gives every channel).
    The same image on every run (``process`` sums in order)."""
    pipe = get_pipeline(settings, device)
    _, rgba, _ = pipe.process(x, params=pipe.params(settings))
    img = rgba.cpu().numpy()                           # (t, [ch,] rows, 4)
    if img.ndim == 4:
        img = img[:, settings.display_channel]
    return img.transpose(1, 0, 2)[::-1]


def render_images_channels(x, settings: Settings,
                           device="cuda") -> list[np.ndarray]:
    """Multichannel audio (ch, samples) → one (rows, t, 4) log-frequency
    image per channel, from one batched pass on ``device``, the same on
    every run (``process`` sums in order)."""
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None]
    s = settings.replace(channels=x.shape[0], display_channel=0)
    pipe = get_pipeline(s, device)
    _, rgba, _ = pipe.process(x, params=pipe.params(s))
    img = rgba.cpu().numpy()                           # (t, [ch,] rows, 4)
    if img.ndim == 3:
        img = img[:, None]
    return [img[:, c].transpose(1, 0, 2)[::-1] for c in range(img.shape[1])]
