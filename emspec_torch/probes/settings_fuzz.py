"""A seeded fuzz of ``Settings`` on the card: random draws over the whole
surface that ``Settings`` accepts, each run through the port's batch and
its graphed live stream on the card and held to the port's CPU path.

What a draw takes (``draw_settings``): either mode; one bank of any
``FFT_SIZES`` entry, or multires with 2–3 distinct powers of two from
256 to 262144; ``raster_height`` log-uniform in 2–4,096; ``hop`` 0 (auto)
or log-uniform in 16 … 2·n_max; 1–16 channels; a sample rate of 8–192
kHz; ``freq_scale`` log-uniform in 0.02–100; ``smoothing`` in 0–0.99;
``fft_method``, ``fft_impl`` (``"fourstep"`` only where
``fourstep.supported``), ``scatter``, ``scatter_passes``, ``agc_global``,
``auto_gain``, ``display_channel`` and the colormap; gain, dB range,
noise gate, AGC strength, brightness and low-end boost at
``tests/test_fuzz_settings.py``'s ranges.  A draw whose pending ring or
batch would pass ``RING_BUDGET`` / ``BATCH_BUDGET`` bytes of card memory
is skipped and counted.

Each case (``run_case``) gets n_max plus 3–40 hops of signal (a chirp,
two tones and 1% noise, ``fuzz_signal``), with NaN/±Inf samples in a
quarter of the cases, and checks, on the card:

1. ``Pipeline.process`` and a graphed ``Stream`` raise nothing where the
   port's CPU path (``process``) runs the same settings; where the CPU
   path raises, the card's ``process`` raises the same error type;
2. the card's ``vis`` within ``compare_vis`` of the CPU path's
   (``reference_settings``: the stencil method's CPU path at
   ``fft_impl="xla"``, as B1 computes); at hops below 64 (Δt/hop's
   rounding boundaries sampled finely), and where the raw comparison
   fails, after float64 plain settles the deposits the two place apart
   (``settled_vis``: float64 with one path, or between the two, in each
   coordinate; at hops of ``MIN_HOP`` and more each deposit it does not
   explain ``UNEXPLAINED_BELOW`` below the loudest);
3. the graphed ``Stream`` in random pushes ≡ the card's ``process`` bit
   for bit in ``vis`` and ``rgba`` in every case — every spectrum on the
   card comes from a kernel of the port's own whose arithmetic for a
   frame depends on its size alone (B1, the real FFT kernel, B4), never
   from cuFFT — one capture, no frame dropped; two ``process`` calls
   bit-equal;
4. ``vis`` finite and in [0, 1] (a non-finite input included).

``coverage`` counts the cases that reached each kernel form and route by
the launch counters (``FORMS``).  ``FIXED`` cases run beside the draws:
the ring form's bands at the envelope's corner (16 lanes × 16,385 deposits
× 4,096 rows, 529 bands a lane), a multires draw with a bank of 65536 or
more (B1's cluster_large in its windowed form) and a 256 bank (the
unfused chain), and one case a B1 route or B2 form so that every form
the defaults launch is reached.

    python3 -P emspec_torch/probes/settings_fuzz.py --seeds 300

Prints one JSON line a case and a summary line; exits 1 if a case
failed.  Needs a card.  ``tests/test_torch_fuzz_settings.py`` draws from
``case_of`` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from emspec_torch.config import COLORMAPS, FFT_SIZES, Settings  # noqa: E402
from emspec_torch.dsp import fourstep  # noqa: E402
from emspec_torch.dsp.kernels import launch_counts  # noqa: E402
from emspec_torch.dsp.kernels.deposits import (  # noqa: E402
    deposits_ids, deposits_ids_cluster, deposits_ids_cluster_large,
    deposits_ids_plain)
from emspec_torch.dsp.kernels.deposits import route_of as b1_route  # noqa
from emspec_torch.dsp.kernels.ema import ema_scan  # noqa: E402
from emspec_torch.dsp.kernels.fourstep import fft4_steps123  # noqa: E402
from emspec_torch.dsp.kernels.lut import lut_values  # noqa: E402
from emspec_torch.dsp.kernels.post import post_head, post_tail  # noqa
from emspec_torch.dsp.kernels.rfft import rfft_frames  # noqa: E402
from emspec_torch.dsp.kernels.scatter import (  # noqa: E402
    SORTED_BATCH, SORTED_TILES, histogram)
from emspec_torch.dsp.kernels.window import windowed_frames  # noqa: E402
from emspec_torch.pipeline import Pipeline  # noqa: E402
from emspec_torch.post.chain import PostState, postprocess_batch  # noqa
from emspec_torch.stream import Stream  # noqa: E402
from emspec_torch.validate import compare_vis  # noqa: E402

MAX_SIZE = 262144
MAX_CHANNELS = 16
MAX_ROWS = 4096
MIN_HOP = 16
SAMPLE_RATES = (8000, 11025, 16000, 22050, 32000, 44100, 48000, 88200,
                96000, 176400, 192000)
BANK_SIZES = tuple(1 << b for b in range(8, 19))         # 256 … 262144
RING_BUDGET = 1 << 30     # bytes: the pending ring (2R + 1) × lanes × rows
BATCH_BUDGET = 4 << 30    # bytes: the batch's deposits, ids and grid
SETTLE_BELOW_HOP = 64     # hops below this compare after float64 settles
UNEXPLAINED_BELOW = 1e-6  # ``settled_vis``: the loudest unexplained deposit
NONFINITE_SHARE = 0.25    # of the cases get NaN/±Inf samples

# a coverage key → what counts it: B1's routes (whole: one bank; windowed:
# a bin window and band weight, several banks), B2's sorted forms, the
# other kernels
FORMS = ("B1 block whole", "B1 block windowed", "B1 cluster whole",
         "B1 cluster windowed", "B1 cluster_large whole",
         "B1 cluster_large windowed", "B1 unfused", "B2 tiles", "B2 batch",
         "B2 ring local", "B2 ring cluster", "B2 ring windows",
         "B2 ring bands", "B3", "B4", "B5", "rfft", "scan", "post_head",
         "post_tail")
# the forms the card's defaults launch: each must be reached
REQUIRED = tuple(f for f in FORMS if f != "B1 unfused")
_B1_COUNTER = {"block": deposits_ids, "cluster": deposits_ids_cluster,
               "cluster_large": deposits_ids_cluster_large}
_KERNEL_COUNTER = {"B3": lut_values, "B4": fft4_steps123,
                   "B5": windowed_frames, "rfft": rfft_frames,
                   "scan": ema_scan,
                   "post_head": post_head, "post_tail": post_tail}

_ENHANCED_1 = dict(mode="enhanced", multires=False)
# (name, Settings keywords, hops of signal): the fixed cases
FIXED = (
    ("bands corner", dict(_ENHANCED_1, fft_size=32768, hop=2, channels=16,
                          raster_height=4096), 3),
    ("multires 65536", dict(mode="enhanced", multires=True,
                            multires_sizes=(65536, 4096, 512), hop=256), 12),
    ("multires 256 bank", dict(mode="enhanced", multires=True,
                               multires_sizes=(2048, 256), hop=64), 12),
    ("block whole, tiles", dict(_ENHANCED_1, fft_size=1024, hop=256,
                                raster_height=1024), 12),
    ("cluster windowed", dict(mode="enhanced", multires=True,
                              multires_sizes=(32768, 1024), hop=512), 12),
    ("cluster whole, ring cluster", dict(_ENHANCED_1, fft_size=32768,
                                         hop=800), 12),
    ("cluster_large whole, ring windows", dict(
        _ENHANCED_1, fft_size=131072, sample_rate=96000), 6),
    ("direct fourstep", dict(_ENHANCED_1, fft_size=4096, hop=512,
                             fft_method="direct", fft_impl="fourstep",
                             channels=2), 12),
    ("natural", dict(mode="natural", multires=True, smoothing=0.7), 12),
)


def _log_uniform_int(rng, lo: int, hi: int) -> int:
    return int(min(hi, max(lo, round(math.exp(rng.uniform(
        math.log(lo), math.log(hi)))))))


def draw_settings(rng: np.random.Generator, max_size: int = MAX_SIZE,
                  max_channels: int = MAX_CHANNELS) -> Settings:
    """One random ``Settings`` over the whole surface, banks at most
    ``max_size`` points and at most ``max_channels`` channels."""
    multires = bool(rng.integers(0, 2))
    sizes_ok = [n for n in FFT_SIZES if n <= max_size]
    if multires:
        banks = [n for n in BANK_SIZES if n <= max_size]
        sizes = tuple(sorted(rng.choice(banks, size=int(rng.integers(2, 4)),
                                        replace=False).tolist(),
                             reverse=True))
    else:
        sizes = (int(rng.choice(sizes_ok)),)
    n_max = sizes[0]
    channels = int(rng.integers(1, max_channels + 1))
    hop = 0 if rng.random() < 0.25 else _log_uniform_int(rng, MIN_HOP,
                                                         2 * n_max)
    impls = ["auto", "xla"] + (["fourstep"] if all(
        fourstep.supported(n) for n in sizes) else [])
    return Settings(
        fft_size=n_max if not multires else int(rng.choice(sizes_ok)),
        mode=str(rng.choice(["enhanced", "natural"])),
        multires=multires,
        multires_sizes=sizes if multires else (8192, 2048, 512),
        raster_height=_log_uniform_int(rng, 2, MAX_ROWS),
        hop=hop,
        channels=channels,
        display_channel=int(rng.integers(0, channels)),
        sample_rate=int(rng.choice(SAMPLE_RATES)),
        colormap=str(rng.choice(COLORMAPS)),
        gain=float(rng.uniform(0.1, 10)),
        db_range=float(rng.uniform(20, 120)),
        noise_gate_db=float(rng.uniform(-120, -20)),
        agc_strength=float(rng.uniform(0, 1)),
        auto_gain=bool(rng.integers(0, 2)),
        agc_global=bool(rng.integers(0, 2)),
        smoothing=float(rng.uniform(0, 0.99)),
        brightness=float(rng.uniform(0.1, 1)),
        low_end_boost=float(rng.uniform(0.5, 10)),
        freq_scale=float(math.exp(rng.uniform(math.log(0.02),
                                              math.log(100.0)))),
        scatter=str(rng.choice(["auto", "pallas", "segment_sum"])),
        scatter_passes=int(rng.integers(1, 4)),
        fft_method=str(rng.choice(["stencil", "direct"])),
        fft_impl=str(rng.choice(impls)),
    )


def fuzz_signal(rng: np.random.Generator, s: Settings, n_max: int,
                hop: int, hops: int | None = None,
                nonfinite: bool | None = None) -> tuple:
    """n_max plus 3–40 hops (``hops`` where given) of a chirp from 80 Hz to
    a third of the rate, two tones and 1% noise, each further channel the
    first rolled by 7·c samples; NaN/±Inf at 5 samples a channel in
    ``NONFINITE_SHARE`` of the cases (``nonfinite`` where given) → (x
    (channels, n) or (n,) float32, whether it holds non-finite samples)."""
    hops = int(rng.integers(3, 41)) if hops is None else hops
    n = n_max + hops * hop
    sr = s.sample_rate
    t = np.arange(n) / sr
    f0, f1 = 80.0, sr / 3.0
    dur = max(n / sr, 1e-9)
    x = 0.5 * np.sin(2 * np.pi * (f0 * t + 0.5 * (f1 - f0) / dur * t * t))
    for f in rng.uniform(0.01, 0.45, size=2) * sr:
        x += 0.1 * np.sin(2 * np.pi * f * t)
    x += 0.01 * rng.standard_normal(n)
    x = x.astype(np.float32)
    bad = bool(rng.random() < NONFINITE_SHARE) if nonfinite is None \
        else nonfinite
    chans = []
    for c in range(s.channels):
        xc = np.roll(x, 7 * c)
        if bad:
            at = rng.choice(n, size=min(5, n), replace=False)
            xc[at] = rng.choice([np.nan, np.inf, -np.inf], size=at.size)
        chans.append(xc)
    return (chans[0] if s.channels == 1 else np.stack(chans)), bad


def footprint(pipe: Pipeline, channels: int, t_count: int) -> dict:
    """Bytes of card memory a case holds at once: the live step's pending
    ring ((2R + 1) × lanes × rows float32) and the batch's deposits (ids,
    contributions and absolute ids, 4 bytes each, and B1's spectra, 24 a
    bin) and grids (the grid, vis and rgba)."""
    k = sum(hi - lo for lo, hi in pipe.k_slices)
    ring = (2 * pipe.reach + 1) * channels * pipe.rows * 4
    batch = t_count * channels * (k * 36 + pipe.rows * 16)
    return dict(ring=ring, batch=batch,
                over=ring > RING_BUDGET or batch > BATCH_BUDGET)


def settled_vis(cpu: Pipeline, x: np.ndarray, t_count: int, ik, ck,
                between: bool = False):
    """The CPU path's vis of ``x`` with its float32 deposits settled where
    float64 plain places a deposit as the other path (``ik``, ``ck``: its
    relative ids and contributions, on the CPU) does → (vis, deposits
    placed apart, of them explained by float64, of them settled, the
    loudest unexplained one's contrib over the loudest deposit's, the
    first unexplained ones).  Float64 plain (``deposits_ids_plain`` of
    each bank's frames in float64, with the bank's bin window and band
    weight) explains a deposit placed apart where it sides with one path
    in its row and in its column offset (each a rounding of its own: f̂,
    Δt/hop), or, where one path drops it, drops it too or keeps it where
    the other path does.  ``between``: float64 may also lie between the two
    paths in a coordinate (at a hop of a few samples a float32 error of a
    sample in Δt moves a deposit by columns, either way)."""
    p = cpu.params()
    inputs = cpu._bank_inputs(cpu.to_device(x), t_count)
    ip, cp = cpu._deposit_ids_rel(inputs, p)
    multibank = len(cpu.sizes) > 1
    parts = [deposits_ids_plain(
        f.double(), p.logmap_a, p.logmap_b, p.power_floor, n=n,
        hop=cpu.hop, sr=float(cpu.settings.sample_rate), rows=cpu.rows,
        reach=cpu.reach, k_lo=lo, k_hi=hi,
        band=p.band_bins[b] if multibank else None)
        for b, (f, n, (lo, hi)) in enumerate(zip(inputs, cpu.sizes,
                                                 cpu.k_slices))]
    i64 = torch.cat([a for a, _ in parts], dim=-1)
    c64 = torch.cat([c for _, c in parts], dim=-1)
    vk, vp, v64 = ck > 0, cp > 0, c64 > 0
    apart = ~(((ik == ip) & vk & vp) | (~vk & ~vp))
    card64 = apart & (ik == i64) & (vk == v64)
    C = cpu.rows

    def sides(part):            # float64 with one path in one coordinate
        a, b, c = part(ik), part(ip), part(i64)
        if between:
            return (torch.minimum(a, b) <= c) & (c <= torch.maximum(a, b))
        return (c == a) | (c == b)
    explained = apart & torch.where(
        vk == vp, v64 & sides(lambda i: i % C) & sides(lambda i: i // C),
        ~v64 | (i64 == torch.where(vk, ik, ip)))
    odd = apart & ~explained
    top = max(float(ck.max()), float(cp.max()), 1e-38)
    loud = float(torch.where(odd, torch.maximum(ck, cp), 0.0).max()) / top
    first = [dict(at=at, other=(int(ik[tuple(at)]), float(ck[tuple(at)])),
                  cpu=(int(ip[tuple(at)]), float(cp[tuple(at)])),
                  float64=(int(i64[tuple(at)]), float(c64[tuple(at)])))
             for at in torch.nonzero(odd)[:6].tolist()]
    ip = torch.where(card64, i64, ip)
    cp = torch.where(card64, c64.float(), cp)
    grid = cpu._scatter_absolute(cpu._absolute_ids(ip, t_count, cpu.reach),
                                 cp, t_count, exact=True)
    vis, _ = postprocess_batch(
        grid.movedim(-2, 0).contiguous(),
        PostState.init(grid.shape[:-2] + (cpu.rows,), "cpu"), p.post,
        cpu.settings.agc_global)
    return (vis, int(apart.sum()), int(explained.sum()), int(card64.sum()),
            loud, first)


def push_sizes(rng: np.random.Generator, n: int, capacity: int,
               hop: int, n_max: int) -> list:
    """Random push lengths covering ``n`` samples: log-uniform from 1 to
    min(the ring's room past a window and a hop, n_max + 4·hop) — a push
    past that room overwrites samples the stream has not read, and the
    stream drops those frames by design."""
    top = max(2, min(capacity - n_max - hop, n_max + 4 * hop))
    out, at = [], 0
    while at < n:
        k = _log_uniform_int(rng, 1, top)
        out.append(min(k, n - at))
        at += k
    return out


def _delta(before: dict) -> dict:
    return {key: n - before.get(key, 0)
            for key, n in launch_counts().items()}


def coverage(pipe: Pipeline, delta: dict) -> list:
    """The ``FORMS`` a case reached, by its launch counters' rise."""
    def rose(fn, name=None, key=None):
        return delta.get((fn, name, key), 0) > 0
    got = set()
    windowed = len(pipe.sizes) > 1
    for n in pipe.sizes:
        if not pipe._use_fused_deposits(n):
            if pipe.settings.mode == "enhanced":
                got.add("B1 unfused")
            continue
        route = b1_route(n)
        if route in _B1_COUNTER and rose(_B1_COUNTER[route]):
            got.add(f"B1 {route} {'windowed' if windowed else 'whole'}")
    for form, key in (("B2 tiles", SORTED_TILES), ("B2 batch", SORTED_BATCH)):
        if rose(histogram, "route_launches", key):
            got.add(form)
    for key in ("local", "cluster", "windows", "bands"):
        if rose(histogram, "ring_form_launches", key):
            got.add(f"B2 ring {key}")
    got.update(k for k, fn in _KERNEL_COUNTER.items() if rose(fn))
    return [f for f in FORMS if f in got]


def _summary(s: Settings) -> dict:
    keys = ("mode", "multires", "fft_size", "multires_sizes",
            "raster_height", "hop", "channels", "sample_rate", "smoothing",
            "freq_scale", "fft_method", "fft_impl", "scatter",
            "scatter_passes", "agc_global", "auto_gain", "display_channel")
    d = {k: getattr(s, k) for k in keys}
    d["multires_sizes"] = list(d["multires_sizes"])
    if not s.multires:
        del d["multires_sizes"]
    return d


def reference_settings(s: Settings) -> Settings:
    """The settings of the CPU path a case's card run is held to: ``s``,
    save that the stencil method's spectra come from B1 on the card at
    every bank of 512–262144 points, which computes as ``torch.fft`` does,
    so there the CPU path runs ``fft_impl="xla"``: the CPU's four-step
    products in float32 err at 131072 points by more than a faint bin's
    power (seed 14: the CPU path at ``"fourstep"`` against itself at
    ``"xla"`` differs as much as the card against it, 0.186 in vis)."""
    if s.mode == "enhanced" and s.fft_method == "stencil":
        return s.replace(fft_impl="xla")
    return s


def run_case(s: Settings, x: np.ndarray, dev, rng: np.random.Generator
             ) -> dict:
    """One case's checks (module docstring) on the card ``dev`` → a dict
    with ``faults`` (empty where every check held), ``forms``
    (``coverage``) and what was read."""
    out: dict = dict(settings=_summary(s), faults=[], forms=[])
    faults = out["faults"]
    cpu = Pipeline(reference_settings(s), "cpu")
    try:
        cpu_result = cpu.process(x)[:2]
    except Exception as e:           # the CPU path's refusal, held below
        cpu_result = e
    before = launch_counts()
    gpu = Pipeline(s, dev)
    xg = gpu.to_device(x)
    if isinstance(cpu_result, Exception):
        out["cpu_raised"] = f"{type(cpu_result).__name__}: {cpu_result}"
        try:
            gpu.process(xg)
            faults.append("the CPU path raised, the card's process did not")
        except Exception as e:
            if type(e) is not type(cpu_result):
                faults.append(f"the card raised {type(e).__name__}: {e}")
        out["forms"] = coverage(gpu, _delta(before))
        return out
    vis_c, _ = cpu_result
    try:
        vis, rgba, _ = gpu.process(xg)
        vis2, rgba2, _ = gpu.process(xg)
    except Exception as e:
        faults.append(f"process raised {type(e).__name__}: {e}")
        return out
    if not (torch.equal(vis, vis2) and torch.equal(rgba, rgba2)):
        faults.append(f"two process calls differ in "
                      f"{int((vis != vis2).sum())} cells")
    t_count = vis.shape[0]
    try:
        st = Stream(s, dev)
        cols = []
        at = 0
        for k in push_sizes(rng, x.shape[-1], st.ring.capacity, gpu.hop,
                            gpu.n_max):
            cols += st.push(x[..., at:at + k])
            at += k
        cols += st.flush()
        captures, dropped = st.captures, st.dropped_frames
        st.close()
    except Exception as e:
        faults.append(f"the graphed Stream raised {type(e).__name__}: {e}")
        cols, captures, dropped = [], 0, 0
    if cols:
        same = [c.index for c in cols] == list(range(t_count))
        if same:
            sv = torch.stack([c.vis for c in cols])
            sr = torch.stack([c.rgba for c in cols])
            out.update(stream_bit_equal=torch.equal(sv, vis)
                       and torch.equal(sr, rgba),
                       stream_cells_differ=int((sv != vis).sum()),
                       stream_vis_max=float((sv - vis).abs().max()),
                       stream_px_differ=int((sr != rgba).any(-1).sum()))
            same = out["stream_bit_equal"]
        if not same:
            faults.append(f"the graphed Stream ({len(cols)} columns) ≠ "
                          f"process ({t_count}) bit for bit")
        if captures != 1 or dropped:
            faults.append(f"the Stream captured {captures} graphs, dropped "
                          f"{dropped} frames")
    vis_h = vis.cpu()
    if not (bool(torch.isfinite(vis_h).all()) and float(vis_h.min()) >= 0.0
            and float(vis_h.max()) <= 1.0):
        faults.append("vis not finite in [0, 1]")
    ok, worst, share = compare_vis(vis_c, vis_h)
    out.update(vis_max=worst, vis_share=share)
    if s.mode == "enhanced" and (gpu.hop < SETTLE_BELOW_HOP or not ok):
        ik, ck = (a.cpu() for a in gpu._deposit_ids_rel(
            gpu._bank_inputs(xg, t_count), gpu.params()))
        vis_s, apart, explained, _, loud, odd = settled_vis(
            cpu, x, t_count, ik, ck, between=True)
        ok, worst, share = compare_vis(vis_s, vis_h)
        out.update(apart=apart, explained=explained, loudest_other=loud,
                   settled_share=share)
        if loud > UNEXPLAINED_BELOW and gpu.hop >= MIN_HOP:
            faults.append(f"{apart - explained} of {apart} deposits apart "
                          f"unexplained, the loudest {loud:.2e}: {odd}")
    if not ok:
        faults.append(f"vis against the CPU path: max-filter diff {worst}, "
                      f"share over 2/255 {share}")
    out["forms"] = coverage(gpu, _delta(before))
    return out


def case_of(seed: int, max_size: int = MAX_SIZE,
            max_channels: int = MAX_CHANNELS):
    """Seed → (Settings, signal, whether it is non-finite, the rng for the
    pushes, the footprint) of a drawn case."""
    rng = np.random.default_rng(seed)
    s = draw_settings(rng, max_size, max_channels)
    pipe = Pipeline(s, "cpu")
    x, bad = fuzz_signal(rng, s, pipe.n_max, pipe.hop)
    return s, x, bad, rng, footprint(pipe, s.channels,
                                     pipe.num_columns(x.shape[-1]))


def fixed_case(kw: dict, hops: int, seed: int = 0):
    """A ``FIXED`` case's Settings keywords and hops → as ``case_of``
    (finite input)."""
    rng = np.random.default_rng(seed)
    s = Settings(**kw)
    pipe = Pipeline(s, "cpu")
    x, _ = fuzz_signal(rng, s, pipe.n_max, pipe.hop, hops, nonfinite=False)
    return s, x, False, rng, footprint(pipe, s.channels,
                                       pipe.num_columns(x.shape[-1]))


def sweep(seeds, dev, fixed: bool = True, log=print) -> dict:
    """The ``FIXED`` cases (where ``fixed``) and the draws of ``seeds`` →
    the summary: cases run, skipped (over the budget), failed (seed or
    name, settings and faults), the coverage by form, seconds."""
    t0 = time.perf_counter()
    cov = dict.fromkeys(FORMS, 0)
    ran, skipped, failed = 0, [], []
    cases = [(name, lambda kw=kw, h=h: fixed_case(kw, h))
             for name, kw, h in FIXED] if fixed else []
    cases += [(seed, lambda seed=seed: case_of(seed)) for seed in seeds]
    for who, make in cases:
        s, x, bad, rng, fp = make()
        if fp["over"] and not isinstance(who, str):
            skipped.append(who)
            continue
        c0 = time.perf_counter()
        res = run_case(s, x, dev, rng)
        res.update(case=who, nonfinite=bad, seconds=round(
            time.perf_counter() - c0, 3), ring_bytes=fp["ring"])
        ran += 1
        for f in res["forms"]:
            cov[f] += 1
        if res["faults"]:
            failed.append(dict(case=who, settings=res["settings"],
                               faults=res["faults"]))
        log(json.dumps(res, default=str))
        torch.cuda.empty_cache()
    return dict(ran=ran, skipped=len(skipped), skipped_seeds=skipped,
                failed=failed, coverage=cov,
                seconds=round(time.perf_counter() - t0, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--cases", default=None,
                    help="comma-separated seeds alone, without the fixed "
                    "cases (a listed fault's draw again)")
    ap.add_argument("--out", default=None,
                    help="also write each case's line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("settings_fuzz: needs a card")
    sink = open(args.out, "w") if args.out else None

    def log(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    seeds = ([int(c) for c in args.cases.split(",")] if args.cases
             else range(args.seeds))
    res = sweep(seeds, torch.device("cuda"), not args.cases, log)
    log(json.dumps(dict(summary=res, budget=dict(
        ring=RING_BUDGET, batch=BATCH_BUDGET))))
    if sink:
        sink.close()
    return 1 if res["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
