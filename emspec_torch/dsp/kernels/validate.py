"""On-card kernel validation: every hand-written CUDA kernel form that a
default path of the port launches, and the opt-in ones, against its plain
PyTorch version (``emspec.dsp.pallas.validate``), the check that
``python -m emspec_torch doctor --kernels`` and every bench run make
before any number is reported.

What it holds (``quick`` takes the first of each list; every check adds
one ``"kernel · form · shape"`` line to the report's ``"checked"``):

* B2's ordered sums, the card's default (``validate_sorted``): the batch
  form at the bench primary's sum (enhanced 8192, 16 s mono: 1 ×
  1,524,084 deposits → 190,464 cells, R = 2), the tiles form at the
  display default's batch (1 × 2,267,934 → 3,039,744, R = 32), then the
  batch form's other regimes: packed entries (north: 32768 at hop 800,
  R = 20), 16 row bands (ext262144: 8 s at 96 kHz) and 16 lanes
  (batch16).  The ids are B1's of a numpy-seeded signal through the
  pipeline, as the batch makes them.  Each form forced and as
  ``sorted_form`` picks it, its launch counted.
* B2's ring form, every live hop's sum (``validate_ring``): the display
  default's hop (382 deposits → 65 × 512, the local kernel), the
  enhanced 8192 one (4,097 → 5 × 512, clustered), 131072 at 96 kHz
  (65,537 deposits: the hop in windows), 8192 at hop 16 with 2,048 rows
  (4,097 → 513 × 2,048: the ring in bands), then 16 lanes at 32768
  and 96 kHz (clusters of 4); ``ring_plan`` must pick the form named.
  Nine hops streamed into a ring of random values from t0 = 0, 1, R,
  P − 1, P, P + 1 and 100,003 (columns below 0 dropped, the slot wrap,
  far along), each hop checked.
* B2's atomic routes, opt-in (``exact_sums=False``;
  ``validate_histogram``): row and global, each forced, at (4, 2048,
  4608), then (16, 16512, 4608) and (4, 901, 1152) (rows, deposits a row,
  cells), on ids in [−1, S).
* B1 (``validate_deposits``): the whole spectrum at 8192, then 32768 and,
  at b = 2, 131072 and 262144; its windowed form
  (``validate_deposits_windowed``) at the display default's banks on 16 s
  (5,937 frames), each bank's bin window and band weight: 8192, then 2048
  and 512.
* B5 at (16, 2048), then (90, 2048) and (32768,); B4 at 8192, then
  32768; B3 at (640, 512) in both forms; the EMA scan, ``post_head`` and
  ``post_tail`` at 1024 × 512 (smoothing 0 and 0.6; forced repair too).
* The real FFT kernel (``validate_rfft``, ``RFFT_CASES``) at the
  natural and direct paths' frames: natural 4096 (the CLI's default,
  Hann, the power form), the direct method's triple at 8192 and direct
  65536 at 96 kHz (route "cluster"), then the natural display default's
  512 bank and direct 32768: against its plain version (``torch.fft``),
  bit-equal to every other route that holds the size (``routes_of``:
  the cluster against the three-launch route it replaced), frame 1 of
  the batch bit-equal to frame 1 transformed alone, and in the power
  form a NaN, +Inf and −Inf frame each stored as 0.

Tolerances: B2's ordered forms bit-equal to the plain sum computed on the
CPU (on the card ``histogram_plain`` is ``index_add_``'s atomics, no
order), the same on a second run, added into a nonzero output, and finite
with NaN and Inf behind dropped ids; B2's atomic routes rtol 5e-5, atol
1e-4 (float32 sums in another order); B5, B3 and the post chain's kernels
bit-equal; B4 2e-5·max|X|; the real FFT 2e-5·√(N/512) of the peak
(DESIGN.md §9), batch-invariant bit for bit; B1 as grids (energy and 3×3
max-filters, ``validate.compare_grids``) and ≥ 99.99% equal ids — the
windowed form on the absolute (t, rows) grid the display sums, float64
plain deciding where float32 plain's rounding flipped a deposit.

``perturbed`` swaps one form for a broken stand-in, which each of these
checks must refuse (``PERTURBATIONS``; the CPU tests, ``chip_smoke.py``).

The card only: on the CPU the plain versions are what the wrappers run,
so there is nothing to hold them against and ``validate_kernels``
raises.  Each per-kernel validator takes ``dev``: on the CPU it runs the
plain versions through the same checks.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

SR = 48_000
# the default batch sums B2's ordered forms serve: label, Settings
# fields, channels, seconds, the form
SORTED_CASES = (
    ("batch", dict(mode="enhanced", multires=False, fft_size=8192), 1, 16.0,
     "batch"),
    ("multires", {}, 1, 16.0, "tiles"),
    ("north", dict(mode="enhanced", multires=False, fft_size=32768, hop=800),
     1, 16.0, "batch"),
    ("ext262144", dict(mode="enhanced", multires=False, fft_size=262144,
                       sample_rate=96000), 1, 8.0, "batch"),
    ("batch16", dict(mode="enhanced", multires=False, fft_size=8192), 16,
     16.0, "batch"))
# the live hops B2's ring form serves: label, Settings fields, lanes, the
# form ``ring_plan`` takes (``scatter.ring_form``)
RING_CASES = (
    ("multires live", {}, 1, "local"),
    ("live", dict(mode="enhanced", multires=False, fft_size=8192), 1,
     "cluster"),
    ("131072 live", dict(mode="enhanced", multires=False, fft_size=131072,
                         sample_rate=96000), 1, "windows"),
    ("hop 16 live", dict(mode="enhanced", multires=False, fft_size=8192,
                         hop=16, raster_height=2048), 1, "bands"),
    ("stress live", dict(mode="enhanced", multires=False, fft_size=32768,
                         sample_rate=96000), 16, "cluster"))
RING_QUICK = 4              # the quick set's ring cases: every form
RING_FRAMES = 9             # a ring case's signal: its frames, a stream's hops
WINDOW_SECONDS = 16.0       # B1's windowed form: the display default's batch
# the real FFT kernel's checks: label, Settings fields, the bank, power
# form (natural, Hann on load) or the spectra of B5's triple (direct)
RFFT_CASES = (
    ("natural 4096", dict(mode="natural", multires=False, fft_size=4096), 0,
     True),
    ("direct 8192", dict(mode="enhanced", multires=False, fft_size=8192,
                         fft_method="direct"), 0, False),
    ("direct 65536", dict(mode="enhanced", multires=False, fft_size=65536,
                          fft_method="direct", sample_rate=96000), 0, False),
    ("natural 512 bank", dict(mode="natural"), 2, True),
    ("direct 32768", dict(mode="enhanced", multires=False, fft_size=32768,
                          fft_method="direct"), 0, False))
RFFT_QUICK = 3              # the quick set: one power form, the block and
                            # the cluster route's spectra
# each new check's broken stand-ins (``perturbed``): form → its validator
# and the ways to break it
PERTURBATIONS = {
    "sorted batch": ("validate_sorted", ("ulp", "reversed", "out", "nan")),
    "sorted tiles": ("validate_sorted", ("ulp", "reversed", "out", "nan")),
    "ring local": ("validate_ring", ("ulp", "reversed", "nan")),
    "ring cluster": ("validate_ring", ("ulp", "reversed", "nan")),
    "ring windows": ("validate_ring", ("order",)),
    "ring bands": ("validate_ring", ("dropped",)),
    "B1 windowed": ("validate_deposits_windowed", ("moved", "unweighted")),
    "rfft": ("validate_rfft", ("batch", "unscrubbed")),
    "rfft cluster": ("validate_rfft", ("mirror",)),
}


def _assert(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _signal(seconds: float, channels: int, seed: int, sr: int) -> np.ndarray:
    """A linear chirp to 9 kHz (channel c from 100 + 150·c Hz), three
    tones of 0.1 and 1% Gaussian noise from ``seed`` (``chip_smoke.py``'s
    signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0,
                                                          1320.0))
    out = []
    for c in range(channels):
        f0 = 100.0 + 150.0 * c
        chirp = 0.5 * np.sin(2 * np.pi * (f0 * t + 0.5 * (9000.0 - f0)
                                          / seconds * t * t))
        out.append(chirp + tones + 0.01 * rng.standard_normal(t.size))
    x = np.stack(out).astype(np.float32)
    return x[0] if channels == 1 else x


def _pipeline(dev, fields: dict, channels: int):
    from emspec_torch.config import Settings
    from emspec_torch.pipeline import Pipeline
    return Pipeline(Settings(**fields).replace(channels=channels), dev)


def _relative_ids(pipe, seconds: float, seed: int):
    """B1's relative ids and contrib of ``seconds`` of ``_signal`` through
    ``pipe``, as its batch makes them → (t, ids (..., t, K), contrib)."""
    s = pipe.settings
    x = pipe.to_device(_signal(seconds, s.channels, seed, s.sample_rate))
    t = pipe.num_columns(x.shape[-1])
    ids, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(x, t),
                                         pipe.params())
    return t, ids, contrib


def _launched(dev, route: str, fn, where: str):
    """``fn()``, which must launch B2's ``route`` once on the card."""
    from emspec_torch.dsp.kernels import scatter

    counts = scatter.histogram.route_launches
    before = counts[route]
    out = fn()
    _assert(dev.type != "cuda" or counts[route] == before + 1,
            f"{where}: no launch of that form")
    return out


def _dropped(ids: torch.Tensor, vals: torch.Tensor, outside: int):
    """Every 7th deposit dropped (id −1) with a NaN behind it, every 7th
    from the 3rd out of range (id ``outside``) with an Inf."""
    i, v = ids.clone().reshape(-1), vals.clone().reshape(-1)
    i[::7], v[::7] = -1, float("nan")
    i[3::7], v[3::7] = outside, float("inf")
    return i.reshape(ids.shape), v.reshape(vals.shape)


def validate_histogram(dev, shapes=((16, 16512, 4608), (4, 901, 1152)),
                       rtol: float = 5e-5) -> list:
    """B2's atomic routes, each forced, against ``histogram_plain`` on ids
    in [−1, S), a share of them dropped."""
    from emspec_torch.dsp.kernels.scatter import (
        ROUTES, histogram, histogram_plain)

    rng = np.random.default_rng(7)
    checked = []
    for b, m, s in shapes:
        ids = torch.from_numpy(rng.integers(-1, s, (b, m)).astype(np.int32))
        vals = torch.from_numpy(rng.uniform(0.0, 1.0, (b, m)).astype(
            np.float32))
        want = histogram_plain(ids, vals, s)
        for route in ROUTES:
            got = _launched(dev, route, lambda: histogram(
                ids.to(dev), vals.to(dev), s, route=route),
                f"B2 {route} at {(b, m, s)}").cpu()
            torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)
            checked.append(f"B2 · {route} · {b} × {m} → {s}")
    return checked


def validate_sorted(dev, quick: bool = True,
                    seconds: float | None = None) -> list:
    """B2's ordered batch sums (``SORTED_CASES``; module docstring), each
    bit-equal to the plain sum computed on the CPU.  ``seconds`` stands in
    for each case's signal length (the CPU tests)."""
    from emspec_torch.dsp.kernels import scatter

    checked = []
    for i, (label, fields, ch, secs, form) in enumerate(
            SORTED_CASES[:2] if quick else SORTED_CASES):
        pipe = _pipeline(dev, fields, ch)
        t, rel, contrib = _relative_ids(pipe, seconds or secs, 20 + i)
        lead, k, R, C = rel.shape[:-2], rel.shape[-1], pipe.reach, pipe.rows
        ids = pipe._absolute_ids(rel, t, R).reshape(lead + (-1,)).contiguous()
        vals = contrib.reshape(lead + (-1,)).contiguous()
        cells, lanes = t * C, math.prod(lead)
        del rel, contrib
        plan = scatter.batch_plan(t, k, R, C, lanes)
        shape = (f"{lanes} × {ids.shape[-1]} → {cells}, R = {R}"
                 + (f", {plan['bands']} row band"
                    f"{'s' if plan['bands'] > 1 else ''}, "
                    f"{'packed' if plan['packed'] else 'raw'} entries"
                    if form == "batch" else ""))
        where = f"B2 sorted {form} at {label} ({shape})"
        chosen = scatter.sorted_form(t, k, R, C, lanes)
        _assert(chosen == form, f"{where}: sorted_form picks {chosen!r}")
        bound = dict(route=scatter.SORTED, reach=R, frame_len=k,
                     column_len=C)

        def run(force=None, out=None, ids=ids, vals=vals):
            return _launched(dev, f"sorted_{form}", lambda: scatter.histogram(
                ids, vals, cells, out=out, form=force, **bound), where)
        ids_c, vals_c = ids.cpu(), vals.cpu()
        want = scatter.histogram_plain(ids_c, vals_c, cells)
        for force in (form, None):
            got = run(force)
            _assert(torch.equal(got.cpu(), want),
                    f"{where}, {'forced' if force else 'by shape'}: differs "
                    f"from the plain sum in deposit order")
        _assert(torch.equal(run(), got), f"{where}: two runs differ")
        base = torch.from_numpy(np.random.default_rng(i).uniform(
            0.0, 1.0, lead + (cells,)).astype(np.float32))
        _assert(torch.equal(run(out=base.clone().to(dev)).cpu(),
                            scatter.histogram_plain(ids_c, vals_c, cells,
                                                    out=base)),
                f"{where}: added into an output, differs from the plain sum")
        bad_i, bad_v = _dropped(ids_c, vals_c, cells + 5)
        got = run(ids=bad_i.to(dev), vals=bad_v.to(dev)).cpu()
        _assert(bool(torch.isfinite(got).all()),
                f"{where}: a NaN or Inf behind a dropped id landed")
        _assert(torch.equal(got, scatter.histogram_plain(bad_i, bad_v, cells)),
                f"{where}, ids dropped: differs from the plain sum in "
                f"deposit order")
        checked.append(f"B2 · sorted {form} · {label}: {shape}")
    return checked


def validate_ring(dev, quick: bool = True) -> list:
    """B2's ring form at the live hops of ``RING_CASES``: a stream of the
    ``RING_FRAMES`` hops of a signal (B1's relative ids, as the live step
    hands them), hop f at t = t0 + f, into one ring that starts with
    zeros and random values of the deposits' size, for each t0 of 0, 1, R, P − 1,
    P, P + 1 and 100,003; after each hop bit-equal to
    ``histogram_ring_plain`` of ``ring_ids`` computed on the CPU, also
    with NaN and Inf behind dropped ids, the same on a second run."""
    from emspec_torch.dsp.kernels import scatter

    checked = []
    for i, (label, fields, lanes, form) in enumerate(
            RING_CASES[:RING_QUICK] if quick else RING_CASES):
        pipe = _pipeline(dev, fields, lanes)
        sr = pipe.settings.sample_rate
        _, rel, contrib = _relative_ids(
            pipe, (pipe.n_max + (RING_FRAMES - 1) * pipe.hop) / sr, 30 + i)
        R, C, k = pipe.reach, pipe.rows, rel.shape[-1]
        P = 2 * R + 1
        plan = scatter.ring_plan_on(dev, k, P, C, lanes)
        shape = (f"{lanes} × {k} → {P} × {C} a lane, {plan['cluster']} CTAs "
                 f"a lane" + (f", {plan['windows']} windows of "
                              f"{plan['window']} chunks"
                              if plan["windows"] > 1 else "")
                 + (f", {plan['bands']} bands of {plan['band_slots']} slots"
                    if plan["bands"] > 1 else ""))
        where = f"B2 ring {form} at {label} ({shape})"
        _assert(plan["fits"] and scatter.ring_form(plan) == form,
                f"{where}: ring_plan picks {plan}")
        rng = np.random.default_rng(40 + i)
        rel_c, vals_c = rel.cpu(), contrib.cpu()
        # half the cells 0 (a slot emptied at its column's emission), half
        # of the deposits' size: where a quiet row's deposits are many
        # orders below the loudest, only a cell that starts small shows
        # their order
        ring0 = torch.from_numpy(np.where(
            rng.random((P,) + rel.shape[:-2] + (C,)) < 0.5, 0.0, rng.uniform(
                0.0, 1.0, (P,) + rel.shape[:-2] + (C,))).astype(
                    np.float32)) * vals_c.max()
        pick = torch.from_numpy(rng.random(tuple(rel.shape)) < 0.1)
        bad_i = torch.where(pick, torch.where(rel_c % 2 == 0, -1, P * C + 7),
                            rel_c).to(torch.int32)
        bad_v = torch.where(pick, torch.where(rel_c % 3 == 0, float("inf"),
                                              float("nan")), vals_c)
        for t0 in sorted({0, 1, R, P - 1, P, P + 1, 100_003}):
            for ids, v in ((rel_c, vals_c), (bad_i, bad_v)):
                want, ring = ring0.clone(), ring0.clone().to(dev)
                for f in range(RING_FRAMES):
                    t = t0 + f
                    hop_i = ids[..., f, :].contiguous()
                    hop_v = v[..., f, :].contiguous()
                    scatter.histogram_ring_plain(
                        scatter.ring_ids(hop_i, t, P, C), hop_v, want)
                    t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
                    got = _launched(dev, scatter.SORTED_RING,
                                    lambda: scatter.histogram_ring(
                                        hop_i.to(dev), hop_v.to(dev), ring,
                                        t_dev), where).cpu()
                    _assert(bool(torch.isfinite(got).all()),
                            f"{where}, t = {t}: a NaN or Inf behind a "
                            f"dropped id landed")
                    _assert(torch.equal(got, want), f"{where}, t = {t}: "
                            f"differs from the plain sum in deposit order")
        hop_i, hop_v = (x[..., 0, :].contiguous().to(dev)
                        for x in (rel_c, vals_c))
        first, second = (scatter.histogram_ring(
            hop_i, hop_v, ring0.clone().to(dev), t_dev) for _ in range(2))
        _assert(torch.equal(first, second), f"{where}: two runs differ")
        checked.append(f"B2 · ring {form} · {label}: {shape}")
    return checked


def validate_windowing(dev, shapes=((90, 2048), (32768,))) -> list:
    """B5 (``windowed_frames``) bit-equal to the plain triple multiply."""
    from emspec_torch.dsp.kernels.window import (
        windowed_frames, windowed_frames_plain)

    rng = np.random.default_rng(8)
    for shape in shapes:
        frames = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        _assert(torch.equal(windowed_frames(frames),
                            windowed_frames_plain(frames)),
                f"B5 at {shape}: differs from the plain triple window")
    return [f"B5 · windowed_frames · {s}" for s in shapes]


def validate_fft4(dev, ns=(8192, 32768), rtol: float = 2e-5) -> list:
    """B4 (``fft4_steps123``) against its plain float32 products, three
    sequences at each size."""
    from emspec_torch.dsp.fourstep import _FACTORS
    from emspec_torch.dsp.kernels.fourstep import (
        fft4_steps123, fft4_steps123_plain)

    rng = np.random.default_rng(9)
    for n in ns:
        n1, n2 = _FACTORS[n]
        zr, zi = (torch.from_numpy(rng.standard_normal((3, n1, n2)).astype(
            np.float32)).to(dev) for _ in range(2))
        got = fft4_steps123(zr, zi)
        want = fft4_steps123_plain(zr, zi)
        scale = float(torch.hypot(*want).max())
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        _assert(err <= rtol * scale,
                f"B4 n={n}: error {err / scale:.2e}·max|X| > {rtol}")
    return [f"B4 · four-step · 3 × {n}" for n in ns]


def validate_rfft(dev, quick: bool = True,
                  seconds: float | None = None) -> list:
    """The real FFT kernel (``rfft_frames``) at ``RFFT_CASES``' frames of
    ``WINDOW_SECONDS`` (or ``seconds``) of signal, as the path frames
    them: against its plain version within 2e-5·√(N/512) of the peak;
    bit-equal to each other route that holds N, forced (``routes_of``:
    the cluster's own form against its parent route); frame 1 of the
    batch bit-equal to frame 1 transformed alone (a live hop's batch); in
    the power form three frames given a NaN, +Inf and −Inf sample stored
    as 0, every bin finite."""
    from emspec_torch.dsp.frame import frame_signal
    from emspec_torch.dsp.kernels import rfft
    from emspec_torch.dsp.kernels.window import windowed_frames
    from emspec_torch.dsp.stft import hann_window

    checked = []
    for label, fields, bank, power in RFFT_CASES[:RFFT_QUICK if quick
                                                 else None]:
        pipe = _pipeline(dev, fields, 1)
        sr = pipe.settings.sample_rate
        samples = max(int((seconds or WINDOW_SECONDS) * sr),
                      pipe.n_max + 2 * pipe.hop)
        x = pipe.to_device(_signal(samples / sr, 1, 60, sr))
        n = pipe.sizes[bank]
        frames = frame_signal(x, n, pipe.hop)
        window = hann_window(n, dev) if power else None
        if not power:                      # the direct method's triple
            frames = windowed_frames(frames)
        got = rfft.rfft_frames(frames, window, power=power)
        want = rfft.rfft_frames_plain(frames, window, power=power)
        tol = 2e-5 * math.sqrt(n / 512)
        err = float((got - want).abs().max()) / float(want.abs().max())
        _assert(err <= tol, f"rfft {label}: {err:.2e} of the peak off the "
                f"plain version (> {tol:.2e})")
        route = rfft.route_of(n)
        for other in rfft.routes_of(n)[1:]:
            _assert(torch.equal(rfft.rfft_frames(frames, window, power=power,
                                                 route=other), got),
                    f"rfft {route} {label}: its frames differ from route "
                    f"{other!r}'s (forced) bit for bit")
        flat = frames.reshape(-1, n)
        alone = rfft.rfft_frames(flat[1].contiguous(), window, power=power)
        _assert(torch.equal(alone, got.reshape(-1, n // 2 + 1)[1]),
                f"rfft {label}: frame 1 of the batch differs from the "
                f"frame alone")
        shape = f"{tuple(frames.shape)}"
        if power:
            bad = flat[:5].clone()
            for row, v in ((2, float("nan")), (3, float("inf")),
                           (4, -float("inf"))):
                bad[row, n // 3] = v
            p = rfft.rfft_frames(bad, window, power=True)
            _assert(bool(torch.isfinite(p).all())
                    and not bool(p[2:].any()),
                    f"rfft {label}: non-finite power not scrubbed to 0")
        checked.append(f"rfft · {'power' if power else 'spectrum'} · "
                       f"{label}: {shape}, route "
                       f"{' ≡ '.join(rfft.routes_of(n))}")
    return checked


def _b1_agree(where: str, ik, ck, ip, cp, grids) -> None:
    """B1 against plain: ``grids`` (ids, contrib) → the two grids as
    ``compare_grids`` takes them; ≥ 99.99% of the ids equal (a deposit
    that is invalid or weighted 0 on both sides counts as equal)."""
    from emspec_torch.validate import compare_grids

    g = compare_grids(grids(ip, cp), grids(ik, ck))
    vk, vp = ck > 0, cp > 0
    agree = float((((ik == ip) & vk & vp) | (~vk & ~vp)).float().mean())
    _assert(g.ok and agree >= 0.9999,
            f"{where}: {g}, ids equal on {agree:.6f} of the bins")


def validate_deposits(dev, n: int = 8192, b: int = 3) -> list:
    """B1 (``deposits_ids``, its route by size) over the whole spectrum
    against its plain version on a tone in noise, as relative histograms
    (reach 4, hop n/4)."""
    from emspec_torch.dsp.kernels.deposits import (
        deposits_ids, deposits_ids_plain)
    from emspec_torch.dsp.kernels.scatter import histogram_plain

    rng = np.random.default_rng(10)
    hop, rows, sr, reach = n // 4, 128, 48000.0, 4
    frames = torch.from_numpy(
        (0.2 * rng.standard_normal((b, n))
         + np.sin(2 * np.pi * 440.0 / sr * np.arange(n))[None]
         ).astype(np.float32)).to(dev)
    a = np.log2(20.0)
    scal = tuple(torch.tensor(v, dtype=torch.float32, device=dev) for v in (
        a, (rows - 1) / (np.log2(sr / 2) - a), 1e-12))
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=reach)
    ik, ck = deposits_ids(frames, *scal, **kw)
    ip, cp = deposits_ids_plain(frames, *scal, **kw)
    cells = (2 * reach + 1) * rows
    _b1_agree(f"B1 n={n}", ik, ck, ip, cp, lambda i, c: histogram_plain(
        i, c, cells).reshape(b, 2 * reach + 1, rows))
    return [f"B1 · whole · {b} × {n}"]


def validate_deposits_windowed(dev, quick: bool = True,
                               seconds: float | None = None) -> list:
    """B1's windowed form as the display default ``Settings()`` runs it:
    each bank's frames of ``WINDOW_SECONDS`` (or ``seconds``) of signal,
    its bin window ``[k_lo, k_hi)`` and band weight, against its plain
    version on the same, as the absolute (t, rows) grids the batch sums;
    float64 plain decides where float32 plain's rounding flipped a
    deposit (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
    from emspec_torch.dsp.kernels.deposits import (
        deposits_ids, deposits_ids_plain)
    from emspec_torch.dsp.kernels.scatter import histogram_plain

    pipe = _pipeline(dev, {}, 1)
    x = pipe.to_device(_signal(seconds or WINDOW_SECONDS, 1, 50, SR))
    t = pipe.num_columns(x.shape[-1])
    p = pipe.params()
    scal = (p.logmap_a, p.logmap_b, p.power_floor)
    R, rows = pipe.reach, pipe.rows
    checked = []
    for b, frames in enumerate(pipe._bank_inputs(x, t)[:1 if quick else None]):
        n, (k_lo, k_hi) = pipe.sizes[b], pipe.k_slices[b]
        kw = dict(n=n, hop=pipe.hop, sr=float(SR), rows=rows, reach=R,
                  k_lo=k_lo, k_hi=k_hi, band=p.band_bins[b])
        ik, ck = deposits_ids(frames, *scal, **kw)
        ip, cp = deposits_ids_plain(frames, *scal, **kw)
        i64, c64 = deposits_ids_plain(frames.double(), *scal, **kw)
        settled = (ik != ip) & (ik == i64) & ((ck > 0) == (c64 > 0))
        ip = torch.where(settled, i64, ip)
        cp = torch.where(settled, c64.float(), cp)
        del i64, c64
        shape = f"{t} × {n}, bins [{k_lo}, {k_hi}), band weight"
        _b1_agree(f"B1 windowed at {shape}", ik, ck, ip, cp,
                  lambda i, c: histogram_plain(
                      pipe._absolute_ids(i, t, R).reshape(-1),
                      c.reshape(-1), t * rows).reshape(t, rows))
        checked.append(f"B1 · windowed · display default {shape}")
    return checked


def validate_lut(dev) -> list:
    """B3 in both forms (``lut_lookup`` on int32 indices, ``lut_values``
    on float32 values) bit-equal to the gather."""
    from emspec_torch.dsp.kernels.lut import (
        lut_lookup, lut_lookup_plain, lut_values, lut_values_plain)
    from emspec_torch.tables import lut

    rng = np.random.default_rng(11)
    table = torch.from_numpy(lut("inferno").copy()).to(dev)
    idx = torch.from_numpy(rng.integers(0, 256, (640, 512)).astype(
        np.int32)).to(dev)
    _assert(torch.equal(lut_lookup(idx, table), lut_lookup_plain(idx, table)),
            "B3 lut_lookup differs from the gather")
    vals = torch.from_numpy(rng.uniform(-0.1, 1.1, (640, 512)).astype(
        np.float32)).to(dev)
    _assert(torch.equal(lut_values(vals, table), lut_values_plain(vals, table)),
            "B3 lut_values differs from its plain quantize and gather")
    return ["B3 · lut_lookup · 640 × 512", "B3 · lut_values · 640 × 512"]


def validate_ema(dev, shape=(1024, 512), alpha: float = 0.7) -> list:
    """The EMA scan kernel bit-equal to its plain loop, with its
    speculation as it comes and with every chunk forced to repair."""
    from emspec_torch.dsp.kernels.ema import ema_scan, ema_scan_plain

    rng = np.random.default_rng(12)
    b = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
    y0 = torch.from_numpy(rng.uniform(0, 1, shape[1:]).astype(
        np.float32)).to(dev)
    for a in (alpha, torch.tensor(alpha, dtype=torch.float32, device=dev)):
        want = ema_scan_plain(y0, a, b)
        for window in (None, 0):
            got = ema_scan(y0, a, b, window=window)
            _assert(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"ema_scan (window {window}) differs from its plain "
                    f"loop")
    return [f"ema_scan · {form} · {shape[0]} × {shape[1]}"
            for form in ("speculated", "repair forced")]


def validate_post(dev, t: int = 1024, rows: int = 512) -> list:
    """The post chain's fused kernels: ``post_head`` bit-equal to its plain
    stages 1–3 and row peak, ``post_tail`` to its plain stages 4–8 around
    the smoothing loop (forced repair too), at smoothing 0 and 0.6."""
    from emspec_torch.config import Settings
    from emspec_torch.dsp.kernels.post import (
        pipelined, post_head, post_head_plain, post_tail, post_tail_plain)
    from emspec_torch.post.chain import PostParams

    rng = np.random.default_rng(13)
    power = torch.from_numpy((10.0 ** rng.uniform(-12, 0, (t, rows))).astype(
        np.float32)).to(dev)
    y0 = torch.from_numpy(rng.uniform(0, 1, rows).astype(np.float32)).to(dev)
    freqs = np.geomspace(20.0, 24000.0, rows)
    forms = []
    for smoothing in (0.0, 0.6):
        p = PostParams.from_settings(Settings(smoothing=smoothing), freqs,
                                     dev)
        refs = post_head(power, p.low_end_ramp, p.gain)
        _assert(torch.equal(refs, post_head_plain(power, p.low_end_ramp,
                                                  p.gain)),
                "post_head differs from its plain version")
        want = post_tail_plain(power, refs, y0, p)
        for window in (None, 0):
            got = post_tail(power, refs, y0, p, window=window)
            _assert(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"post_tail (smoothing {smoothing}, window {window}) "
                    f"differs from its plain version")
            form = ("pipelined" if pipelined(smoothing, window)
                    else "chunk-parallel")
            forms.append(f"post_tail · {form}"
                         f"{' repaired' if window == 0 else ''} · {t} × "
                         f"{rows}, smoothing {smoothing}")
    return [f"post_head · fused · {t} × {rows}"] + forms


def validate_kernels(quick: bool = False, device="cuda") -> dict:
    """Run every kernel check on ``device`` (a card); raises on the first
    failure, and on the CPU.  Returns a report dict, its ``"checked"``
    one ``"kernel · form · shape"`` line a check."""
    from emspec_torch.device import as_device

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"validate_kernels checks the CUDA kernels on a card; on "
            f"{dev} the wrappers run the plain versions themselves")
    if not torch.cuda.is_available():
        raise RuntimeError("validate_kernels: no CUDA device is available")
    dev = as_device(dev)
    from emspec_torch import kernels_build
    kernels_build.library()
    checked = validate_histogram(dev, ((4, 2048, 4608),) if quick
                                 else ((16, 16512, 4608), (4, 901, 1152)))
    checked += validate_sorted(dev, quick)
    checked += validate_ring(dev, quick)
    checked += validate_windowing(dev, ((16, 2048),) if quick
                                  else ((90, 2048), (32768,)))
    checked += validate_fft4(dev, (8192,) if quick else (8192, 32768))
    checked += validate_rfft(dev, quick)
    for n, b in ((8192, 3),) if quick else ((8192, 3), (32768, 3),
                                            (131072, 2), (262144, 2)):
        checked += validate_deposits(dev, n, b)
    checked += validate_deposits_windowed(dev, quick)
    checked += validate_lut(dev)
    checked += validate_ema(dev)
    checked += validate_post(dev)
    torch.cuda.synchronize(dev)
    return {"device": torch.cuda.get_device_name(dev),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "library": kernels_build.library_path().name,
            "quick": quick, "kernels_validated": True, "checked": checked}


def forms_of(checked: list) -> str:
    """The kernels and forms a ``"checked"`` list holds, by kernel in
    order: ``"B2 row, global, sorted batch; B1 whole, windowed; …"``."""
    forms: dict = {}
    for line in checked:
        kernel, form, _ = line.split(" · ", 2)
        if form not in forms.setdefault(kernel, []):
            forms[kernel].append(form)
    return "; ".join(f"{k} {', '.join(v)}" for k, v in forms.items())


@contextlib.contextmanager
def perturbed(form: str, how: str):
    """For the length of the block, one kernel form (a key of
    ``PERTURBATIONS``) becomes a broken stand-in: the real call, then its
    result with its largest cell one ulp up (``"ulp"``), the plain sum in
    reverse deposit order (``"reversed"``), an output's old values dropped
    (``"out"``) or a NaN landed where a dropped id carries a NaN or Inf
    (``"nan"``); B2's ring form in windows summed with its windows walked
    last to first (``"order"``), in bands with the band of the frame's own
    column left as it was (``"dropped"``); B1's windowed form with one
    valid id in 1,000 moved a row (``"moved"``) or its band weight left
    out (``"unweighted"``); the real FFT with one ulp on the largest bin
    of frame 1 of any batch of two frames or more (``"batch"``: a frame
    transformed at another batch's bits) or its power form without the
    non-finite scrub (``"unscrubbed"``); route "cluster" with one ulp on
    bin 1 of every frame, whose pair reads its mirror Z[m − 1] from the
    last rank (``"mirror"``).  Calls of the other forms pass
    through.  The form's validator must raise
    ``AssertionError`` inside."""
    from emspec_torch.dsp.kernels import deposits, rfft, scatter

    if how not in PERTURBATIONS[form][1]:
        raise ValueError(f"{form} has no perturbation {how!r}")
    if form.startswith("rfft"):
        module, name = rfft, "rfft_frames"
        real = rfft.rfft_frames

        def stand_in(frames, window=None, *, power=False, route=None):
            n = frames.shape[-1]
            if how == "mirror":
                got = real(frames, window, power=power, route=route)
                if (route or rfft.route_of(n)) == "cluster":
                    bin1 = got[..., 1:2]
                    bump = torch.view_as_real(bin1) if got.is_complex() \
                        else bin1
                    bump.copy_(torch.nextafter(
                        bump, bump.new_tensor(float("inf"))))
                return got
            if how == "unscrubbed" and power:
                X = real(frames, window, route=route)
                return X.real * X.real + X.imag * X.imag
            got = real(frames, window, power=power, route=route)
            rows = got.reshape(-1, got.shape[-1])
            if how == "batch" and rows.shape[0] >= 2:
                row = torch.view_as_real(rows[1]) if got.is_complex() \
                    else rows[1]
                flat = row.reshape(-1)
                i = int(flat.abs().argmax())
                flat[i] = torch.nextafter(flat[i],
                                          flat.new_tensor(float("inf")))
            return got
    elif form.startswith("sorted"):
        module, name = scatter, "histogram"
        real = scatter.histogram

        def stand_in(ids, vals, num_bins, *a, out=None, **kw):
            if _sorted_form(ids, num_bins, kw) != form.split()[1]:
                return real(ids, vals, num_bins, *a, out=out, **kw)
            base = None if out is None else out.clone()
            got = real(ids, vals, num_bins, *a,
                       out=None if how == "out" else out, **kw)
            if how == "out" and out is not None:
                return out.copy_(got)
            if how == "reversed":
                return got.copy_(scatter.histogram_plain(
                    ids.cpu().flip(-1), vals.cpu().flip(-1), num_bins,
                    None if base is None else base.cpu()))
            return _broken(got, vals, how)
    elif form.startswith("ring"):
        module, name = scatter, "histogram_ring"
        real = scatter.histogram_ring

        def stand_in(ids, vals, ring, t, **kw):
            P, C, k = ring.shape[0], ring.shape[-1], ids.shape[-1]
            plan = scatter.ring_plan_on(ids.device, k, P, C,
                                        math.prod(ids.shape[:-1]), **kw)
            if scatter.ring_form(plan) != form.split()[1]:
                return real(ids, vals, ring, t, **kw)
            base = ring.clone()
            if how == "order":      # the windows walked last to first
                got = base.cpu()
                for lo in reversed(range(0, k, 32 * plan["window"])):
                    part = slice(lo, lo + 32 * plan["window"])
                    scatter.histogram_ring_plain(scatter.ring_ids(
                        ids.cpu()[..., part], int(t), P, C),
                        vals.cpu()[..., part], got)
                return ring.copy_(got)
            real(ids, vals, ring, t, **kw)
            if how == "dropped":    # the band of the frame's own column
                band = plan["band_slots"]
                lo = int(t) % P // band * band
                ring[lo:lo + band] = base[lo:lo + band]
                return ring
            if how == "reversed":
                return ring.copy_(scatter.histogram_ring_plain(
                    scatter.ring_ids(ids.cpu().flip(-1), int(t), P, C),
                    vals.cpu().flip(-1), base.cpu()))
            return _broken(ring, vals, how)
    else:
        module, name = deposits, "deposits_ids"
        real = deposits.deposits_ids

        def stand_in(frames, *scal, band=None, **kw):
            if band is None or how == "unweighted":
                return real(frames, *scal, **kw)
            ids, contrib = real(frames, *scal, band=band, **kw)
            moved = (contrib.reshape(-1) > 0).nonzero()[::1000, 0]
            ids = ids.clone()
            ids.view(-1)[moved] += 1
            return ids, contrib
    setattr(module, name, functools.wraps(real)(stand_in))
    try:
        yield
    finally:
        setattr(module, name, real)


def _sorted_form(ids, num_bins: int, kw: dict) -> str | None:
    """The ordered form a ``histogram`` call takes, None for another
    route."""
    from emspec_torch.dsp.kernels import scatter

    if kw.get("route") != scatter.SORTED or kw.get("reach") is None:
        return None
    c_len = kw.get("column_len") or kw["frame_len"]
    return kw.get("form") or scatter.sorted_form(
        num_bins // c_len, kw["frame_len"], kw["reach"], c_len,
        math.prod(ids.shape[:-1]))


def _broken(got: torch.Tensor, vals: torch.Tensor, how: str) -> torch.Tensor:
    flat = got.view(-1)
    if how == "ulp":
        i = int(flat.abs().argmax())
        flat[i] = torch.nextafter(flat[i], flat.new_tensor(float("inf")))
    elif how == "nan" and not bool(torch.isfinite(vals).all()):
        flat[0] = float("nan")
    return got
