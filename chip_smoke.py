"""On-card smoke run of emspec_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and nvcc; exits nonzero without
them.  Phases, in order, one line each; the first failure ends the run:

1. device: the card's name and power limit; build the CUDA kernels from
   ``emspec_torch/csrc`` and time the build.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (16 s of 48 kHz audio), with its time, the
   plain version's, one equivalent library call's where there is one
   (all CUDA events over back-to-back calls, host dispatch included),
   the device's own time per call of the kernel and of the library call
   (``device_ms``: CUDA events with the host's queueing hidden behind a
   device-side sleep), the kernels ranked by the ratio of the two, and
   its roofline bound: B1 deposits (its block route; device time also
   at b = 1, a live hop), B2 histogram at every path's real ids (batch,
   batch16, live, stress, stress live, north, north live, ext262144,
   wide, wide live), by its route and by each route forced, beside the
   parent's one-block-a-row design (the probe's ``full``), with
   ``index_add_`` as its library call, the routes and the parent in turns
   at the batch and north-live shapes, NaN/Inf behind dropped ids at
   every route and hot-cell cases (runs of 32 equal ids, a row in one
   cell, every deposit in one cell),
   B3 colormap lookup (enhanced 8192, hop 2048, 512 rows); B4 four-step
   steps 1–3 at n = 256, 1024, 4096, 8192, 16384 (the stress call's
   1,376 sequences), 32768 and 131072, each at a full batch and at b = 1
   (bit-equal to frame 0), with the kernel's and the plain version's
   error against a complex128 FFT, and its two routes timed in turns at
   16384; B5 triple windowing at the direct path's frames, from an
   aligned and a misaligned framing view; B1's cluster route at 32768
   (the stress call's 688 frames), with the clusters the card holds at
   once, timed in turns against the three-launch route it replaced
   (forced), both held to plain, both at b = 1; B1's large-frame route
   at 65536, 131072 and 262144 (8 frames), each also at b = 1; B6, the fused
   deposits histogram, against its plain version and against B1 → B2
   composed, at the batch shape (372 × 8192) and the stress shape
   (688 × 32768), with and without the streaming mask; the probe's B2
   variants at the probe's shape (688 × 16512 → 2560, half the ids −1)
   and at the batch path's ids.
3. batch: ``Pipeline.process`` on 16 s of mono audio, enhanced 8192
   (stencil) — the kernel launch counters must rise; the result must
   match the port's CPU path.
4. batch16: the same on a 16-channel batch.
5. live: ``Stream`` fed in 1024-sample chunks (375 hops) then flushed; it
   must match the batch result; per-hop latency p50/p99.
6. natural: P-natural batch — ``Settings(mode="natural",
   fft_impl="fourstep")``, the multires banks 8192/2048/512, hop 128,
   512 rows — on 16 s mono; B4 and B3 must launch; matches the CPU path.
7. natural_live: P-natural through ``Stream`` in 1024-sample pushes
   (5,937 hops of 128); must match its batch; p50/p99 per hop.
8. direct: P-direct batch — enhanced, one bank of 8192, hop 2048,
   ``fft_method="direct"``, ``fft_impl="fourstep"`` — on 16 s mono; B5,
   B4, B2 and B3 must launch; matches the CPU path.
9. direct_live: P-direct through ``Stream``; must match its batch.
10. stress: ``BASELINE.json`` config 5 — enhanced 32768 at 96 kHz, hop
   8192, 16 channels, 4 s (688 frames a call) — batch; B1's cluster
   route, B2 and B3 must launch; matches the CPU path.
11. stress_live: the same settings through ``Stream``, 16 s of 16
   channels (186 hops); must match its batch (phase stress_live_batch,
   itself held to the CPU path).
12. north: the north star — enhanced 32768 at 48 kHz, hop 800 (60
   columns a second, R = 20) — batch on 16 s mono; matches the CPU path.
13. north_live: the same through ``Stream`` in 800-sample pushes (940
   hops); must match its batch; p50/p99 beside the 10 ms budget and the
   16.7 ms hop.
14. ext262144: enhanced 262144 at 96 kHz, hop 65536, 8 s mono (8
   frames) — batch; B1's large route (with B4 inside it), B2 and B3 must
   launch; matches the CPU path.
15. wide: enhanced 8192 at hop 64 (R = 64: 66,048 relative cells, above
   a block's shared memory), 2 s mono — batch, then through ``Stream``;
   B1, B2 (on its global route) and B3 must launch; the batch matches
   the CPU path and the stream matches the batch.
16. breakdown: per-stage device times of the enhanced stencil batch
   paths (batch, batch16, stress, wide; CUDA events), the device's busy
   time per kernel and idle share of every batch cell and of a live hop
   of each path (torch.profiler busy time over the unprofiled wall time).

Every path is driven once with the launch counters set to 0 just before
and read just after; those counts are the ``launches`` of the per-kernel
JSON line.  Then that line, and as the last line
``{"ok": true, "device": {...}}``.

Tolerances (``emspec_torch.validate``): quantized power grids — total
energy ≤ 1e-4 relative, 3×3 max-filters within 1e-3·peak on all but 1e-4
of the cells (a float32 rounding flip moves a whole deposit one cell);
B1 (every route) additionally ≥ 99.99% equal ids, every other valid
deposit moved by one cell only, bins 0 and N/2 exact, and contrib within
1e-5·peak wherever both are valid, and b = 1 bit-equal to frame 0 of the
batch; B2 (each route; exact zeros), B6 (against B1 → B2 composed, with
exact zeros below min_id) and the probe's ``full`` (against B2) ≤ 1e-5
relative per nonzero bin; the other probe variants within 1e-5 of their
own plain versions; B3 and B5 bit-equal; B4 (either route) within
2e-5·max|X| (the JAX package's four-step bound); natural power grids within 1e-4·peak per cell (not quantized; float32
FFT rounding only); ``vis`` 3×3 max-filters within 2/255 on all but 1e-4
of the cells; live vs batch within 1e-5 in ``vis`` (float32 atomics and
FFT batch shapes reorder sums only).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from emspec_torch import Settings, kernels_build
from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import (
    cluster_occupancy, deposits_hist, deposits_hist_plain, deposits_ids,
    deposits_ids_cluster, deposits_ids_large, deposits_ids_plain)
from emspec_torch.dsp.kernels.fourstep import (
    SMALL_MAX, device_radix_tables, fft4_steps123, fft4_steps123_plain)
from emspec_torch.dsp.kernels.lut import lut_lookup, lut_lookup_plain
from emspec_torch.dsp.kernels.scatter import (
    ROUTES, SMEM_BINS, histogram, histogram_plain, route_of)
from emspec_torch.dsp.kernels.window import (
    w3_table, windowed_frames, windowed_frames_plain)
from emspec_torch.pipeline import Pipeline
from emspec_torch.post.chain import PostState, postprocess_batch
from emspec_torch.post.colormap import apply_lut
from emspec_torch.probes.scatter_ablation import (
    VARIANTS, hist_variant, hist_variant_plain)
from emspec_torch.stream import Stream
from emspec_torch.validate import compare_grids, compare_vis

SR = 48_000
SECONDS = 16.0
SETTINGS = Settings(mode="enhanced", multires=False, fft_size=8192)
NATURAL = Settings(mode="natural", fft_impl="fourstep")
DIRECT = Settings(mode="enhanced", multires=False, fft_size=8192,
                  fft_method="direct", fft_impl="fourstep")
STRESS = Settings(mode="enhanced", multires=False, fft_size=32768,
                  sample_rate=96000, channels=16)
NORTH = Settings(mode="enhanced", multires=False, fft_size=32768, hop=800)
EXT = Settings(mode="enhanced", multires=False, fft_size=262144,
               sample_rate=96000)
WIDE = Settings(mode="enhanced", multires=False, fft_size=8192, hop=64)
CHANNELS = 16
STREAM_VIS_ATOL = 1e-5           # atomics / batch shapes reorder float32 sums
B4_TOL = 2e-5                    # · max|X|
NATURAL_POWER_TOL = 1e-4         # · peak
PEAK_BYTES_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_S = 67e12              # H100 SXM float32 outside the tensor cores
KERNELS = (
    ("deposits_ids", deposits_ids, "emspec_torch/csrc/deposits.cu",
     "emspec/dsp/pallas/fft4.py:404"),
    ("histogram", histogram, "emspec_torch/csrc/histogram.cu",
     "emspec/dsp/pallas/scatter.py:135"),
    ("lut_lookup", lut_lookup, "emspec_torch/csrc/lut.cu",
     "emspec/dsp/pallas/lut.py:43"),
    ("fft4_steps123", fft4_steps123, "emspec_torch/csrc/fourstep.cu",
     "emspec/dsp/pallas/fft4.py:130"),
    ("windowed_frames", windowed_frames, "emspec_torch/csrc/window.cu",
     "emspec/dsp/pallas/window.py:41"),
    ("deposits_ids_cluster", deposits_ids_cluster,
     "emspec_torch/csrc/deposits.cu", "emspec/dsp/pallas/fft4.py:404"),
    ("deposits_ids_large", deposits_ids_large,
     "emspec_torch/csrc/deposits_large.cu", "emspec/dsp/pallas/fft4.py:404"),
    ("deposits_hist", deposits_hist, "emspec_torch/csrc/deposits.cu",
     "emspec/dsp/pallas/fft4.py:616"),
    ("hist_variant", hist_variant, "emspec_torch/csrc/scatter_ablation.cu",
     "bench_probes/scatter_ablation.py:93"),
)
CLUSTER_PATH = ("deposits_ids_cluster", "histogram", "lut_lookup")
LARGE_PATH = ("deposits_ids_large", "fft4_steps123", "histogram",
              "lut_lookup")
PATH_KERNELS = {        # kernels each path must launch
    "batch": ("deposits_ids", "histogram", "lut_lookup"),
    "batch16": ("deposits_ids", "histogram", "lut_lookup"),
    "live": ("deposits_ids", "histogram", "lut_lookup"),
    "natural": ("fft4_steps123", "lut_lookup"),
    "natural_live": ("fft4_steps123", "lut_lookup"),
    "direct": ("windowed_frames", "fft4_steps123", "histogram", "lut_lookup"),
    "direct_live": ("windowed_frames", "fft4_steps123", "histogram",
                    "lut_lookup"),
    "stress": CLUSTER_PATH,
    "stress_live_batch": CLUSTER_PATH,
    "stress_live": CLUSTER_PATH,
    "north": CLUSTER_PATH,
    "north_live": CLUSTER_PATH,
    "ext262144": LARGE_PATH,
    "wide": ("deposits_ids", "histogram", "lut_lookup"),
    "wide_live": ("deposits_ids", "histogram", "lut_lookup"),
}
LAUNCHES: dict = {}     # path → {kernel: launches in its one driven run}
ROUTE_LAUNCHES: dict = {}   # path → {B2 route: launches in that run}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def signal(seconds: float, channels: int = 1, seed: int = 0,
           sr: int = SR) -> np.ndarray:
    """Linear chirp to 9 kHz (channel c starts at 100 + c·150 Hz), three
    tones of 0.1 and 1% Gaussian noise from ``seed``, at ``sr`` Hz."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0, 1320.0))
    out = []
    for c in range(channels):
        f0 = 100.0 + 150.0 * c
        chirp = 0.5 * np.sin(2 * np.pi * (f0 * t + 0.5 * (9000.0 - f0)
                                          / seconds * t * t))
        x = chirp + tones + 0.01 * rng.standard_normal(t.size)
        out.append(x.astype(np.float32))
    return out[0] if channels == 1 else np.stack(out)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20) -> float:
    """The device's own time per call of ``fn`` in ms: CUDA events around
    ``calls`` back-to-back calls queued behind a device-side sleep, so the
    host's dispatch (ctypes, argument checks, allocation) overlaps the
    sleep and not the calls.  Fails unless the queueing ended well inside
    the sleep.  (torch.profiler cannot serve here: it leaves every later
    launch slower on the host, and late in a long run it drops kernel
    records.)"""
    fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(3):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if queued_ms < 0.5 * marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / calls
        cycles *= 4
    fail(f"device_ms: queueing {calls} calls took {queued_ms:.3f} ms, "
         f"longer than the sleep in front of them")


def times(fn, plain, library=None, iters: int = 20, warmup: int = 3) -> dict:
    """The kernel's, its plain version's and the library call's ms by CUDA
    events over back-to-back calls (each call's host dispatch included),
    and the device's own time per call of the kernel and of the library
    call (``device_ms``, ``library_device_ms``)."""
    return dict(
        ms=cuda_ms(fn, iters, warmup), plain_ms=cuda_ms(plain, iters, warmup),
        library_ms=None if library is None else cuda_ms(library, iters,
                                                        warmup),
        device_ms=device_ms(fn),
        library_device_ms=None if library is None else device_ms(library))


def bound(nbytes: float, ops: float) -> dict:
    """Roofline bound: the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def dft_ops(n: int) -> float:
    """A complex n-point DFT counted as 5·n·log2 n, however it runs."""
    return 5.0 * n * math.log2(n)


def reset_counters() -> None:
    for _, wrapper, _, _ in KERNELS:
        wrapper.launches = 0
    histogram.route_launches.update(dict.fromkeys(ROUTES, 0))


def counters() -> dict:
    return {name: wrapper.launches for name, wrapper, _, _ in KERNELS}


def drive(path: str, fn):
    """Run one path once with the counters set to 0 just before and read
    just after; fail unless each of the path's kernels launched."""
    reset_counters()
    out = fn()
    torch.cuda.synchronize()
    LAUNCHES[path] = counters()
    ROUTE_LAUNCHES[path] = dict(histogram.route_launches)
    missing = [k for k in PATH_KERNELS[path] if LAUNCHES[path][k] == 0]
    check(not missing, f"{path}: kernels of the path did not launch: "
          f"{missing} ({LAUNCHES[path]})")
    return out


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t0 = time.perf_counter()
    kernels_build.library()
    build_s = time.perf_counter() - t0
    print(smi, flush=True)
    print(f"device: {smi}  torch {torch.__version__} cuda "
          f"{torch.version.cuda}; kernels built in {build_s:.2f} s "
          f"({kernels_build.library_path().name})", flush=True)
    return torch.device("cuda")


def check_b1(label: str, ik, ck, ip, cp, *, n: int, rows: int, R: int,
             ) -> float:
    """B1 (either route) against its plain version → the largest contrib
    error.  Compared as histograms (DESIGN.md §9) and per deposit.
    Invalid deposits carry contrib 0 (the kernel's id is −1, the plain
    one's a clamped row).  A float32 rounding flip may move a valid
    deposit one row or one column; its contrib = |X_h|²/N² must agree
    regardless."""
    S = (2 * R + 1) * rows
    g = compare_grids(histogram_plain(ip, cp, S).reshape(-1, 2 * R + 1, rows),
                      histogram_plain(ik, ck, S).reshape(-1, 2 * R + 1, rows))
    vk, vp = ck > 0, cp > 0
    both = vk & vp
    agree = (both & (ik == ip)) | (~vk & ~vp)
    id_agree = float(agree.float().mean())
    moved = (ik - ip).abs()[both & (ik != ip)]
    one_cell = bool(torch.isin(moved, torch.tensor(
        [1, rows - 1, rows, rows + 1], device=ik.device)).all())
    edges_exact = bool(agree[..., [0, n // 2]].all())   # Hermitian stencils
    err = float((ck - cp)[both].abs().max())
    peak = float(cp.max())
    check(g.ok and id_agree >= 0.9999 and one_cell and edges_exact
          and bool((ik[~vk] == -1).all()) and err <= 1e-5 * peak,
          f"{label} deposits vs plain: {g}, id agreement {id_agree}, moves "
          f"of one cell only {one_cell}, bins 0 and N/2 exact {edges_exact}, "
          f"contrib err {err} vs peak {peak}")
    print(f"{label}: ids equal {id_agree:.6f}, energy {g.energy_rel:.2e}, "
          f"maxf {g.maxf_rel:.2e}, contrib err {err / peak:.2e}·peak",
          flush=True)
    return err


def check_b1_single(label: str, frames, ik, ck, scal, kw, **route) -> None:
    """b = 1 (a live hop: the first frame as an (N,) window) must give
    frame 0 of the batch bit for bit: a frame's arithmetic does not
    depend on the batch."""
    n = kw["n"]
    i1, c1 = deposits_ids(frames.reshape(-1, n)[0], *scal, **kw, **route)
    check(torch.equal(i1, ik.reshape(-1, n // 2 + 1)[0])
          and torch.equal(c1, ck.reshape(-1, n // 2 + 1)[0]),
          f"{label} n={n}: b = 1 differs from frame 0 of the batch")


def frame_bytes(frames) -> float:
    """Bytes of the distinct float32 samples a framing view covers: its
    frames overlap where the hop is below N, and each input byte counts
    once."""
    n = frames.shape[-1]
    f = frames.reshape((-1,) + tuple(frames.shape[-2:]) if frames.dim() > 1
                       else (1, 1, n))
    return 4.0 * f.shape[0] * ((f.shape[1] - 1) * min(f.stride(1), n) + n)


def b1_bound(frames) -> dict:
    """B1's roofline bound on these frames: their distinct samples read,
    ids and contrib written, the t·h and twiddle tables; two real n-point
    DFTs (half a complex one each), the t·h window and ~40 operations a
    bin for stencils, corrections and quantization."""
    n = frames.shape[-1]
    b, k = frames.numel() // n, n // 2 + 1
    return bound(frame_bytes(frames) + 8 * b * k + 4 * n + 4 * n + 12,
                 b * (dft_ops(n) + n + 40 * k))


def kernels_b123(dev, pipe: Pipeline, p) -> dict:
    n, hop, rows, R = pipe.n_max, pipe.hop, pipe.rows, pipe.reach
    S = (2 * R + 1) * rows
    x = torch.from_numpy(signal(SECONDS, seed=1)).to(dev)
    frames = frame_signal(x, n, hop)                       # (372, 8192)
    b = frames.shape[0]
    kw = dict(n=n, hop=hop, sr=float(SR), rows=rows, reach=R)
    scal = (p.logmap_a, p.logmap_b, p.power_floor)
    res = {}

    ik, ck = deposits_ids(frames, *scal, **kw)
    ip, cp = deposits_ids_plain(frames, *scal, **kw)
    err_b1 = check_b1("B1", ik, ck, ip, cp, n=n, rows=rows, R=R)
    check_b1_single("B1", frames, ik, ck, scal, kw)
    res["deposits_ids"] = dict(
        at=f"frames ({b}, {n})", max_abs_err=err_b1,
        **times(lambda: deposits_ids(frames, *scal, **kw),
                lambda: deposits_ids_plain(frames, *scal, **kw)),
        **b1_bound(frames),
        device_ms_b1=device_ms(lambda: deposits_ids(frames[0], *scal, **kw)),
        bound_ms_b1=b1_bound(frames[0])["bound_ms"])

    res["histogram"] = kernels_b2(dev, ik, ck, S)

    # B3 at the batch raster (t, rows): bit-equal
    idx = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (b, rows)).astype(np.int32)).to(dev)
    lk, lp = lut_lookup(idx, p.lut), lut_lookup_plain(idx, p.lut)
    check(torch.equal(lk, lp), "B3 lut_lookup differs from table[idx]")
    flat_idx = idx.reshape(-1)
    res["lut_lookup"] = dict(
        at=f"idx ({b}, {rows})",
        max_abs_err=float((lk.int() - lp.int()).abs().max()),
        **times(lambda: lut_lookup(idx, p.lut),
                lambda: lut_lookup_plain(idx, p.lut),
                lambda: torch.index_select(p.lut, 0, flat_idx)),
        **bound(4 * idx.numel() + 1024 + 4 * idx.numel(), 0.0))
    return res


# B2 at each path's real ids (rows × m → cells): the shape and the B1
# call that makes them.  The live hops take one frame of their batch.
# "parent" is B2's earlier design — one block a row, an atomic a deposit,
# no warp merging, 4-byte loads — which the probe keeps as its "full"
# variant (scatter_ablation.cu).
B2_IN_TURNS = ("batch", "north_live")
B2_TURNS = ("global", "row", "parent", "parent", "row", "global")


def relative_ids(dev, settings: Settings, x: np.ndarray):
    """The path's B1 ids and contrib on ``x`` and its relative cells."""
    pipe = Pipeline(settings.replace(
        channels=1 if x.ndim == 1 else x.shape[0]), dev)
    frames = frame_signal(pipe.to_device(x), pipe.n_max, pipe.hop)
    ids, contrib = pipe._deposit_ids_rel(frames, pipe.params())
    return ids, contrib, (2 * pipe.reach + 1) * pipe.rows


def b2_cases(dev, ik, ck, S) -> list:
    """(label, ids, vals, cells) at every path's B2 shape."""
    mid = ik.shape[0] // 2
    cases = [("batch", ik, ck, S),
             ("batch16", *relative_ids(
                 dev, SETTINGS, signal(SECONDS, CHANNELS, seed=3))),
             ("live", ik[mid], ck[mid], S)]
    si, sc, ss = relative_ids(dev, STRESS,
                              signal(4.0, CHANNELS, seed=13, sr=96000))
    mid = si.shape[1] // 2
    cases += [("stress", si, sc, ss),
              ("stress_live", si[:, mid].contiguous(),
               sc[:, mid].contiguous(), ss)]
    ni, nc, ns = relative_ids(dev, NORTH, signal(SECONDS))
    mid = ni.shape[0] // 2
    cases += [("north", ni, nc, ns), ("north_live", ni[mid], nc[mid], ns)]
    cases.append(("ext262144", *relative_ids(
        dev, EXT, signal(8.0, seed=15, sr=96000))))
    wi, wc, ws = relative_ids(dev, WIDE, signal(2.0, seed=16))
    mid = wi.shape[0] // 2
    cases += [("wide", wi, wc, ws), ("wide_live", wi[mid], wc[mid], ws)]
    return cases


def check_b2(label: str, ids, vals, S: int, route=None) -> float:
    """B2 (the route by shape, or ``route``) against plain: 1e-5 relative
    per nonzero bin, exact zeros elsewhere → the largest abs error."""
    hk, hp = histogram(ids, vals, S, route=route), histogram_plain(ids, vals, S)
    nz = hp != 0
    rel = float(((hk - hp).abs()[nz] / hp[nz].abs()).max()) if nz.any() else 0.0
    check(rel <= 1e-5 and bool((hk[~nz] == 0).all())
          and bool(torch.isfinite(hk).all()),
          f"B2 {label} route {route or 'by shape'} vs plain: rel {rel}")
    return float((hk - hp).abs().max())


def check_b2_dropped(label: str, ids, vals, S: int, route) -> None:
    """A NaN or Inf behind a dropped id (−1, or ≥ the cells) must not land:
    the result stays finite and equal to plain."""
    i, v = ids.clone().reshape(-1), vals.clone().reshape(-1)
    i[::7], v[::7] = -1, float("nan")
    i[3::7], v[3::7] = S + 5, float("inf")
    check_b2(f"{label} dropped NaN/Inf", i.reshape(ids.shape),
             v.reshape(ids.shape), S, route)


def clustered_cases(dev, rows: int, m: int, S: int) -> list:
    """Hot cells: runs of 32 equal ids; row 0 all in one cell (the rest
    random); every deposit in one cell."""
    g = torch.Generator(device=dev).manual_seed(17)
    vals = torch.rand((rows, m), generator=g, device=dev)
    runs = torch.randint(0, S, (rows, -(-m // 32)), generator=g, device=dev,
                         dtype=torch.int32).repeat_interleave(32, 1)[:, :m]
    one_row = torch.randint(0, S, (rows, m), generator=g, device=dev,
                            dtype=torch.int32)
    one_row[0] = S // 3
    one = torch.full((rows, m), S // 3, dtype=torch.int32, device=dev)
    return [("runs32", runs.contiguous(), vals), ("one_cell_row", one_row,
                                                  vals), ("one_cell", one, vals)]


def b2_call(ids, vals, cells: int, route: str):
    """One B2 call by ``route``; "parent" is the probe's ``full``."""
    if route == "parent":
        m = ids.shape[-1]
        return hist_variant(ids.reshape(-1, m), vals.reshape(-1, m), cells,
                            "full")
    return histogram(ids, vals, cells, route=route)


def kernels_b2(dev, ik, ck, S) -> dict:
    """B2 at every path's shape, by its route and by each route forced
    (each held to plain, and with NaN/Inf behind dropped ids), the
    parent's one-block-a-row design beside them; times, bound and
    ``index_add_`` per shape; the routes and the parent in turns at the
    batch and north-live shapes; hot-cell cases at the batch shape."""
    shapes, lines, worst = {}, [], 0.0
    for label, ids, vals, cells in b2_cases(dev, ik, ck, S):
        m = ids.shape[-1]
        rows = ids.numel() // m
        route = route_of(rows, m, cells)
        err = check_b2(label, ids, vals, cells)
        worst = max(worst, err)
        route_dev = {}
        for r in ROUTES:
            if r == "global" or cells <= SMEM_BINS:
                check_b2(label, ids, vals, cells, r)
                check_b2_dropped(label, ids, vals, cells, r)
                route_dev[r] = device_ms(
                    lambda: histogram(ids, vals, cells, route=r))
        if cells <= SMEM_BINS:
            route_dev["parent"] = device_ms(
                lambda: b2_call(ids, vals, cells, "parent"))
        ok_ids = (ids >= 0) & (ids < cells)
        flat = (torch.where(ok_ids, ids, cells).long().reshape(rows, m)
                + (torch.arange(rows, device=dev) * (cells + 1))[:, None]
                ).reshape(-1)
        vals0 = torch.where(ok_ids, vals, 0.0).reshape(-1)
        row = dict(
            at=f"ids ({rows}, {m}) → {cells} bins", hist_route=route,
            max_abs_err=err,
            **times(lambda: histogram(ids, vals, cells),
                    lambda: histogram_plain(ids, vals, cells),
                    lambda: torch.zeros(rows * (cells + 1),
                                        device=dev).index_add_(0, flat, vals0),
                    iters=10),
            **bound(8 * rows * m + 4 * rows * cells, float(ok_ids.sum())),
            route_device_ms=route_dev)
        if label in B2_IN_TURNS:
            turns = {}
            for r in B2_TURNS:
                turns.setdefault(r, []).append(device_ms(
                    lambda: b2_call(ids, vals, cells, r)))
            row["in_turns_device_ms"] = turns
        shapes[label] = row
        lines.append(
            f"{label} ({rows} × {m} → {cells}): route {route}, device "
            f"{row['device_ms']:.4f} ms (each route: " + ", ".join(
                f"{r} {t:.4f}" for r, t in route_dev.items())
            + f"), bound {row['bound_ms']:.4f} {row['bound_by']}, index_add_ "
            f"device {row['library_device_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f} ms, events {row['ms']:.4f} ms"
            + (f", in turns {row['in_turns_device_ms']}"
               if label in B2_IN_TURNS else ""))
    rows, m = ik.shape
    clustered = {}
    for label, ids, vals in clustered_cases(dev, rows, m, S):
        clustered[label] = {}
        for r in ROUTES:
            check_b2(f"{label} at {rows} × {m}", ids, vals, S, r)
            check_b2_dropped(label, ids, vals, S, r)
            clustered[label][r] = device_ms(
                lambda: histogram(ids, vals, S, route=r))
    lines.append(f"hot cells at {rows} × {m} → {S}, device ms by route: "
                 f"{clustered}")
    print("kernels B2 (each shape and route held to plain, NaN/Inf behind "
          "dropped ids at every route): " + "; ".join(lines), flush=True)
    return dict(shapes["batch"], max_abs_err=worst, shapes=shapes,
                clustered_device_ms=clustered)


# B4 sizes: the complex transform size n = N/2 of each path's real frames
# and the batch one 16 s call gives it (natural banks 8192/2048/512 at
# hop 128: 5,937 frames; direct 8192 at hop 2048: 3 × 372 windowed
# frames; the stress call's 2 × 688 packed sequences of 16384), plus 8192
# and 32768 (the north star's frame size, halved and whole) at 16 s of
# their hop N/4, and 131072 (B1's large route at 262144) at 16.
B4_CASES = ((256, 5937), (1024, 5937), (4096, 5937), (4096, 1116),
            (8192, 372), (16384, 1376), (32768, 93), (131072, 16))
B4_REPORTED = (4096, 5937)         # the natural 8192-bank call
B4_STRESS = (16384, 1376)          # inside B1's large route at the stress call


def f64_err(xr, xi, ref) -> float:
    """max |X − ref| / max |ref| of X[k1, k2] against ref, complex128."""
    return float(torch.maximum((xr.double() - ref.real).abs().max(),
                               (xi.double() - ref.imag).abs().max())
                 / ref.abs().max())


def kernels_b4(dev, rng) -> dict:
    """B4 at each of ``B4_CASES``, at the full batch and at b = 1 (frame 0,
    bit for bit): against its plain version (2e-5·max|X|) and, reported,
    both against a complex128 ``torch.fft.fft`` of the same input
    reindexed to [k1, k2]; at 16384 the two routes in turns."""
    res, lines = {}, []
    for n, full in B4_CASES:
        n1, n2 = fourstep._FACTORS[n]
        zr, zi = (torch.from_numpy(rng.standard_normal(
            (full, n1, n2)).astype(np.float32)).to(dev) for _ in range(2))
        kr, ki = fft4_steps123(zr, zi)
        pr, pi = fft4_steps123_plain(zr, zi)
        scale = float(torch.complex(pr, pi).abs().max())
        err = float(torch.maximum((kr - pr).abs().max(), (ki - pi).abs().max()))
        check(err <= B4_TOL * scale, f"B4 n={n} b={full}: max err {err} vs "
              f"{B4_TOL}·max|X| = {B4_TOL * scale}")
        sr, si = fft4_steps123(zr[:1].clone(), zi[:1].clone())
        p1r, p1i = fft4_steps123_plain(zr[:1], zi[:1])
        err1 = float(torch.maximum((sr - p1r).abs().max(),
                                   (si - p1i).abs().max()))
        check(err1 <= B4_TOL * float(torch.complex(p1r, p1i).abs().max()),
              f"B4 n={n} b=1: max err {err1}")
        check(torch.equal(sr, kr[:1]) and torch.equal(si, ki[:1]),
              f"B4 n={n}: b = 1 differs from frame 0 of the batch")
        ref = torch.fft.fft(torch.complex(zr.double(), zi.double()).reshape(
            full, n)).reshape(full, n2, n1).transpose(1, 2)
        f64 = dict(kernel=f64_err(kr, ki, ref), plain=f64_err(pr, pi, ref))
        del ref
        z = torch.complex(zr, zi).reshape(full, n)
        tab = sum(t.numel() for t in device_radix_tables(n1, n2, dev))
        row = dict(
            at=f"(b, n1, n2) = ({full}, {n1}, {n2})", max_abs_err=err,
            rel_err=err / scale, rel_err_f64=f64,
            **times(lambda: fft4_steps123(zr, zi),
                    lambda: fft4_steps123_plain(zr, zi),
                    lambda: torch.fft.fft(z)),
            **bound(16 * full * n + 4 * tab, full * dft_ops(n)))
        lines.append(f"n={n} b={full} {row['ms']:.4f} ms (device "
                     f"{row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                     f"torch.fft.fft {row['library_ms']:.4f} / device "
                     f"{row['library_device_ms']:.4f}, bound "
                     f"{row['bound_ms']:.4f} {row['bound_by']}; err vs plain "
                     f"{err / scale:.2e}·max|X|, vs complex128: kernel "
                     f"{f64['kernel']:.2e}, plain {f64['plain']:.2e})")
        if (n, full) == B4_STRESS:
            lr, li = fft4_steps123(zr, zi, route="large")
            err_l = float(torch.maximum((lr - pr).abs().max(),
                                        (li - pi).abs().max()))
            check(err_l <= B4_TOL * scale, f"B4 n={n} large route: {err_l}")
            routes = {}
            for r in ("small", "large", "large", "small"):      # in turns
                routes.setdefault(r, []).append(cuda_ms(
                    lambda: fft4_steps123(zr, zi, route=r)))
            row["route_ms"] = routes
            row["route_device_ms"] = {r: device_ms(
                lambda: fft4_steps123(zr, zi, route=r))
                for r in ("small", "large")}
            lines.append(f"n={n} routes in turns (small, large, large, "
                         f"small): {routes}, device {row['route_device_ms']}"
                         f" (threshold n1·n2 <= {SMALL_MAX} takes small)")
            res["fft4_steps123_stress"] = row
        if (n, full) == B4_REPORTED:
            res["fft4_steps123"] = row
    res["fft4_steps123"] = dict(res["fft4_steps123"],
                                at_stress=res.pop("fft4_steps123_stress"))
    print("kernels B4: " + "; ".join(lines) + "; every size also at b = 1, "
          "bit-equal to frame 0", flush=True)
    return res


def kernels_b5(dev) -> dict:
    res = {}
    # B5 at the direct path's frames: bit-equal, also on a 1-D window and
    # on the same framing 4 bytes into the signal (4-byte loads)
    x = torch.from_numpy(signal(SECONDS, seed=5)).to(dev)
    frames = frame_signal(x, DIRECT.fft_size, DIRECT.hop_samples)
    mis = frame_signal(x[1:], DIRECT.fft_size, DIRECT.hop_samples)
    check(frames.data_ptr() % 16 == 0 and mis.data_ptr() % 16 != 0,
          "B5: the aligned and misaligned views are not what they claim")
    wk, wp = windowed_frames(frames), windowed_frames_plain(frames)
    check(torch.equal(wk, wp), "B5 windowed_frames differs from frames·w3")
    check(torch.equal(windowed_frames(frames[3]),
                      windowed_frames_plain(frames[3])),
          "B5 windowed_frames differs on a single (N,) window")
    check(torch.equal(windowed_frames(mis), windowed_frames_plain(mis)),
          "B5 windowed_frames differs on a misaligned view")
    r, n = frames.shape
    w3 = w3_table(n, dev).reshape(3, 1, n)
    mis_t = times(lambda: windowed_frames(mis),
                  lambda: windowed_frames_plain(mis), lambda: mis[None] * w3)
    res["windowed_frames"] = dict(
        at=f"frames ({r}, {n})", max_abs_err=float((wk - wp).abs().max()),
        **times(lambda: windowed_frames(frames),
                lambda: windowed_frames_plain(frames),
                lambda: frames[None] * w3),
        **bound(frame_bytes(frames) + 12 * r * n + 12 * n, 3.0 * r * n),
        misaligned={k: mis_t[k] for k in ("ms", "device_ms", "library_ms",
                                          "library_device_ms")})
    print(f"kernels B5: aligned device {res['windowed_frames']['device_ms']:.4f}"
          f" ms (library {res['windowed_frames']['library_device_ms']:.4f}); "
          f"misaligned device {mis_t['device_ms']:.4f} ms (library "
          f"{mis_t['library_device_ms']:.4f}); bound "
          f"{res['windowed_frames']['bound_ms']:.4f} ms", flush=True)
    return res


# B1 above 16384: 32768 at the stress call (4 s of 16 channels at 96 kHz,
# hop 8192: 688 frames) on the cluster route, 65536–262144 at 8 frames of
# hop N/4 on the large route (262144: the ext262144 call)
LARGE_CASES = ((32768, None), (65536, 8), (131072, 8), (262144, 8))
CLUSTER_ROUTES = ("cluster", "large", "large", "cluster")     # in turns


def stress_frames(dev, n: int = 32768, seconds: float = 4.0):
    pipe = Pipeline(STRESS.replace(channels=1, fft_size=n), dev)
    x = torch.from_numpy(signal(seconds, CHANNELS, seed=11, sr=96000)).to(dev)
    return pipe, frame_signal(x, n, pipe.hop)                # (16, 43, n)


def kernels_large(dev) -> dict:
    res, lines = {}, []
    for n, b in LARGE_CASES:
        if b is None:
            pipe, frames = stress_frames(dev, n)
        else:
            pipe = Pipeline(EXT.replace(fft_size=n), dev)
            x = torch.from_numpy(signal((b - 1) * (n // 4) / 96000 + n / 96000,
                                        seed=n % 97, sr=96000)).to(dev)
            frames = frame_signal(x, n, pipe.hop)
        p = pipe.params()
        scal = (p.logmap_a, p.logmap_b, p.power_floor)
        kw = dict(n=n, hop=pipe.hop, sr=96000.0, rows=pipe.rows,
                  reach=pipe.reach)
        flat = frames.reshape(-1, n)
        bf = flat.shape[0]
        ik, ck = deposits_ids(frames, *scal, **kw)
        ip, cp = deposits_ids_plain(frames, *scal, **kw)
        err = check_b1(f"B1 n={n} b={bf}", ik, ck, ip, cp, n=n,
                       rows=pipe.rows, R=pipe.reach)
        check_b1_single("B1", frames, ik, ck, scal, kw)
        row = dict(at=f"frames ({bf}, {n})", max_abs_err=err,
                   **times(lambda: deposits_ids(frames, *scal, **kw),
                           lambda: deposits_ids_plain(frames, *scal, **kw),
                           iters=5, warmup=2),
                   **b1_bound(frames),
                   ms_b1=cuda_ms(lambda: deposits_ids(flat[0], *scal, **kw),
                                 10, 2),
                   device_ms_b1=device_ms(
                       lambda: deposits_ids(flat[0], *scal, **kw)),
                   bound_ms_b1=b1_bound(flat[0])["bound_ms"])
        lines.append(f"n={n} b={bf} {row['ms']:.4f} ms (device "
                     f"{row['device_ms']:.4f}, b=1 {row['ms_b1']:.4f} / "
                     f"device {row['device_ms_b1']:.4f}, plain "
                     f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                     f"{row['bound_by']})")
        if n == 32768:
            # the three-launch route it replaced, forced: held to plain
            # and to b = 1, then both routes in turns
            il, cl = deposits_ids(frames, *scal, **kw, route="large")
            row["max_abs_err_large"] = check_b1(
                f"B1 forced large route n={n} b={bf}", il, cl, ip, cp, n=n,
                rows=pipe.rows, R=pipe.reach)
            check_b1_single("B1 forced large route", frames, il, cl, scal, kw,
                            route="large")
            route_ms, route_dev, route_dev1 = {}, {}, {}
            for r in CLUSTER_ROUTES:
                route_ms.setdefault(r, []).append(cuda_ms(
                    lambda: deposits_ids(frames, *scal, **kw, route=r), 5, 2))
                route_dev.setdefault(r, []).append(device_ms(
                    lambda: deposits_ids(frames, *scal, **kw, route=r)))
                route_dev1.setdefault(r, []).append(device_ms(
                    lambda: deposits_ids(flat[0], *scal, **kw, route=r)))
            row.update(route_ms=route_ms, route_device_ms=route_dev,
                       route_device_ms_b1=route_dev1,
                       clusters_at_once=cluster_occupancy(dev))
            lines.append(f"n={n} routes in turns {CLUSTER_ROUTES}: events "
                         f"{route_ms}, device {route_dev}, device at b = 1 "
                         f"{route_dev1}; {row['clusters_at_once']} two-CTA "
                         f"clusters at once")
            res["deposits_ids_cluster"] = row
        if n == EXT.fft_size:
            res["deposits_ids_large"] = row
    print("kernels B1 above 16384: " + "; ".join(lines), flush=True)
    return res


def kernels_fused(dev, pipe: Pipeline, p) -> dict:
    """B6 against plain and B1 → B2 composed at the batch shape and the
    stress shape; the probe's variants at the probe's shape and at the
    batch path's ids."""
    res, lines, rows_b6 = {}, [], {}
    x = torch.from_numpy(signal(SECONDS, seed=1)).to(dev)
    cases = [("batch", frame_signal(x, pipe.n_max, pipe.hop), p,
              dict(n=pipe.n_max, hop=pipe.hop, sr=float(SR), rows=pipe.rows,
                   reach=pipe.reach))]
    spipe, sframes = stress_frames(dev)
    cases.append(("stress", sframes, spipe.params(),
                  dict(n=32768, hop=spipe.hop, sr=96000.0, rows=spipe.rows,
                       reach=spipe.reach)))
    for label, frames, pp, kw in cases:
        scal = (pp.logmap_a, pp.logmap_b, pp.power_floor)
        n, rows = kw["n"], kw["rows"]
        S = (2 * kw["reach"] + 1) * rows
        ids, contrib = deposits_ids(frames, *scal, **kw)
        worst = 0.0
        for min_id in (-2**30, 2 * rows):
            got = deposits_hist(frames, *scal, min_id, **kw)
            want = histogram(torch.where(ids >= min_id, ids, -1), contrib, S)
            nz = want > 0
            rel = float(((got - want).abs()[nz] / want[nz]).max())
            worst = max(worst, rel)
            check(rel <= 1e-5 and bool((got[~nz] == 0).all())
                  and (min_id < 0 or float(got[..., :min_id].abs().max()) == 0),
                  f"B6 {label} min_id={min_id} vs B1 → B2: rel {rel}")
            g = compare_grids(deposits_hist_plain(
                frames, *scal, min_id, **kw).reshape(-1, S // rows, rows),
                got.reshape(-1, S // rows, rows))
            check(g.ok, f"B6 {label} min_id={min_id} vs plain: {g}")
        b = frames.numel() // n
        row = dict(
            at=f"frames ({b}, {n}) → {S} bins", max_abs_err=worst,
            **times(lambda: deposits_hist(frames, *scal, -2**30, **kw),
                    lambda: deposits_hist_plain(frames, *scal, -2**30, **kw),
                    iters=5, warmup=2),
            composed_ms=cuda_ms(lambda: histogram(
                *deposits_ids(frames, *scal, **kw), S), 5, 2),
            **bound(frame_bytes(frames) + 4 * b * S + 8 * n + 12,
                    b * (dft_ops(n) + n + 40 * (n // 2 + 1))
                    + float((contrib > 0).sum())))
        lines.append(f"B6 {label} {row['ms']:.4f} ms vs B1 → B2 "
                     f"{row['composed_ms']:.4f} ms (plain "
                     f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
                     f"{row['bound_by']}, rel err {worst:.2e})")
        rows_b6[label] = row
    res["deposits_hist"] = dict(rows_b6["stress"], at_batch=rows_b6["batch"])

    # the probe: B2's stages stubbed one at a time
    rng = np.random.default_rng(0)
    b, m, S = 688, 16512, 2560                    # scatter_ablation.py:134-139
    pid = rng.integers(0, S, size=(b, m)).astype(np.int32)
    pid[rng.random((b, m)) < 0.5] = -1
    probe_cases = [("probe", torch.from_numpy(pid).to(dev),
                    torch.from_numpy(rng.random((b, m)).astype(
                        np.float32)).to(dev), S)]
    n = pipe.n_max
    ik, ck = deposits_ids(frame_signal(x, n, pipe.hop), p.logmap_a,
                          p.logmap_b, p.power_floor, n=n, hop=pipe.hop,
                          sr=float(SR), rows=pipe.rows, reach=pipe.reach)
    probe_cases.append(("batch ids", ik, ck, (2 * pipe.reach + 1) * pipe.rows))
    for label, ids, vals, S in probe_cases:
        variant_ms = {}
        for variant in VARIANTS:
            got = hist_variant(ids, vals, S, variant)
            want = hist_variant_plain(ids, vals, S, variant)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            check(err <= 1e-5 * scale, f"probe {variant} at {label}: "
                  f"{err} vs 1e-5·{scale}")
            if variant == "full":
                hb = histogram(ids, vals, S)
                nz = hb > 0
                rel = float(((got - hb).abs()[nz] / hb[nz]).max())
                check(rel <= 1e-5 and bool((got[~nz] == 0).all()),
                      f"probe full at {label} vs B2: rel {rel}")
            variant_ms[variant] = cuda_ms(
                lambda: hist_variant(ids, vals, S, variant))
        lines.append(f"probe at {label} ({ids.shape[0]} × {ids.shape[1]} → "
                     f"{S}): " + ", ".join(f"{v} {t:.4f} ms"
                                           for v, t in variant_ms.items()))
        if label == "probe":
            ok_ids = (ids >= 0) & (ids < S)
            flat = (torch.where(ok_ids, ids, S).long()
                    + (torch.arange(ids.shape[0], device=dev)
                       * (S + 1))[:, None]).reshape(-1)
            vals0 = torch.where(ok_ids, vals, 0.0).reshape(-1)
            res["hist_variant"] = dict(
                at=f"ids ({ids.shape[0]}, {ids.shape[1]}) → {S} bins, half −1",
                max_abs_err=rel,
                **times(lambda: hist_variant(ids, vals, S, "full"),
                        lambda: hist_variant_plain(ids, vals, S, "full"),
                        lambda: torch.zeros(
                            ids.shape[0] * (S + 1), device=dev).index_add_(
                                0, flat, vals0)),
                variants_ms=variant_ms,
                **bound(8 * ids.numel() + 4 * ids.shape[0] * S,
                        float(ok_ids.sum())))
        else:
            res["hist_variant"]["variants_ms_batch_ids"] = variant_ms
    print("kernels B6 and probe: " + "; ".join(lines), flush=True)
    return res


def phase_kernels(dev, pipe: Pipeline, p) -> dict:
    res = kernels_b123(dev, pipe, p)
    res.update(kernels_b4(dev, np.random.default_rng(7)))
    res.update(kernels_b5(dev))
    res.update(kernels_large(dev))
    res.update(kernels_fused(dev, pipe, p))
    torch.cuda.synchronize()
    print("kernels: " + "; ".join(
        f"{k} {v['ms']:.4f} ms at {v['at']} (device {v['device_ms']:.4f} ms, "
        f"plain {v['plain_ms']:.4f} ms"
        + (f", library {v['library_ms']:.4f} ms / device "
           f"{v['library_device_ms']:.4f} ms"
           if v['library_ms'] is not None else "")
        + f", bound {v['bound_ms']:.4f} ms by {v['bound_by']}, max abs err "
        f"{v['max_abs_err']:.3g})" for k, v in res.items()), flush=True)
    ranked = sorted(((v["device_ms"] / v["library_device_ms"], k)
                     for k, v in res.items() if v["library_device_ms"]),
                    reverse=True)
    print("kernels against their library call, device time: "
          + ", ".join(f"{k} {r:.3f}×" for r, k in ranked), flush=True)
    return res


def batch_phase(name: str, dev, settings: Settings, x: np.ndarray,
                iters: int):
    """Drive Pipeline.process on the card once (counters), check the
    result against the port's CPU path, then time it → (vis, ms)."""
    s = settings.replace(channels=1 if x.ndim == 1 else x.shape[0])
    gpu, cpu = Pipeline(s, dev), Pipeline(s, "cpu")
    p = gpu.params()
    xg = gpu.to_device(x)
    vis, rgba, _ = drive(name, lambda: gpu.process(xg, p))
    vis_c, rgba_c, _ = cpu.process(x)
    check(vis.shape == vis_c.shape and rgba.shape == rgba_c.shape
          and rgba.dtype == torch.uint8, f"{name}: shapes {vis.shape}")
    check(bool(torch.isfinite(vis).all()), f"{name}: non-finite vis")
    t = gpu.num_columns(x.shape[-1])
    if s.mode == "natural":
        want = cpu._natural_power(cpu.to_device(x), t, cpu.params())
        got = gpu._natural_power(xg, t, p).cpu()
        worst = float((got - want).abs().max()) / float(want.max())
        check(worst <= NATURAL_POWER_TOL, f"{name}: GPU vs CPU power "
              f"{worst}·peak > {NATURAL_POWER_TOL}")
        grid = f"power max diff {worst:.2e}·peak"
    else:
        g = compare_grids(cpu._enhanced_power(cpu.to_device(x), t,
                                              cpu.params()),
                          gpu._enhanced_power(xg, t, p).cpu())
        check(g.ok, f"{name}: GPU vs CPU grid {g}")
        grid = f"energy {g.energy_rel:.2e}, grid maxf {g.maxf_rel:.2e}"
    vis_ok, vd, vshare = compare_vis(vis_c, vis.cpu())
    check(vis_ok, f"{name}: GPU vs CPU vis max-filter diff {vd} (share "
          f"over 2/255: {vshare})")
    ms = cuda_ms(lambda: gpu.process(xg, p), iters=iters, warmup=2)
    frames = t * (1 if x.ndim == 1 else x.shape[0])
    print(f"{name}: {tuple(x.shape)} samples → vis {tuple(vis.shape)}; "
          f"{ms:.3f} ms/call, {frames / (ms / 1e3):.1f} frames/s ({frames} "
          f"frames/call, device-resident input); vs CPU path: {grid}, vis "
          f"maxf {vd:.2e} (share over 2/255 {vshare:.2e}); launches "
          f"{LAUNCHES[name]}, B2 routes {ROUTE_LAUNCHES[name]}", flush=True)
    return vis, ms


def live_phase(name: str, dev, settings: Settings, x: np.ndarray,
               vis_batch: torch.Tensor, min_hops: int = 300,
               chunk: int = 1024, budget_ms: float | None = None) -> None:
    """Drive ``Stream`` on the card once (counters) in ``chunk``-sample
    pushes, then flush; it must match the batch result.  Per-hop latency
    p50/p99, beside ``budget_ms`` and the hop's own audio time if given."""
    st = Stream(settings.replace(channels=1 if x.ndim == 1 else x.shape[0]),
                dev)
    lat = []

    def run():
        cols = []
        for i in range(0, x.shape[-1], chunk):
            t0 = time.perf_counter()
            got = st.push(x[..., i:i + chunk])
            if got:
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) / len(got))
            cols.extend(got)
        return cols + st.flush()

    cols = drive(name, run)
    hops = len(cols) + st.reach
    check(hops >= min_hops, f"{name}: only {hops} hops (want {min_hops})")
    check([c.index for c in cols] == list(range(vis_batch.shape[0])),
          f"{name}: column indices differ from the batch")
    vis_s = torch.stack([c.vis for c in cols])
    diff = float((vis_s - vis_batch).abs().max())
    check(diff <= STREAM_VIS_ATOL, f"{name} ≠ batch: max |Δvis| {diff}")
    p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
    hop_ms = st.pipe.hop / settings.sample_rate * 1e3
    budget = ("" if budget_ms is None else
              f" (budget {budget_ms:.1f} ms, hop {hop_ms:.1f} ms of audio: "
              f"p99 {'within' if p99 < budget_ms else 'OVER'} budget)")
    print(f"{name}: {hops} hops of {st.pipe.hop} in {chunk}-sample pushes, "
          f"{len(cols)} columns; max |vis − batch| {diff:.3g}; per-hop "
          f"latency p50 {p50:.3f} ms, p99 {p99:.3f} ms{budget} (host "
          f"clock, push → synchronize); launches {LAUNCHES[name]}, B2 "
          f"routes {ROUTE_LAUNCHES[name]}", flush=True)


def device_busy(fn, reps: int):
    """Device busy time per call of ``fn`` (ms) and its split by kernel:
    the sums of kernel and copy times in torch.profiler (one stream, so
    none overlap).  A first, discarded profile absorbs start-up."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        fn()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {e.key: e.self_device_time_total / 1e3 / reps
               for e in prof.key_averages() if e.device_type == cuda}
    return sum(by_name.values()), by_name


def _top(by_name: dict, k: int = 4) -> str:
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
    return ", ".join(f"{name[:40]} {ms:.4f}" for name, ms in top)


def phase_breakdown(dev, batches: dict, lives: dict) -> None:
    """Where the time goes: per-stage device times (CUDA events) of the
    enhanced stencil batch paths; for every batch cell and a live hop of
    every path, the device busy time, its largest kernels and the idle
    share (1 − profiled busy time over the unprofiled wall time)."""
    for name, (settings, x, wall_ms) in batches.items():
        s = settings.replace(channels=1 if x.ndim == 1 else x.shape[0])
        pipe = Pipeline(s, dev)
        p, xg = pipe.params(), pipe.to_device(x)
        stages = ""
        if s.mode == "enhanced" and s.fft_method == "stencil":
            t = pipe.num_columns(x.shape[-1])
            fr = frame_signal(xg, pipe.n_max, pipe.hop)
            ids, c = pipe._deposit_ids_rel(fr, p)
            cols = pipe._scatter_relative(ids, c, t).movedim(-2, 0).contiguous()
            st = PostState.init(xg.shape[:-1] + (pipe.rows,), dev)

            def post():
                return postprocess_batch(cols, st, p.post, s.agc_global)
            vis, _ = post()
            stages = "stages (CUDA events) " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in {
                    "B1": cuda_ms(lambda: pipe._deposit_ids_rel(fr, p), 5, 2),
                    "B2+fold": cuda_ms(
                        lambda: pipe._scatter_relative(ids, c, t), 5, 2),
                    "post chain": cuda_ms(post, 5, 2),
                    "colormap": cuda_ms(lambda: apply_lut(vis, p.lut), 5, 2),
                }.items()) + "; "
        busy, by_name = device_busy(lambda: pipe.process(xg, p), 3)
        print(f"breakdown {name}: {stages}device busy {busy:.4f} of "
              f"{wall_ms:.4f} ms/call, idle share {1 - busy / wall_ms:.4f}; "
              f"largest (ms/call): {_top(by_name)}", flush=True)

    # live: 20 hops to settle, then up to 100 profiled and as many on the
    # host clock alone (fewer where the signal is shorter)
    for name, (settings, x) in lives.items():
        st = Stream(settings.replace(
            channels=1 if x.ndim == 1 else x.shape[0]), dev)
        hop, pos = st.pipe.hop, st.pipe.n_max + 20 * st.pipe.hop
        reps = min(100, (x.shape[-1] - pos) // (2 * hop))
        st.push(x[..., :pos])

        def one_hop():
            nonlocal pos
            st.push(x[..., pos:pos + hop])
            pos += hop
        busy, by_name = device_busy(one_hop, reps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            one_hop()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"breakdown {name}: device busy {busy:.4f} of {wall_ms:.4f} "
              f"ms/hop (host clock, {hop}-sample pushes, {reps} hops), idle "
              f"share {1 - busy / wall_ms:.4f}; largest (ms/hop): "
              f"{_top(by_name)}", flush=True)


def main() -> None:
    dev = phase_device()
    pipe = Pipeline(SETTINGS, dev)
    res = phase_kernels(dev, pipe, pipe.params())

    x = signal(SECONDS)
    vis, ms = batch_phase("batch", dev, SETTINGS, x, iters=10)
    x16 = signal(SECONDS, CHANNELS, seed=3)
    _, ms16 = batch_phase("batch16", dev, SETTINGS, x16, iters=5)
    live_phase("live", dev, SETTINGS, x, vis)
    vis_n, ms_n = batch_phase("natural", dev, NATURAL, x, iters=3)
    live_phase("natural_live", dev, NATURAL, x, vis_n)
    vis_d, ms_d = batch_phase("direct", dev, DIRECT, x, iters=10)
    live_phase("direct_live", dev, DIRECT, x, vis_d)

    xs = signal(4.0, CHANNELS, seed=13, sr=96000)              # harness.py:435
    _, ms_s = batch_phase("stress", dev, STRESS, xs, iters=5)
    xs_live = signal(SECONDS, CHANNELS, seed=14, sr=96000)
    vis_sl, _ = batch_phase("stress_live_batch", dev, STRESS, xs_live,
                            iters=1)
    live_phase("stress_live", dev, STRESS, xs_live, vis_sl, min_hops=180)
    vis_no, ms_no = batch_phase("north", dev, NORTH, x, iters=3)
    live_phase("north_live", dev, NORTH, x, vis_no, min_hops=900, chunk=800,
               budget_ms=10.0)
    xe = signal(8.0, seed=15, sr=96000)                        # harness.py:479
    _, ms_e = batch_phase("ext262144", dev, EXT, xe, iters=3)
    xw = signal(2.0, seed=16)
    vis_w, ms_w = batch_phase("wide", dev, WIDE, xw, iters=3)
    live_phase("wide_live", dev, WIDE, xw, vis_w, min_hops=1400)
    for path in ("wide", "wide_live"):
        check(ROUTE_LAUNCHES[path]["global"] > 0,
              f"{path}: B2 did not take its route above shared memory "
              f"({ROUTE_LAUNCHES[path]})")
    phase_breakdown(
        dev, {"batch": (SETTINGS, x, ms), "batch16": (SETTINGS, x16, ms16),
              "natural": (NATURAL, x, ms_n), "direct": (DIRECT, x, ms_d),
              "stress": (STRESS, xs, ms_s), "north": (NORTH, x, ms_no),
              "ext262144": (EXT, xe, ms_e), "wide": (WIDE, xw, ms_w)},
        {"live": (SETTINGS, x), "natural_live": (NATURAL, x),
         "direct_live": (DIRECT, x), "stress_live": (STRESS, xs_live),
         "north_live": (NORTH, x), "wide_live": (WIDE, xw)})

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=sum(run[name] for run in LAUNCHES.values()),
             launches_by_path={path: run[name]
                               for path, run in LAUNCHES.items()},
             **({"launches_by_route_and_path": ROUTE_LAUNCHES}
                if name == "histogram" else {}),
             **res[name])
        for name, _, src, rep in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
