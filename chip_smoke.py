"""On-card smoke run of emspec_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and nvcc; exits nonzero without
them.  Phases, in order, one line each; the first failure ends the run:

1. device: the card's name and power limit; build the CUDA kernels from
   ``emspec_torch/csrc`` and time the build.
2. kernels: each kernel (B1 deposits, B2 histogram, B3 colormap lookup)
   against its plain PyTorch version on the card at the main path's
   shapes (16 s of 48 kHz audio, N = 8192, hop 2048, 512 rows), with
   both times from CUDA events.
3. batch: ``Pipeline.process`` on 16 s of mono audio — the kernel launch
   counters must rise; the result must match the port's CPU path.
4. batch16: the same on a 16-channel batch.
5. live: ``Stream`` fed in 1024-sample chunks (375 hops) then flushed; it
   must match the batch result; per-hop latency p50/p99.
6. breakdown: per-stage device times of the batch path (CUDA events) and
   the device's idle share of a batch call and of a live hop
   (torch.profiler busy time over the unprofiled wall time).

Then one JSON line of per-kernel results, and as the last line
``{"ok": true, "device": {...}}``.

Tolerances (``emspec_torch.validate``): quantized power grids — total
energy ≤ 1e-4 relative, 3×3 max-filters within 1e-3·peak on all but 1e-4
of the cells (a float32 rounding flip moves a whole deposit one cell);
B1 additionally ≥ 99.99% equal ids, every other valid deposit moved by
one cell only, bins 0 and N/2 exact, and contrib within 1e-5·peak
wherever both are valid; B2 ≤ 1e-5 relative per nonzero bin; B3 bit-equal; ``vis`` 3×3
max-filters within 2/255 on all but 1e-4 of the cells; live vs batch
within 1e-5 in ``vis`` (float32 atomics reorder sums only).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from emspec_torch import Settings, kernels_build
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import deposits_ids, deposits_ids_plain
from emspec_torch.dsp.kernels.lut import lut_lookup, lut_lookup_plain
from emspec_torch.dsp.kernels.scatter import histogram, histogram_plain
from emspec_torch.pipeline import Pipeline
from emspec_torch.post.chain import PostState, postprocess_batch
from emspec_torch.post.colormap import apply_lut
from emspec_torch.stream import Stream
from emspec_torch.validate import compare_grids, compare_vis

SR = 48_000
SECONDS = 16.0
SETTINGS = Settings(mode="enhanced", multires=False, fft_size=8192)
CHANNELS = 16
STREAM_VIS_ATOL = 1e-5           # atomics reorder float32 sums only
KERNELS = (
    ("deposits_ids", deposits_ids, "emspec_torch/csrc/deposits.cu",
     "emspec/dsp/pallas/fft4.py:404"),
    ("histogram", histogram, "emspec_torch/csrc/histogram.cu",
     "emspec/dsp/pallas/scatter.py:135"),
    ("lut_lookup", lut_lookup, "emspec_torch/csrc/lut.cu",
     "emspec/dsp/pallas/lut.py:43"),
)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def signal(seconds: float, channels: int = 1, seed: int = 0) -> np.ndarray:
    """Linear chirp to 9 kHz (channel c starts at 100 + c·150 Hz), three
    tones of 0.1 and 1% Gaussian noise from ``seed``."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * SR))) / SR
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


def reset_counters() -> None:
    for _, wrapper, _, _ in KERNELS:
        wrapper.launches = 0


def counters() -> dict:
    return {name: wrapper.launches for name, wrapper, _, _ in KERNELS}


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
    print(f"device: {smi}  torch {torch.__version__} cuda "
          f"{torch.version.cuda}; kernels built in {build_s:.2f} s "
          f"({kernels_build.library_path().name})", flush=True)
    return torch.device("cuda")


def phase_kernels(dev, pipe: Pipeline, p) -> dict:
    n, hop, rows, R = pipe.n_max, pipe.hop, pipe.rows, pipe.reach
    S = (2 * R + 1) * rows
    x = torch.from_numpy(signal(SECONDS, seed=1)).to(dev)
    frames = frame_signal(x, n, hop)                       # (372, 8192)
    kw = dict(n=n, hop=hop, sr=float(SR), rows=rows, reach=R)
    scal = (p.logmap_a, p.logmap_b, p.power_floor)
    res = {}

    # B1: compared as histograms (DESIGN.md §9) and per deposit.  Invalid
    # deposits carry contrib 0 (the kernel's id is -1, the plain one's a
    # clamped row).  A float32 rounding flip may move a valid deposit one
    # row or one column; its contrib = |X_h|²/N² must agree regardless.
    ik, ck = deposits_ids(frames, *scal, **kw)
    ip, cp = deposits_ids_plain(frames, *scal, **kw)
    g = compare_grids(histogram_plain(ip, cp, S).reshape(-1, 2 * R + 1, rows),
                      histogram_plain(ik, ck, S).reshape(-1, 2 * R + 1, rows))
    vk, vp = ck > 0, cp > 0
    both = vk & vp
    agree = (both & (ik == ip)) | (~vk & ~vp)
    id_agree = float(agree.float().mean())
    moved = (ik - ip).abs()[both & (ik != ip)]
    one_cell = bool(torch.isin(moved, torch.tensor(
        [1, rows - 1, rows, rows + 1], device=dev)).all())
    edges_exact = bool(agree[:, [0, n // 2]].all())   # Hermitian stencils
    err_b1 = float((ck - cp)[both].abs().max())
    peak = float(cp.max())
    check(g.ok and id_agree >= 0.9999 and one_cell and edges_exact
          and err_b1 <= 1e-5 * peak,
          f"B1 deposits vs plain: {g}, id agreement {id_agree}, moves of "
          f"one cell only {one_cell}, bins 0 and N/2 exact {edges_exact}, "
          f"contrib err {err_b1} vs peak {peak}")
    res["deposits_ids"] = dict(
        max_abs_err=err_b1,
        ms=cuda_ms(lambda: deposits_ids(frames, *scal, **kw)),
        plain_ms=cuda_ms(lambda: deposits_ids_plain(frames, *scal, **kw)))

    # B2 on those ids: ≤ 1e-5 relative per nonzero bin; a NaN value behind
    # a dropped id must not reach the histogram
    hk, hp = histogram(ik, ck, S), histogram_plain(ik, ck, S)
    nz = hp > 0
    rel_b2 = float(((hk - hp).abs()[nz] / hp[nz]).max())
    check(rel_b2 <= 1e-5 and bool((hk[~nz] == 0).all()),
          f"B2 histogram vs plain: rel {rel_b2}")
    ids_nan = ik.clone()
    vals_nan = ck.clone()
    ids_nan[:, ::7] = -1
    vals_nan[:, ::7] = float("nan")
    check(bool(torch.isfinite(histogram(ids_nan, vals_nan, S)).all()),
          "B2: a NaN behind a dropped id reached the histogram")
    res["histogram"] = dict(
        max_abs_err=float((hk - hp).abs().max()),
        ms=cuda_ms(lambda: histogram(ik, ck, S)),
        plain_ms=cuda_ms(lambda: histogram_plain(ik, ck, S)))

    # B3 at the batch raster (t, rows): bit-equal
    idx = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (frames.shape[0], rows)).astype(np.int32)).to(dev)
    lk, lp = lut_lookup(idx, p.lut), lut_lookup_plain(idx, p.lut)
    check(torch.equal(lk, lp), "B3 lut_lookup differs from table[idx]")
    res["lut_lookup"] = dict(
        max_abs_err=float((lk.int() - lp.int()).abs().max()),
        ms=cuda_ms(lambda: lut_lookup(idx, p.lut)),
        plain_ms=cuda_ms(lambda: lut_lookup_plain(idx, p.lut)))
    torch.cuda.synchronize()
    print("kernels: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f} ms, max abs err "
        f"{v['max_abs_err']:.3g})" for k, v in res.items())
        + f"; B1 grid {g.energy_rel:.2e} energy, {g.maxf_rel:.2e} maxf, "
        f"id agreement {id_agree:.6f}", flush=True)
    return res


def batch_phase(name: str, dev, x: np.ndarray, iters: int):
    """Drive Pipeline.process on the card, check the counters rose and the
    result matches the port's CPU path; → (vis, frames/s)."""
    s = SETTINGS.replace(channels=1 if x.ndim == 1 else x.shape[0])
    gpu, cpu = Pipeline(s, dev), Pipeline(s, "cpu")
    p = gpu.params()
    xg = gpu.to_device(x)
    before = counters()
    vis, rgba, _ = gpu.process(xg, p)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counters().items()}
    check(all(v > 0 for v in launched.values()),
          f"{name}: a kernel of the path did not launch: {launched}")
    vis_c, rgba_c, _ = cpu.process(x)
    check(vis.shape == vis_c.shape and rgba.shape == rgba_c.shape
          and rgba.dtype == torch.uint8, f"{name}: shapes {vis.shape}")
    check(bool(torch.isfinite(vis).all()), f"{name}: non-finite vis")
    t = gpu.num_columns(x.shape[-1])
    g = compare_grids(cpu._enhanced_power(cpu.to_device(x), t, cpu.params()),
                      gpu._enhanced_power(xg, t, p).cpu())
    vis_ok, vd, vshare = compare_vis(vis_c, vis.cpu())
    check(g.ok and vis_ok, f"{name}: GPU vs CPU path: grid {g}, vis "
          f"max-filter diff {vd} (share over 2/255: {vshare})")
    ms = cuda_ms(lambda: gpu.process(xg, p), iters=iters, warmup=2)
    frames = t * (1 if x.ndim == 1 else x.shape[0])
    fps = frames / (ms / 1e3)
    print(f"{name}: {tuple(x.shape)} samples → vis {tuple(vis.shape)}; "
          f"{ms:.3f} ms/call, {fps:.1f} frames/s ({frames} frames/call, "
          f"device-resident input); vs CPU path: energy {g.energy_rel:.2e}, "
          f"grid maxf {g.maxf_rel:.2e}, vis maxf {vd:.2e} (share over "
          f"2/255 {vshare:.2e}); launches "
          f"{launched}", flush=True)
    return vis, fps, ms


def phase_live(dev, x: np.ndarray, vis_batch: torch.Tensor):
    st = Stream(SETTINGS, dev)
    before = counters()
    cols, lat = [], []
    for i in range(0, x.shape[-1], 1024):
        t0 = time.perf_counter()
        got = st.push(x[i:i + 1024])
        if got:
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) / len(got))
        cols.extend(got)
    cols.extend(st.flush())
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counters().items()}
    check(all(v > 0 for v in launched.values()),
          f"live: a kernel of the path did not launch: {launched}")
    hops = len(cols) + st.reach
    check(hops >= 300, f"live: only {hops} hops")
    check([c.index for c in cols] == list(range(vis_batch.shape[0])),
          "live: column indices differ from the batch")
    vis_s = torch.stack([c.vis for c in cols])
    diff = float((vis_s - vis_batch).abs().max())
    check(diff <= STREAM_VIS_ATOL, f"live ≠ batch: max |Δvis| {diff}")
    p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
    print(f"live: {hops} hops in 1024-sample pushes, {len(cols)} columns; "
          f"max |vis − batch| {diff:.3g}; per-hop latency p50 {p50:.3f} ms, "
          f"p99 {p99:.3f} ms (host clock, push → synchronize); launches "
          f"{launched}", flush=True)
    return launched


def device_busy_ms(fn, reps: int) -> float:
    """Device busy time per call of ``fn``: the sum of its kernels' and
    copies' times in torch.profiler (one stream, so none overlap).  A
    first, discarded profile absorbs the profiler's start-up."""
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
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == cuda)
    return busy_us / 1e3 / reps


def phase_breakdown(dev, batches: dict, x_live: np.ndarray) -> None:
    """Where the time goes: per-stage device times (CUDA events) of the
    batch path, and the device's idle share (1 − profiled busy time over
    the unprofiled wall time) of the batch calls and of a live hop."""
    for name, (x, wall_ms) in batches.items():
        s = SETTINGS.replace(channels=1 if x.ndim == 1 else x.shape[0])
        pipe = Pipeline(s, dev)
        p, xg = pipe.params(), pipe.to_device(x)
        t = pipe.num_columns(x.shape[-1])
        fr = frame_signal(xg, pipe.n_max, pipe.hop)
        ids, c = pipe._deposit_ids_rel(fr, p)
        cols = pipe._scatter_relative(ids, c, t).movedim(-2, 0).contiguous()
        st = PostState.init(xg.shape[:-1] + (pipe.rows,), dev)
        def post():
            return postprocess_batch(cols, st, p.post, s.agc_global)
        vis, _ = post()
        stages = {
            "B1": cuda_ms(lambda: pipe._deposit_ids_rel(fr, p), 5, 2),
            "B2+fold": cuda_ms(lambda: pipe._scatter_relative(ids, c, t), 5, 2),
            "post chain": cuda_ms(post, 5, 2),
            "colormap": cuda_ms(lambda: apply_lut(vis, p.lut), 5, 2)}
        busy = device_busy_ms(lambda: pipe.process(xg, p), 3)
        print(f"breakdown {name}: stages (CUDA events) " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in stages.items())
            + f"; device busy {busy:.4f} of {wall_ms:.4f} ms/call, idle "
            f"share {1 - busy / wall_ms:.4f}", flush=True)

    # live: 20 hops to settle, 100 profiled, 100 on the host clock alone
    st = Stream(SETTINGS, dev)
    hop, pos = st.pipe.hop, st.pipe.n_max + 20 * st.pipe.hop
    st.push(x_live[:pos])

    def one_hop():
        nonlocal pos
        st.push(x_live[pos:pos + hop])
        pos += hop
    busy = device_busy_ms(one_hop, 100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        one_hop()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 100
    print(f"breakdown live: device busy {busy:.4f} of {wall_ms:.4f} ms/hop "
          f"(host clock, 2048-sample pushes), idle share "
          f"{1 - busy / wall_ms:.4f}", flush=True)


def main() -> None:
    dev = phase_device()
    pipe = Pipeline(SETTINGS, dev)
    res = phase_kernels(dev, pipe, pipe.params())

    reset_counters()                       # the main path's run starts here
    x = signal(SECONDS)
    vis, _, ms = batch_phase("batch", dev, x, iters=10)
    x16 = signal(SECONDS, CHANNELS, seed=3)
    _, _, ms16 = batch_phase("batch16", dev, x16, iters=5)
    phase_live(dev, x, vis)
    launches = counters()
    phase_breakdown(dev, {"batch": (x, ms), "batch16": (x16, ms16)}, x)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **res[name])
        for name, _, src, rep in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
