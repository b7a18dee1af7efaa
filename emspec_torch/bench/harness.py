"""Performance harness of the port (``emspec.bench.harness``): the
JAX package's ``BASELINE.json`` metrics, measured on the card.

Primary metric: reassigned-spectrogram frames/sec at 8192-pt FFT on the
16 s batch.  Also measured: every configuration of the JAX report (0–4,
and 5–7 unless ``quick``), p50/p99 per-hop audio-to-raster latency on
the streaming path, keep-up of the whole display stack against the
audio clock.  ``vs_baseline`` reports against the north-star target of
60 display columns/sec sustained.

Timing (``bench.measure``): wall marginals by CUDA events over chains of
back-to-back calls (host dispatch included), the device's own time by
``device_ms``.  The JAX package's relay workarounds (host-fetch barriers,
carry materialization, a discarded session warm-up) have no counterpart:
an event is a barrier on this host.  Every entry point takes ``device``
(the card unless the caller asks for the CPU); nothing falls back to the
CPU or to the kernels' plain versions on a card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

TARGET_FPS = 60.0


def _signal(seconds: float, sample_rate: int, channels: int = 1) -> np.ndarray:
    t = np.arange(int(seconds * sample_rate), dtype=np.float64) / sample_rate
    x = 0.4 * np.sin(2 * np.pi * (100.0 * t + 0.5 * 2000.0 * t * t))
    x += 0.2 * np.sin(2 * np.pi * 440.0 * t)
    rng = np.random.default_rng(0)
    x += 0.01 * rng.standard_normal(len(t))
    if channels == 1:
        return x.astype(np.float32)
    return np.stack([np.roll(x, 31 * c) for c in range(channels)]).astype(np.float32)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _throughput(settings, seconds: float, iters: int, device="cuda") -> dict:
    """Batch-path columns/sec: ``Pipeline._batch_vis`` back to back, the
    post state chained call to call, as a long recording is rendered."""
    from emspec_torch.bench.measure import chain_marginal_ms, device_ms
    from emspec_torch.bench.roofline import roofline_report
    from emspec_torch.pipeline import Pipeline
    from emspec_torch.post.chain import PostState

    pipe = Pipeline(settings, device)
    x = _signal(seconds, settings.sample_rate, settings.channels)
    xd = pipe.to_device(x)
    t_count = pipe.num_columns(x.shape[-1])
    p = pipe.params()
    lead = (settings.channels,) if settings.channels > 1 else ()

    def fresh():
        return PostState.init(lead + (pipe.rows,), pipe.device)

    def step(st):
        return pipe._batch_vis(xd, p, st, t_count)[2]

    st = step(fresh())                  # first call: plans, modules, tables
    _sync(pipe.device)
    t0 = time.perf_counter()
    for _ in range(max(iters, 2)):
        st = step(st)
    _sync(pipe.device)
    est = (time.perf_counter() - t0) / max(iters, 2)        # rough s/call
    # chains long enough that their difference dwarfs the host's jitter:
    # 0.3 s of work a chain (quick) or 1.5 s, 3 or 7 pairs
    target_s = 0.3 if iters <= 3 else 1.5
    hi = int(np.clip(np.ceil(target_s / max(est, 1e-5)), max(iters, 4), 1024))
    lo = max(hi // 4, 2)
    dt_ms = chain_marginal_ms(step, fresh, 1, reps=3 if iters <= 3 else 7,
                              long=hi, short=lo, device=pipe.device)
    cols_per_sec = t_count / (dt_ms / 1e3)
    state = [fresh()]

    def chained():
        state[0] = step(state[0])
    dev_ms = device_ms(chained, calls=max(iters, 5), device=pipe.device)
    return {
        "columns_per_sec": cols_per_sec,
        "frames_per_sec_total": cols_per_sec * max(settings.channels, 1),
        "t_count": t_count,
        "iters": iters,
        "ms_per_call_marginal": dt_ms,
        # the device's own time a call, host dispatch excluded
        "device_ms_per_call": dev_ms,
        "device_columns_per_sec": t_count / (dev_ms / 1e3),
        "realtime_factor": cols_per_sec * pipe.hop / settings.sample_rate,
        "roofline": roofline_report(pipe, cols_per_sec, t_count=t_count),
    }


def _latency(settings, hops: int = 200, device="cuda") -> dict:
    """Streaming-path per-hop audio-to-raster latency (hop block staged
    → the step, one CUDA graph replay on the card → the emitted RGBA
    column on the host), driven through the Stream's own staging
    (``_stage_one``, which primes the device window at hop 0 exactly as
    production does, and ``_dispatch``)."""
    from emspec_torch.pipeline import get_pipeline
    from emspec_torch.stream import Stream

    pipe = get_pipeline(settings, device)
    total_hops = hops + max(hops // 2, 8) + pipe.reach + 8
    seconds = ((pipe.n_max + total_hops * pipe.hop)
               / settings.sample_rate + 0.1)
    st = Stream(settings, device, ring_seconds=seconds + 1.0)
    x = _signal(seconds, settings.sample_rate, settings.channels)
    st.ring.push(x)

    def one_hop():
        staged = st._stage_one()
        if staged is None:
            raise RuntimeError("latency signal exhausted (total_hops sizing)")
        cols = st._dispatch(*staged)
        return cols[0] if cols else None

    for _ in range(st.reach + 3):                  # fill the pending ring
        col = one_hop()
    col.rgba.cpu()

    # (a) round trip: stage the hop → step → RGBA column on the host
    times = []
    for _ in range(hops):
        t0 = time.perf_counter()
        col = one_hop()
        col.rgba.cpu()               # a display can only blit a host column
        times.append(time.perf_counter() - t0)
    times = np.asarray(times) * 1e3

    # (b) pipelined: k hops back to back (the carry serializes them on
    # the device), one wait at the end
    k = max(hops // 2, 8)
    _sync(st.device)
    t0 = time.perf_counter()
    for _ in range(k):
        col = one_hop()
    _sync(st.device)
    pipelined_ms = (time.perf_counter() - t0) / k * 1e3

    # (c) the device's own time a hop; (d) a local host's audio-to-raster
    # p50 composed of it and the column's copy at the measured D2H rate
    device_scan_ms = _device_scan_ms_per_hop(settings, device=device)
    col_bytes = int(col.rgba.numel() * col.rgba.element_size())
    fetch = _fetch_throughput_gbs(device=device)
    derived = {"device_scan_ms_per_hop": device_scan_ms,
               "column_bytes": col_bytes}
    if fetch is None:
        derived.update(fetch_gbs_measured=None,
                       note="D2H size-marginal unmeasurable this run; "
                            "local_host_p50_ms omitted")
    else:
        derived.update(
            fetch_gbs_measured=round(fetch, 2),
            column_fetch_ms=round(col_bytes / (fetch * 1e9) * 1e3, 6))
        derived["local_host_p50_ms"] = round(
            device_scan_ms + derived["column_fetch_ms"], 6)
    return {"p50_ms": float(np.percentile(times, 50)),
            "p99_ms": float(np.percentile(times, 99)),
            "mean_ms": float(times.mean()),
            "pipelined_ms_per_hop": pipelined_ms,
            "device_scan_ms_per_hop": device_scan_ms,
            "derived_local_host": derived,
            "hops": hops}


def _fetch_throughput_gbs(reps: int = 5, device="cuda") -> float | None:
    """Device → host bulk-transfer rate in GB/s into pinned memory, as
    the size marginal between a 4 MB and a 64 MB copy (CUDA events), so
    the fixed cost of a copy cancels; the median over ``reps``.  None when
    every marginal is non-positive, and on the CPU (no device–host link):
    callers say so rather than derive numbers from an invented rate."""
    if torch.device(device).type != "cuda":
        return None
    small_n, big_n = 1 << 20, 16 << 20             # float32 elements
    src = torch.empty(big_n, device=device)
    dst = torch.empty(big_n, pin_memory=True)

    def copy_ms(n: int, seed: float) -> float:
        src[:n].fill_(seed)                         # fresh each rep
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        a.record()
        dst[:n].copy_(src[:n], non_blocking=True)
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b)

    copy_ms(big_n, 0.0)                             # warm
    samples = []
    for r in range(reps):
        dt = copy_ms(big_n, 2.0 + r) - copy_ms(small_n, 1.0 + r)
        if dt > 0:
            samples.append(4 * (big_n - small_n) / (dt / 1e3) / 1e9)
    return float(np.median(samples)) if samples else None


HOPS_QUEUED = 64        # hops queued behind one device-side sleep


def _device_scan_ms_per_hop(settings, k: int = 512, device="cuda") -> float:
    """The device's own time a hop of the production streaming step: k
    hop blocks already on the device, each copied into the stream's
    static block and its graph replayed, back to back (the eager step on
    the CPU), timed by ``device_ms`` in groups of ``HOPS_QUEUED``; no
    per-hop host staging.  (All 512 behind one sleep overflow the card's
    queue of pending launches: the host then waits on the device and
    ``device_ms`` refuses the timing.)"""
    from emspec_torch.bench.measure import device_ms
    from emspec_torch.dsp.kernels import add_launch_counts
    from emspec_torch.stream import Stream

    st = Stream(settings, device)
    pipe = st.pipe
    secs = (pipe.n_max + (k + pipe.reach + 2) * pipe.hop) \
        / settings.sample_rate + 0.05
    x = _signal(secs, settings.sample_rate, settings.channels)
    pos = pipe.n_max + (pipe.reach + 1) * pipe.hop
    st.push(x[..., :pos])                          # window primed, t > R
    blocks = torch.from_numpy(np.stack(
        [x[..., pos + i * pipe.hop: pos + (i + 1) * pipe.hop]
         for i in range(k)])).to(st.device)        # (k, [ch,] hop)

    def hops(group: torch.Tensor):
        for block in group:
            if st._graph is None:
                st._step(block)
                continue
            st._block.copy_(block)
            st._graph.replay()
            add_launch_counts(st._replay_launches)
    return sum(device_ms(lambda: hops(blocks[i:i + HOPS_QUEUED]), calls=1,
                         device=st.device)
               for i in range(0, k, HOPS_QUEUED)) / k


def write_profiler_trace(settings, outdir: str, hops: int = 40,
                         device="cuda") -> str:
    """Run ``hops`` live hops under ``utils.tracing.trace`` and write its
    Chrome trace (the host's operators and, on the card, its kernels and
    copies) into ``outdir``."""
    from emspec_torch.stream import Stream
    from emspec_torch.utils.tracing import trace

    st = Stream(settings, device, ring_seconds=8.0)
    hop, n_max = st.pipe.hop, st.pipe.n_max
    secs = (n_max + (hops + st.reach + 4) * hop) / settings.sample_rate + 0.1
    x = _signal(secs, settings.sample_rate, settings.channels)
    pos = n_max + (st.reach + 2) * hop
    cols = st.push(x[..., :pos])                   # warm-up
    if cols:
        cols[-1].rgba.cpu()
    with trace(outdir):
        for _ in range(hops):
            cols = st.push(x[..., pos:pos + hop])
            pos += hop
            if cols:
                cols[-1].rgba.cpu()                # display fetch
        _sync(st.device)
    return outdir


def primary_metric(quick: bool = False, device="cuda") -> dict:
    """The headline: reassigned frames/sec at 8192-pt FFT on the 16 s
    batch (t_count = 372 a call).  ``value`` is the median wall marginal
    over three full measurements (quick: one, shorter chains);
    ``device_frames_per_sec`` is t_count over the device's own time a
    call; ``band`` and ``device_band`` their [min, max]."""
    from emspec_torch.config import Settings
    s = Settings(mode="enhanced", multires=False, fft_size=8192)
    runs = 1 if quick else 3
    reports = [_throughput(s, seconds=16.0, iters=3 if quick else 10,
                           device=device)
               for _ in range(runs)]
    vals = [r["columns_per_sec"] for r in reports]
    dev_vals = [r["device_columns_per_sec"] for r in reports]
    v = float(np.median(vals))
    return {
        "metric": "reassigned_spectrogram_frames_per_sec_8192pt",
        "value": round(v, 1),
        "unit": "frames/s/chip",
        # no published reference numbers exist (BASELINE.md); compare to
        # the 60 fps sustained-display north-star target
        "vs_baseline": round(v / TARGET_FPS, 2),
        "device_frames_per_sec": round(float(np.median(dev_vals)), 1),
        "band": [round(min(vals), 1), round(max(vals), 1)],
        "device_band": [round(min(dev_vals), 1), round(max(dev_vals), 1)],
        "runs": [round(a, 1) for a in vals],
        "t_count": reports[0]["t_count"],
    }


def run_benchmarks(quick: bool = False, device="cuda") -> dict:
    """Full report over the JAX report's configurations, after
    ``validate_kernels`` has held every CUDA kernel to its plain version
    on the card (on the CPU there is no kernel to validate)."""
    from emspec_torch.config import Settings
    from emspec_torch.device import as_device

    dev = as_device(device)
    secs = 1.0 if quick else 4.0
    iters = 2 if quick else 8
    hops = 50 if quick else 200
    if dev.type == "cuda":
        from emspec_torch.dsp.kernels.validate import validate_kernels
        name = torch.cuda.get_device_name(dev)
        kernels = validate_kernels(quick=quick, device=dev)
    else:
        name = "cpu"
        kernels = "not run: on the CPU the wrappers run their plain versions"
    report: dict = {
        "device": name,
        "kernels": kernels,
        "primary": primary_metric(quick, dev),
        "configs": {},
    }
    cfgs = {
        "0_stft_2048_natural": (Settings(
            mode="natural", multires=False, fft_size=2048), secs),
        "1_reassigned_2048": (Settings(
            mode="enhanced", multires=False, fft_size=2048), secs),
        "2_multires_log_merge": (Settings(mode="enhanced", multires=True),
                                 secs),
        "4_stress_16ch_96k_32768": (Settings(
            mode="enhanced", multires=False, fft_size=32768,
            sample_rate=96_000, channels=16), secs),
    }
    if not quick:
        # the JAX report's extensions past 32768, each at its own signal
        # length (``emspec/bench/harness.py:449-481``)
        cfgs["5_ext_65536_96k"] = (Settings(
            mode="enhanced", multires=False, fft_size=65536,
            sample_rate=96_000), 32.0)
        cfgs["6_ext_131072_96k"] = (Settings(
            mode="enhanced", multires=False, fft_size=131072,
            sample_rate=96_000), secs)
        cfgs["7_ext_262144_96k"] = (Settings(
            mode="enhanced", multires=False, fft_size=262144,
            sample_rate=96_000), 8.0)
    for cfg, (s, cfg_secs) in cfgs.items():
        report["configs"][cfg] = _throughput(s, cfg_secs, iters, dev)
    # config 3 is the streaming path: measured as latency
    report["configs"]["3_streaming_latency_default"] = _latency(
        Settings(mode="enhanced", multires=True), hops, dev)
    report["configs"]["3_streaming_latency_8192"] = _latency(
        Settings(mode="enhanced", multires=False, fft_size=8192), hops, dev)
    return report


def sustained_display(settings=None, seconds: float = 8.0,
                      drain_hz: float = 60.0, user_dir=None,
                      device="cuda") -> dict:
    """Product-level north-star measurement [NS: "sustain 60 fps"]: run
    the real display stack — real-time-paced synthetic capture → ring →
    streaming step (a graph replay a hop on the card) → waterfall — for
    ``seconds`` of wall clock, draining at the display cadence as the
    window shells do, and report whether column production kept up with
    the audio clock.  ``keepup_ratio`` ≈ 1.0 means the display never
    starved; ±1 hop of clock quantization makes ~0.95+ the healthy band.
    ``python -m emspec_torch bench --sustained`` prints it."""
    import contextlib
    import tempfile

    from emspec_torch.config import Settings

    s = settings or Settings(mode="enhanced", multires=True)
    tmp_ctx = (tempfile.TemporaryDirectory(prefix="emspec_sustained_")
               if user_dir is None else contextlib.nullcontext(str(user_dir)))
    with tmp_ctx as ud:
        return _sustained_run(s, ud, seconds, drain_hz, device)


def _sustained_run(s, ud, seconds: float, drain_hz: float, device) -> dict:
    from emspec_torch.app import EmSpecApp
    from emspec_torch.shell.feed import AudioFeeder

    app = EmSpecApp(s, user_dir=ud, device=device)
    pipe = app.stream.pipe
    # outside the clock: the stream's capture (at construction) and its
    # first R hops, which only fill the pending ring — a start-up
    # latency paid once, not a shortfall of production
    warm = np.zeros((s.channels, pipe.n_max + pipe.reach * pipe.hop),
                    np.float32)
    app.push_audio(warm if s.channels > 1 else warm[0])

    feeder = AudioFeeder(app, source="synthetic")
    ch = s.channels
    empty = (np.zeros((ch, 0), np.float32) if ch > 1
             else np.zeros(0, np.float32))
    emitted = 0
    gaps = []
    feeder.start()
    t0 = time.perf_counter()
    last = t0
    try:
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            got = app.push_audio(empty)
            if got:
                gaps.append(now - last)
                last = now
            emitted += got
            time.sleep(1.0 / drain_hz)
        # the clock stops here: feeder.stop() joins the capture thread
        # and must not count against the keep-up ratio
        elapsed = time.perf_counter() - t0
    finally:
        feeder.stop()
        app.close()
    rate = app.settings.sample_rate
    hop = pipe.hop
    expected = elapsed * rate / hop
    gaps_ms = sorted(g * 1e3 for g in gaps) or [0.0]
    return {
        "seconds": round(elapsed, 2),
        "expected_cols": int(expected),
        "emitted_cols": emitted,
        "keepup_ratio": round(emitted / max(expected, 1e-9), 4),
        "cols_per_sec_wall": round(emitted / elapsed, 1),
        "hop_rate_hz": round(rate / hop, 1),
        "p50_drain_gap_ms": round(gaps_ms[len(gaps_ms) // 2], 1),
        "p99_drain_gap_ms": round(gaps_ms[int(len(gaps_ms) * 0.99)
                                          if len(gaps_ms) > 1 else 0], 1),
    }
