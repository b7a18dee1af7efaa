"""Long-running leak soak on the product path (``emspec.bench.soak``).

The app runs indefinitely as a desktop display; ``sustained_display``
shows the stack keeps up for seconds — this soak shows it holds for
minutes while a user works the settings panel: it runs the real live
shell (capture thread → ring → streaming step, a graph replay a hop on
the card → waterfall → HTTP drain) and a churn thread that drives
continuous slider moves, colormap flips, hover/axis reads and preset
CRUD against the live HTTP API, while a sampler tracks

* host RSS (``/proc/self/status`` VmRSS) — Python/torch host leaks,
* the card's memory (``torch.cuda.memory_allocated`` and
  ``memory_reserved``; None on the CPU, where no device allocator
  exists),
* cumulative emitted columns → per-window keep-up drift.

Verdict fields: ``rss_slope_mb_per_min`` (linear fit past the warmup
minute), the device slopes, ``keepup_first_half`` vs
``keepup_second_half`` (drift = degradation), churn counters, and the
raw samples for the record.  ``python -m emspec_torch bench --soak
--duration 600`` prints it.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import torch


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


def _device_mb(device):
    """(allocated, reserved) MB of the caching allocator on a card; None
    on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return (torch.cuda.memory_allocated(dev) / 1e6,
            torch.cuda.memory_reserved(dev) / 1e6)


class _Churn(threading.Thread):
    """Second thread hammering the live shell over HTTP: continuous
    sliders, colormap, preset save/load/delete, hover and axis reads."""

    def __init__(self, port: int, period_s: float = 0.25):
        super().__init__(daemon=True)
        self.base = f"http://127.0.0.1:{port}"
        self.period = period_s
        self.stop_ev = threading.Event()
        self.counts = {"settings": 0, "presets": 0, "errors": 0}

    def _post(self, path: str, payload: dict | None = None) -> None:
        req = urllib.request.Request(
            self.base + path,
            data=json.dumps(payload or {}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            r.read()

    def run(self) -> None:
        from emspec_torch.config import COLORMAPS
        i = 0
        while not self.stop_ev.is_set():
            try:
                step = i % 8
                if step < 5:          # slider sweep (all continuous)
                    self._post("/api/settings", {
                        "gain": 2.0 + (i % 13) * 0.5,
                        "brightness": 0.2 + (i % 7) * 0.1,
                        "db_range": 40.0 + (i % 9) * 5.0,
                        "freq_scale": 0.5 + (i % 6) * 0.25,
                        "smoothing": (i % 5) * 0.15,
                    })
                    self.counts["settings"] += 1
                elif step == 5:       # colormap flip (continuous: LUT data)
                    self._post("/api/settings",
                               {"colormap": COLORMAPS[i % len(COLORMAPS)]})
                    self.counts["settings"] += 1
                elif step == 6:       # preset CRUD cycle
                    self._post("/api/preset/save?name=soak")
                    self._post("/api/preset/load?name=soak")
                    self._post("/api/preset/delete?name=soak")
                    self.counts["presets"] += 3
                else:                 # hover + axis reads (GET surface)
                    with urllib.request.urlopen(
                            self.base + "/api/hover?frac=0.5",
                            timeout=10) as r:
                        r.read()
                    with urllib.request.urlopen(
                            self.base + "/api/axis", timeout=10) as r:
                        r.read()
                i += 1
            except Exception:
                self.counts["errors"] += 1
            self.stop_ev.wait(self.period)


def _slope_per_min(ts, values) -> float | None:
    """Least-squares slope of ``values`` over ``ts`` (s), per minute;
    None with fewer than two points."""
    if len(values) < 2 or np.ptp(ts) <= 0:
        return None
    return float(np.polyfit(ts, values, 1)[0]) * 60.0


def soak(settings=None, seconds: float = 600.0,
         sample_every: float = 5.0, user_dir=None,
         inject_nonfinite: bool = False, inject_every: int = 40,
         device="cuda") -> dict:
    """Run the live shell + churn for ``seconds``; return leak verdicts.

    ``inject_nonfinite``: corrupt every ``inject_every``-th capture block
    with one non-finite sample (NaN/+Inf/−Inf cycling) on the producer
    thread — the single-producer ring contract is kept because the
    corruption wraps the feeder's own sink.  A real capture driver can
    deliver non-finite floats, and the display must keep up and keep
    rendering through them indefinitely."""
    import contextlib
    import tempfile

    from emspec_torch.config import Settings
    from emspec_torch.pipeline import get_pipeline
    from emspec_torch.shell import ShellServer

    s = settings or Settings(mode="enhanced", multires=True)
    tmp_ctx = (tempfile.TemporaryDirectory(prefix="emspec_soak_")
               if user_dir is None else contextlib.nullcontext(str(user_dir)))
    with tmp_ctx as ud:
        srv = ShellServer(s, port=0, source="synthetic", user_dir=ud,
                          device=device)
        dev = srv.app.device
        inject_counts = {"blocks": 0, "injected": 0}
        if inject_nonfinite:
            # patched BEFORE start(): the capture source binds its sink at
            # start; the wrapper runs on the producer thread
            orig_push = srv.feeder._ring_push
            bad_cycle = (np.nan, np.inf, -np.inf)

            def corrupting_push(chunk):
                inject_counts["blocks"] += 1
                if inject_counts["blocks"] % inject_every == 0:
                    chunk = np.array(chunk, copy=True)
                    chunk[..., chunk.shape[-1] // 2] = \
                        bad_cycle[inject_counts["injected"] % 3]
                    inject_counts["injected"] += 1
                orig_push(chunk)

            srv.feeder._ring_push = corrupting_push
        srv.start()
        churn = _Churn(srv.port)
        samples = []           # (t, rss_mb, device (alloc, reserved), cols)
        try:
            # warm outside the clock: wait for the first column
            t_warm = time.perf_counter()
            while (srv.columns_emitted == 0
                   and time.perf_counter() - t_warm < 120.0):
                time.sleep(0.1)
            churn.start()
            t0 = time.perf_counter()
            while True:
                now = time.perf_counter() - t0
                samples.append((now, _rss_mb(), _device_mb(dev),
                                srv.columns_emitted))
                if now >= seconds:
                    break
                time.sleep(sample_every)
            # liveness at the end of the clock: the display still renders
            # content (a poisoned chain would leave it black while columns
            # keep flowing)
            with srv.lock:
                img = srv.app.image()
            final_frame_nonblack = bool(np.asarray(img)[..., :3].any())
        finally:
            churn.stop_ev.set()
            if churn.is_alive():    # never started if the warmup aborted
                churn.join(timeout=5.0)
            srv.stop()

    ts = np.array([p[0] for p in samples])
    rss = np.array([p[1] for p in samples])
    cols = np.array([p[3] for p in samples], dtype=np.float64)
    dev_mb = [p[2] for p in samples]
    rate = s.sample_rate
    # the churn moves continuous settings only: the hop is the config's
    hop = get_pipeline(s, dev).hop

    # slopes past the warmup minute (or the first quarter of a short
    # run): caches and shell buffers legitimately grow early; a LEAK is
    # monotone growth at steady state
    settle = min(60.0, ts[-1] / 4)
    m = ts >= settle
    rss_slope = _slope_per_min(ts[m], rss[m]) or 0.0
    on_card = dev_mb[0] is not None
    slopes = ([_slope_per_min(ts[m], np.array([d[i] for d, keep
                                               in zip(dev_mb, m) if keep]))
               for i in (0, 1)] if on_card else [None, None])

    def keepup(lo_t, hi_t):
        sel = (ts >= lo_t) & (ts <= hi_t)
        if sel.sum() < 2:
            return float("nan")
        dt = ts[sel][-1] - ts[sel][0]
        dc = cols[sel][-1] - cols[sel][0]
        return float(dc / max(dt * rate / hop, 1e-9))

    def r3(v):
        return None if v is None else round(v, 3)

    half = ts[-1] / 2
    return {
        "seconds": round(float(ts[-1]), 1),
        "samples": len(samples),
        "rss_start_mb": round(float(rss[0]), 1),
        "rss_end_mb": round(float(rss[-1]), 1),
        "rss_slope_mb_per_min": round(rss_slope, 3),
        "device_mem_available": on_card,
        "device_slope_mb_per_min": r3(slopes[0]),
        "device_reserved_slope_mb_per_min": r3(slopes[1]),
        "device_allocated_end_mb": (round(dev_mb[-1][0], 1) if on_card
                                    else None),
        "device_reserved_end_mb": (round(dev_mb[-1][1], 1) if on_card
                                   else None),
        "columns_emitted": int(cols[-1]),
        "keepup_first_half": round(keepup(settle, half), 4),
        "keepup_second_half": round(keepup(half, ts[-1]), 4),
        "churn": churn.counts,
        "mode": s.mode,
        "device": srv.device_name,
        "nonfinite_injected": inject_counts["injected"],
        "final_frame_nonblack": final_frame_nonblack,
        "raw": [(round(t, 1), round(r, 1),
                 None if d is None else [round(v, 1) for v in d], int(c))
                for t, r, d, c in samples],
    }
