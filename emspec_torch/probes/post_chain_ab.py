"""A/B of the batch paths between two checkouts on one card: for each
batch cell, the wall per ``Pipeline.process`` call (CUDA events over
back-to-back calls, host dispatch included), the device's own time per
call (CUDA events with the host's queueing hidden behind a device-side
sleep) and the post chain's stage alone (``postprocess_batch`` on the
cell's power), for the package under ``--root``.

    python3 -P emspec_torch/probes/post_chain_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/post_chain_ab.py --root . --label change

Run the checkouts in turns in one machine (parent, change, change,
parent): two machines differ in host and power limit.  Imports only what
every checkout of the port has (``Settings``, ``Pipeline``, the post
chain), and prints one JSON line a run.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SR = 48_000
CELLS = {        # name → (Settings keywords, seconds, channels)
    "batch": (dict(mode="enhanced", multires=False, fft_size=8192), 16.0, 1),
    "batch16": (dict(mode="enhanced", multires=False, fft_size=8192), 16.0,
                16),
    "multires": ({}, 16.0, 1),
    "wide": (dict(mode="enhanced", multires=False, fft_size=8192, hop=64),
             2.0, 1),
    "stress": (dict(mode="enhanced", multires=False, fft_size=32768,
                    sample_rate=96000), 4.0, 16),
    "north": (dict(mode="enhanced", multires=False, fft_size=32768,
                   hop=800), 16.0, 1),
}


def signal(seconds: float, channels: int, sr: int, seed: int = 0):
    """A chirp to 9 kHz (channel c from 100 + 150·c Hz), three tones of
    0.1 and 1% Gaussian noise from ``seed`` (as ``chip_smoke.signal``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0,
                                                          1320.0))
    out = []
    for c in range(channels):
        f0 = 100.0 + 150.0 * c
        chirp = 0.5 * np.sin(2 * np.pi * (f0 * t + 0.5 * (9000.0 - f0)
                                          / seconds * t * t))
        out.append((chirp + tones + 0.01 * rng.standard_normal(t.size))
                   .astype(np.float32))
    return out[0] if channels == 1 else np.stack(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout whose "
                    "emspec_torch is measured")
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("post_chain_ab: needs a card")
    from emspec_torch import Settings
    from emspec_torch.pipeline import Pipeline
    from emspec_torch.post.chain import PostState, postprocess_batch

    dev = torch.device("cuda", 0)

    def events_ms(fn, iters):
        for _ in range(3):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, calls):
        fn()
        torch.cuda.synchronize()
        cycles = 50_000_000
        for _ in range(4):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            torch.cuda._sleep(cycles)
            marks[1].record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            queued = (time.perf_counter() - t0) * 1e3
            marks[2].record()
            torch.cuda.synchronize()
            if queued < 0.5 * marks[0].elapsed_time(marks[1]):
                return marks[1].elapsed_time(marks[2]) / calls
            cycles *= 4
        return None

    out = {}
    for name, (kw, seconds, channels) in CELLS.items():
        s = Settings(**kw).replace(channels=channels)
        pipe = Pipeline(s, dev)
        p = pipe.params()
        x = signal(seconds, channels, s.sample_rate)
        xg = pipe.to_device(x)
        t = pipe.num_columns(x.shape[-1])
        cols = pipe._enhanced_power(xg, t, p).movedim(-2, 0).contiguous()
        st = PostState.init(cols.shape[1:], dev)
        out[name] = dict(
            wall_ms=events_ms(lambda: pipe.process(xg, p), args.iters),
            device_ms=device_ms(lambda: pipe.process(xg, p), 10),
            post_stage_ms=events_ms(lambda: postprocess_batch(
                cols, st, p.post, s.agc_global), args.iters),
            post_stage_device_ms=device_ms(lambda: postprocess_batch(
                cols, st, p.post, s.agc_global), 10))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "cells": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
