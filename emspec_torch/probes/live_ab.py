"""A/B of the live paths between two checkouts on one card: for each live
cell, ``Stream`` (one CUDA graph replay a hop) driven as
``chip_smoke.py``'s live phases drive it — the signal in 1024-sample
pushes (800 for the north star), each push's wall (host clock, push →
synchronize) over the columns it emitted — and the per-hop p50 / p99,
for the package under ``--root``.

    python3 -P emspec_torch/probes/live_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/live_ab.py --root . --label change

Run the checkouts in turns in one machine (parent, change, change,
parent).  Imports only what every checkout of the port since the native
ring has, and prints one JSON line a run.  Needs a card.
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
CELLS = {        # name → (Settings keywords, seconds, push size)
    "live": (dict(mode="enhanced", multires=False, fft_size=8192), 16.0,
             1024),
    "wide_live": (dict(mode="enhanced", multires=False, fft_size=8192,
                       hop=64), 2.0, 1024),
    "north_live": (dict(mode="enhanced", multires=False, fft_size=32768,
                        hop=800), 16.0, 800),
    "multires_live": ({}, 16.0, 1024),
}


def signal(seconds: float, seed: int = 0) -> np.ndarray:
    """A chirp 100 Hz → 9 kHz, three tones of 0.1 and 1% Gaussian noise
    from ``seed`` (``chip_smoke.signal``'s first channel)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * SR))) / SR
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0,
                                                          1320.0))
    chirp = 0.5 * np.sin(2 * np.pi * (100.0 * t + 0.5 * 8900.0 / seconds
                                      * t * t))
    return (chirp + tones + 0.01 * rng.standard_normal(t.size)).astype(
        np.float32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout whose "
                    "emspec_torch is measured")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("live_ab: needs a card")
    from emspec_torch import Settings
    from emspec_torch.stream import Stream

    dev = torch.device("cuda", 0)
    out = {}
    for name, (kw, seconds, chunk) in CELLS.items():
        x = signal(seconds)
        st = Stream(Settings(**kw), dev)
        lat = []
        for i in range(0, x.shape[-1], chunk):
            t0 = time.perf_counter()
            got = st.push(x[..., i:i + chunk])
            if got:
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) / len(got))
        p50, p99 = (float(np.percentile(lat, q)) * 1e3 for q in (50, 99))
        out[name] = dict(p50_ms=p50, p99_ms=p99, pushes=len(lat),
                         worst_ms=float(max(lat)) * 1e3)
        st.close()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "cells": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
