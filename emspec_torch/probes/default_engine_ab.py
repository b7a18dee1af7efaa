"""A/B of the default engine's cells between two checkouts on one card:
natural mode, the direct method and a 256 bank under ``fft_impl="auto"``,
whose spectra come from ``torch.fft.rfft`` (cuFFT) in a checkout before
the port's real FFT kernel and from that kernel after it.  For the
package under ``--root``, each cell's device ms a ``Pipeline.process``
call (``bench.measure.device_ms``), a graphed ``Stream``'s host p50/p99
ms a hop (1024-sample pushes, push → synchronize, the first 20 pushes
left out) and whether its columns are ``process``'s bit for bit.

    python3 -P emspec_torch/probes/default_engine_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/default_engine_ab.py --root . --label change

Run the checkouts in turns in one machine (parent, change, change,
parent): two machines differ in host and power limit.  Imports only what
every checkout of the port has (``Settings``, ``Pipeline``, ``Stream``,
``bench.measure``) and prints one JSON line a run.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SR = 48_000
CELLS = {        # name → (Settings keywords, seconds, sample rate)
    "natural_4096": (dict(mode="natural", multires=False, fft_size=4096),
                     16.0, SR),
    "natural_multires": (dict(mode="natural"), 16.0, SR),
    "direct_32768": (dict(mode="enhanced", multires=False, fft_size=32768,
                          fft_method="direct", sample_rate=96000), 8.0,
                     96000),
    "direct_65536": (dict(mode="enhanced", multires=False, fft_size=65536,
                          fft_method="direct", sample_rate=96000), 8.0,
                     96000),
    "stencil_256_bank": (dict(multires_sizes=(8192, 2048, 256)), 8.0, SR),
}
SETTLE = 20              # pushes left out of the hop percentiles


def signal(seconds: float, sr: int, seed: int = 41) -> np.ndarray:
    """A linear chirp to 9 kHz from 100 Hz, three tones of 0.1 and 1%
    Gaussian noise from ``seed`` (``chip_smoke.py``'s signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    tones = sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0,
                                                          1320.0))
    chirp = 0.5 * np.sin(2 * np.pi * (100.0 * t + 0.5 * 8900.0 / seconds
                                      * t * t))
    return (chirp + tones + 0.01 * rng.standard_normal(t.size)).astype(
        np.float32)


def run(root: Path, label: str) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import time

    import torch

    from emspec_torch import Settings
    from emspec_torch.bench.measure import device_ms
    from emspec_torch.pipeline import Pipeline
    from emspec_torch.stream import Stream

    name = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"label": label, "root": str(root), "card": name, "cells": {}}
    for cell, (kw, seconds, sr) in CELLS.items():
        s = Settings(**kw)
        x = signal(seconds, sr)
        pipe = Pipeline(s, "cuda")
        p, xg = pipe.params(), pipe.to_device(x)
        vis, rgba, _ = pipe.process(xg, p)
        ms = device_ms(lambda: pipe.process(xg, p), calls=5)
        st = Stream(s, "cuda")
        cols, lat = [], []
        for i in range(0, x.size, 1024):
            t0 = time.perf_counter()
            got = st.push(x[i:i + 1024])
            if got:
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) / len(got))
            cols.extend(got)
        cols.extend(st.flush())
        st.close()
        sv = torch.stack([c.vis for c in cols])
        sr_ = torch.stack([c.rgba for c in cols])
        same = sv.shape == vis.shape and torch.equal(sv, vis) \
            and torch.equal(sr_, rgba)
        hop = np.array(lat[SETTLE:]) * 1e3
        out["cells"][cell] = dict(
            process_device_ms=ms, hop_p50_ms=float(np.percentile(hop, 50)),
            hop_p99_ms=float(np.percentile(hop, 99)), hops=int(hop.size),
            hop_audio_ms=pipe.hop / sr * 1e3, stream_bit_equal=bool(same),
            vis_max_diff=float((sv - vis).abs().max())
            if sv.shape == vis.shape else None)
        del pipe, st, cols
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="change")
    args = ap.parse_args(argv)
    print(json.dumps(run(Path(args.root), args.label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
