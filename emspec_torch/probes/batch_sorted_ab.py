"""The enhanced batch sum's forms at each batch cell of ``chip_smoke.py``,
on one card.  For each cell's grid (the absolute (t, rows) grid of its B1
ids on a seeded signal): B2's sorted route in its tiles form (``reach``
given) and in its global-sort form (no bound), held bit for bit to each
other, and B2's atomic route (the sum ``exact_sums=False`` runs: the
relative histogram and its fold for one bank, one absolute-grid B2 for
several), the device ms of each in turns (tiles, sort, atomic, atomic,
sort, tiles; three rounds), with the tiles' plan.

    python3 -P emspec_torch/probes/batch_sorted_ab.py --root . --label change

Prints one JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ring_ab import signal  # noqa: E402  (beside this file)

SR = 48_000
# cell → (Settings keywords, channels, seconds, sample rate)
CELLS = {
    "batch": (dict(mode="enhanced", multires=False, fft_size=8192), 1, 16.0,
              SR),
    "batch16": (dict(mode="enhanced", multires=False, fft_size=8192), 16,
                16.0, SR),
    "direct": (dict(mode="enhanced", multires=False, fft_size=8192,
                    fft_method="direct", fft_impl="fourstep"), 1, 16.0, SR),
    "stress": (dict(mode="enhanced", multires=False, fft_size=32768,
                    sample_rate=96000), 16, 4.0, 96000),
    "north": (dict(mode="enhanced", multires=False, fft_size=32768, hop=800),
              1, 16.0, SR),
    "ext262144": (dict(mode="enhanced", multires=False, fft_size=262144,
                       sample_rate=96000), 1, 8.0, 96000),
    "wide": (dict(mode="enhanced", multires=False, fft_size=8192, hop=64),
             1, 2.0, SR),
    "multires": ({}, 1, 16.0, SR),
}
TURNS = ("tiles", "sort", "atomic", "atomic", "sort", "tiles") * 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("batch_sorted_ab: needs a card")

    from emspec_torch import Settings
    from emspec_torch.bench.measure import device_ms
    from emspec_torch.dsp.kernels.scatter import SORTED, histogram, tile_plan
    from emspec_torch.pipeline import Pipeline

    dev = torch.device("cuda", 0)
    out: dict = {}
    for name, (kw, ch, seconds, sr) in CELLS.items():
        s = Settings(channels=ch, **kw)
        pipe = Pipeline(s, dev)
        xt = pipe.to_device(signal(seconds, ch, sr, seed=1))
        t = pipe.num_columns(xt.shape[-1])
        ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xt, t),
                                                 pipe.params())
        ids = pipe._absolute_ids(ids_rel, t, pipe.reach)
        lead = ids.shape[:-2]
        fi = ids.reshape(lead + (-1,)).contiguous()
        fc = contrib.reshape(lead + (-1,)).contiguous()
        cells, K = t * pipe.rows, ids.shape[-1]
        forms = {
            "tiles": lambda: histogram(fi, fc, cells, route=SORTED,
                                       reach=pipe.reach, frame_len=K,
                                       column_len=pipe.rows),
            "sort": lambda: histogram(fi, fc, cells, route=SORTED),
            "atomic": lambda: (pipe._scatter_relative(ids_rel, contrib, t)
                               if pipe.use_relative_batch
                               else pipe._scatter_absolute(ids, contrib, t)),
        }
        same = bool(torch.equal(forms["tiles"](), forms["sort"]()))
        turns: dict = {}
        for who in TURNS:
            turns.setdefault(who, []).append(device_ms(forms[who], 5))
        out[name] = dict(
            shape=dict(lead=list(lead), t=t, k=K, rows=pipe.rows,
                       reach=pipe.reach, deposits=int(fi.numel())),
            tiles_equal_sort=same,
            plan=tile_plan(t, K, pipe.reach, column=pipe.rows),
            turns_device_ms=turns,
            median_device_ms={k: float(np.median(v))
                              for k, v in turns.items()})
        print(name, json.dumps(out[name]["median_device_ms"]), same,
              file=sys.stderr, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "cells": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
