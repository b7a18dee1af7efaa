"""A/B of the paths that B1's large-frame routes and B2's sorted route
carry, between two checkouts on one card: the bench's configurations 5–7
(enhanced 65536, 131072 and 262144 at 96 kHz, ``bench.harness
._throughput``: the wall marginal a call, CUDA events over chains with
host dispatch in, and the device's own time a call), the ``ext262144``
cell's call (8 s, 262144 at 96 kHz) and the single-bank raster's sum
(``render.raster.analyze``, enhanced 8192 on 16 s mono: the power grid
on the card), each by its wall (CUDA events over back-to-back calls) and
its device time (the queueing hidden behind a device-side sleep), for
the package under ``--root``.

    python3 -P emspec_torch/probes/large_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/large_ab.py --root . --label change

Run the checkouts in turns in one machine (parent, change, change,
parent).  Imports only what every checkout of the port since the bench
has, and prints one JSON line a run.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CONFIGS = {      # the bench's configurations 5–7 (harness.run_benchmarks)
    "5_ext_65536_96k": (65536, 32.0),
    "6_ext_131072_96k": (131072, 4.0),
    "7_ext_262144_96k": (262144, 8.0),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout whose "
                    "emspec_torch is measured")
    ap.add_argument("--label", default="change")
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("large_ab: needs a card")
    from emspec_torch import Settings
    from emspec_torch.bench.harness import _signal, _throughput
    from emspec_torch.bench.measure import cuda_ms, device_ms
    from emspec_torch.pipeline import Pipeline
    from emspec_torch.render import raster

    dev = torch.device("cuda", 0)
    out = {}
    for name, (n, seconds) in CONFIGS.items():
        s = Settings(mode="enhanced", multires=False, fft_size=n,
                     sample_rate=96_000)
        r = _throughput(s, seconds, args.iters, dev)
        out[name] = {k: r[k] for k in ("t_count", "ms_per_call_marginal",
                                       "device_ms_per_call")}
    s = Settings(mode="enhanced", multires=False, fft_size=262144,
                 sample_rate=96_000)
    pipe = Pipeline(s, dev)
    p = pipe.params()
    xg = pipe.to_device(_signal(8.0, 96_000, 1))
    out["ext262144"] = dict(
        wall_ms=cuda_ms(lambda: pipe.process(xg, p), 10, 3),
        device_ms=device_ms(lambda: pipe.process(xg, p), 10))
    s = Settings(mode="enhanced", multires=False, fft_size=8192)
    xr = torch.from_numpy(_signal(16.0, s.sample_rate, 1)).to(dev)
    out["raster_analyze"] = dict(
        wall_ms=cuda_ms(lambda: raster.analyze(xr, s), 10, 3),
        device_ms=device_ms(lambda: raster.analyze(xr, s), 10))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "cells": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
