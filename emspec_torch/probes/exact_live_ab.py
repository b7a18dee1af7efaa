"""Equal runs of the live path's file outputs, between two checkouts on
one card.  For the package under ``--root``:

* ``streams``: two graphed ``Stream``s on the same audio (16 s; the
  display default in 1024-sample pushes, and enhanced 8192 single bank),
  every column's ``vis`` compared bit for bit — the columns and cells
  that differ — for the default ``Stream`` and, where the checkout's
  ``Stream`` takes ``exact_sums``, the exact one; each stream's device ms
  a hop (its graph replayed, ``bench.measure.device_ms``);
* ``time_parallel``: two ``TimeParallelRenderer.render`` calls at world
  size 1 under NCCL on the display default (16 s), the grid before the
  post chain compared bit for bit (cells that differ), the device ms of
  its sum — the ``histogram`` call the render makes, repeated with the
  same arguments — and the whole render's ms (CUDA events, host input).

    python3 -P emspec_torch/probes/exact_live_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/exact_live_ab.py --root . --label change

Run the checkouts in turns in one machine (parent, change, change,
parent).  Prints one JSON line a run.  Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SR = 48_000
SECONDS = 16.0
STREAMS = {"display": {}, "8192": dict(mode="enhanced", multires=False,
                                       fft_size=8192)}


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


def _differ(a, b) -> dict:
    d = a != b
    return dict(columns=int(d.reshape(d.shape[0], -1).any(-1).sum()),
                cells=int(d.sum()), of_columns=int(d.shape[0]),
                of_cells=int(d.numel()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="checkout whose "
                    "emspec_torch is measured")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("exact_live_ab: needs a card")
    import torch.distributed as dist

    from emspec_torch import Settings, parallel
    from emspec_torch import pipeline as pl
    from emspec_torch.bench.measure import cuda_ms, device_ms
    from emspec_torch.stream import Stream

    dev = torch.device("cuda", 0)
    x = signal(SECONDS)
    exact = "exact_sums" in inspect.signature(Stream).parameters
    out: dict = {"stream_has_exact_sums": exact, "streams": {}}
    for name, kw in STREAMS.items():
        for form in ("default", "exact") if exact else ("default",):
            runs, hop_ms = [], []
            for _ in range(2):
                st = (Stream(Settings(**kw), dev, exact_sums=True)
                      if form == "exact" else Stream(Settings(**kw), dev))
                cols = []
                for i in range(0, x.size, 1024):
                    cols += st.push(x[i:i + 1024])
                cols += st.flush()
                runs.append(torch.stack([c.vis for c in cols]))
                hop_ms.append(device_ms(st._graph.replay, 200))
                st.close()
            out["streams"][f"{name} {form}"] = dict(
                differ=_differ(runs[0], runs[1]), device_ms_a_hop=hop_ms)

    created = parallel.init_group(dev)
    r = parallel.TimeParallelRenderer(
        Settings(), parallel.channel_mesh(axis="t", device=dev))
    grids, sums = [], []
    power, hist = r.pipe._enhanced_power, pl.histogram

    def keep_grid(*a, **kw):
        grids.append(power(*a, **kw))
        return grids[-1]

    def keep_sum(*a, **kw):
        sums.append((a, kw))
        return hist(*a, **kw)
    r.pipe._enhanced_power = keep_grid
    pl.histogram = keep_sum
    try:
        r.render(x)
        r.render(x)
    finally:
        del r.pipe._enhanced_power
        pl.histogram = hist
    a, kw = sums[0]
    out["time_parallel"] = dict(
        differ=_differ(grids[0], grids[1]),
        sum_route=kw.get("route"),
        sum_device_ms=[device_ms(lambda: hist(*a, **kw)) for _ in range(3)],
        render_ms=cuda_ms(lambda: r.render(x), 5, 1))
    if created:
        dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
