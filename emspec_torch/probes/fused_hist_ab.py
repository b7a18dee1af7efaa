"""A/B probe: kernel B6 (``deposits_hist``, B1 and B2 fused) against B1 →
B2 composed (``deposits_ids`` then ``histogram``) on the same frames, on
the card (counterpart of ``bench_probes/fused_hist_ab.py``).

    python3 -P emspec_torch/probes/fused_hist_ab.py [--quick] [--root DIR --label NAME]

At that script's two shapes: 88 × 8192 at hop 2048, 48 kHz (primary)
and 688 × 32768 at hop 8192, 96 kHz (stress), reach 2, 512 rows, the
frames a 440 Hz tone in 10% Gaussian noise from seed 5, its scalars
(log-axis a = log2 20, b = 511 / (log2 48000 − log2 20), floor 1e-12).
Parity first, as that script checks it: each B6 route's histogram
against composed, the largest difference over the peak below 1e-4.
Then the device's own time per call (``bench.measure.device_ms``) and
the wall with host dispatch (``bench.measure.cuda_ms``) of composed and
of each route of B6 that takes the shape (``block`` at 8192, ``cluster``
and ``large`` at 32768), in turns (composed, the routes, the routes
reversed, composed).  Beside them, where B6's time goes: each route with
every deposit masked (``min_id`` = the cell count: the kernel without
its adds), B1 and B2 of composed alone, and the scatter probe's variants
(B2 with its warp merge, its atomics or its adds taken out) on composed's
ids.  ``--quick`` cuts the stress batch to 96 frames.

The TPU knobs ``t_tile`` and ``row_chunk`` have no counterpart: a block
or a cluster takes one frame, and its histogram lies whole in shared
memory.  ``--root`` measures the package of another checkout (run two
in turns in one machine: two machines differ in host and power limit);
a checkout whose ``deposits_hist`` takes no ``route`` is timed on its
own route only.  Prints one JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPES = (  # (name, n, hop, b, rows, reach): bench_probes/fused_hist_ab.py:19-23
    ("primary_8192", 8192, 2048, 88, 512, 2),
    ("stress_32768", 32768, 8192, 688, 512, 2),
)
PARITY = 1e-4          # the largest difference over the peak


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--root", default=None, help="checkout whose "
                    "emspec_torch is measured (default: this one)")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    root = (Path(args.root) if args.root
            else Path(__file__).resolve().parents[2])
    sys.path.insert(0, str(root.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fused_hist_ab: needs a card")
    from emspec_torch.bench.measure import cuda_ms, device_ms
    from emspec_torch.dsp.kernels import deposits
    from emspec_torch.dsp.kernels.scatter import histogram
    from emspec_torch.probes import scatter_ablation as probe

    dev = torch.device("cuda", 0)
    routed = "route" in inspect.signature(deposits.deposits_hist).parameters
    rng = np.random.default_rng(5)
    scal = [torch.tensor(np.float32(v), device=dev) for v in (
        np.log2(20.0), 511 / (np.log2(48000.0) - np.log2(20.0)), 1e-12)]
    out = {}
    for name, n, hop, b, rows, reach in SHAPES:
        if args.quick and b > 100:
            b = 96
        sr = 96000.0 if n == 32768 else 48000.0
        frames = torch.from_numpy(
            (0.1 * rng.standard_normal((b, n))
             + np.sin(2 * np.pi * 440.0 / sr * np.arange(n))[None]
             ).astype(np.float32)).to(dev)
        kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=reach)
        cells = (2 * reach + 1) * rows

        def composed():
            return histogram(*deposits.deposits_ids(frames, *scal, **kw),
                             cells)

        routes = ((("block",) if n <= deposits.SMALL_MAX_N
                   else ("cluster", "large")) if routed else ("own",))

        def fused(route, min_id=-2**30):
            extra = {} if route == "own" else {"route": route}
            return lambda: deposits.deposits_hist(frames, *scal, min_id,
                                                  **kw, **extra)

        want = composed()
        peak = max(float(want.max()), 1e-30)
        parity = {}
        for r in routes:
            parity[r] = float((fused(r)() - want).abs().max()) / peak
            if not parity[r] < PARITY:
                raise SystemExit(f"fused_hist_ab: {name} route {r} parity "
                                 f"{parity[r]:.3e} ≥ {PARITY}")
        turns = {}
        for who in ("composed",) + routes + routes[::-1] + ("composed",):
            fn = composed if who == "composed" else fused(who)
            turns.setdefault(who, {"device_ms": [], "ms": []})
            turns[who]["device_ms"].append(device_ms(fn, 20))
            turns[who]["ms"].append(cuda_ms(fn, 10, 2))
        ids, vals = deposits.deposits_ids(frames, *scal, **kw)
        parts = {f"{r}_masked": device_ms(fused(r, cells), 20)
                 for r in routes}
        parts["b1"] = device_ms(
            lambda: deposits.deposits_ids(frames, *scal, **kw), 20)
        parts["b2"] = device_ms(lambda: histogram(ids, vals, cells), 20)
        if routed:                      # this port's probe: B2's own code
            row = probe.route_of(*ids.shape, cells) == "row"
            for v in probe.VARIANTS:
                if row or v not in probe.ROW_ONLY:
                    parts[f"probe_{v}"] = device_ms(
                        lambda: probe.hist_variant(ids, vals, cells, v), 20)
        out[name] = dict(frames=b, n=n, cells=cells, parity_rel_peak=parity,
                         turns=turns, parts_device_ms=parts)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "shapes": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
