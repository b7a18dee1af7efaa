"""A/B of kernel B2 (``histogram``) between two checkouts on one card: the
device's own time per call (``bench.measure.device_ms``) at every path's
real ids, the shapes of ``chip_smoke.py``'s B2 rows, for the package
under ``--root``.

    python3 -P emspec_torch/probes/b2_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/b2_ab.py --root . --label change

Run the checkouts in turns in one machine (parent, change, change,
parent): two machines differ in host and power limit.  The ids are each
path's B1 deposits of ``chip_smoke.signal``'s audio (a chirp to 9 kHz,
three tones, 1% noise), made with the measured checkout's own pipeline;
a live hop takes the middle frame of its batch.  Imports only what every
checkout of the port has; prints one JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SR = 48_000
SECONDS = 16.0
CELLS = {        # name → (Settings keywords, seconds, channels, sample rate)
    "batch": (dict(mode="enhanced", multires=False, fft_size=8192), 16.0, 1,
              48000),
    "stress": (dict(mode="enhanced", multires=False, fft_size=32768,
                    sample_rate=96000), 4.0, 16, 96000),
    "north": (dict(mode="enhanced", multires=False, fft_size=32768,
                   hop=800), 16.0, 1, 48000),
    "wide": (dict(mode="enhanced", multires=False, fft_size=8192, hop=64),
             2.0, 1, 48000),
}


def signal(seconds: float, channels: int, sr: int, seed: int):
    """``chip_smoke.signal``: a chirp to 9 kHz (channel c from 100 + 150·c
    Hz), three tones of 0.1 and 1% Gaussian noise from ``seed``."""
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
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("b2_ab: needs a card")
    from emspec_torch import Settings
    from emspec_torch.bench.measure import device_ms
    from emspec_torch.dsp.kernels.scatter import histogram, route_of
    from emspec_torch.pipeline import Pipeline

    dev = torch.device("cuda", 0)

    def relative_ids(settings, x):
        pipe = Pipeline(settings.replace(
            channels=1 if x.ndim == 1 else x.shape[0]), dev)
        xg = pipe.to_device(x)
        ids, contrib = pipe._deposit_ids_rel(
            pipe._bank_inputs(xg, pipe.num_columns(x.shape[-1])),
            pipe.params())
        return ids, contrib, (2 * pipe.reach + 1) * pipe.rows

    cases = []
    for name, (kw, seconds, channels, sr) in CELLS.items():
        ids, vals, cells = relative_ids(
            Settings(**kw), signal(seconds, channels, sr, seed=len(name)))
        cases.append((name, ids, vals, cells))
        mid = ids.shape[-2] // 2
        cases.append((f"{name}_live", ids[..., mid, :].contiguous(),
                      vals[..., mid, :].contiguous(), cells))
    pipe = Pipeline(Settings(), dev)
    t = pipe.num_columns(int(SECONDS * SR))
    mi, mc, ms = relative_ids(Settings(), signal(SECONDS, 1, SR, seed=1))
    cases.append(("multires", pipe._absolute_ids(mi, t, pipe.reach)
                  .reshape(-1), mc.reshape(-1), t * pipe.rows))
    mid = mi.shape[0] // 2
    cases.append(("multires_live", mi[mid], mc[mid], ms))
    out = {}
    for name, ids, vals, cells in cases:
        m = ids.shape[-1]
        rows = ids.numel() // m
        out[name] = dict(shape=[rows, m, cells],
                         route=route_of(rows, m, cells),
                         device_ms=device_ms(
                             lambda: histogram(ids, vals, cells), 50))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, "shapes": out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
