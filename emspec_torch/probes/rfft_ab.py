"""A/B of the port's real FFT kernel between two checkouts on one card:
``rfft_frames`` at b = 1 at every size 256–262144 and at the shapes
``chip_smoke.py`` times (372 × 8192, 688 × 32768, 184 × 65536, 8 ×
262144; and 372 × 16384), as a spectrum and (``--power``) as Hann power, on a
normal-random signal framed at hop N/4 (a strided view); beside it
``torch.fft.rfft`` on the same frames and, where the checkout keeps
forced routes (``rfft.routes_of``), each of them.  Device ms a call
(``bench.measure.device_ms``), the median of ``--rounds`` rounds, the
forms of a shape timed in turns within each round.

    python3 -P emspec_torch/probes/rfft_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/rfft_ab.py --root . --label change

``--save FILE`` keeps every default output (spectrum and Hann power at
each shape, one seed) in a ``torch.save`` file; ``--against FILE`` holds
this checkout's outputs to such a file bit for bit (one checkout's bits
against another's: run the parent with ``--save``, the change with
``--against``).  ``--clusters`` times route "cluster" at every cluster
size of its sizes (``rfft._launch(..., log2c=)``) at b = 1 and at the
timed shape of its size, in turns.

Run the checkouts in turns in one machine (parent, change, change,
parent).  Imports only what every checkout since the kernel has, and
prints one JSON line a run.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPES = tuple((1, 1 << k) for k in range(8, 19)) + (
    (372, 8192), (372, 16384), (688, 32768), (184, 65536), (8, 262144))


def run(root: Path, label: str, rounds: int, power: bool, save=None,
        against=None, clusters: bool = False) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    from emspec_torch.bench.measure import device_ms
    from emspec_torch.dsp.frame import frame_signal
    from emspec_torch.dsp.kernels import rfft
    from emspec_torch.dsp.stft import hann_window

    if not torch.cuda.is_available():
        raise SystemExit("rfft_ab: needs a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    forced = getattr(rfft, "routes_of", lambda n: ())
    out = {"label": label, "root": str(root), "card": card, "power": power,
           "rounds": rounds, "shapes": {}}
    kept, ref = {}, None if against is None else torch.load(against)
    rng = np.random.default_rng(29)
    for b, n in SHAPES:
        x = torch.from_numpy(rng.standard_normal((b - 1) * (n // 4) + n)
                             .astype(np.float32)).cuda()
        fr = frame_signal(x, n, n // 4)
        fr = fr[0] if b == 1 else fr
        at = f"{b} × {n}"
        hann = hann_window(n, "cuda")
        if save is not None or ref is not None:
            for p in (False, True):
                got = rfft.rfft_frames(fr, hann if p else None, power=p)
                kept[at, p] = got.cpu()
            if ref is not None:
                out.setdefault("bit_equal", {})[at] = all(
                    torch.equal(kept[at, p], ref[at, p]) for p in (False,
                                                                   True))
        win = hann if power else None
        calls = {"default": lambda: rfft.rfft_frames(fr, win, power=power)}
        for r in forced(n)[1:]:
            calls[r] = (lambda r=r: rfft.rfft_frames(fr, win, power=power,
                                                     route=r))
        if clusters and n in getattr(rfft, "CLUSTER_LOG2C", {}):
            for lc in range(1, 5):
                plan = rfft.cluster_plan(n, lc)
                if (plan["w"] >= 16 and plan["a"] >= 16
                        and 128 <= plan["threads"] <= 1024
                        and rfft.cluster_occupancy(n, "cuda", lc) > 0):
                    calls[f"cluster C={1 << lc}"] = (
                        lambda lc=lc: rfft._launch(fr, win, power,
                                                   route="cluster",
                                                   log2c=lc))
        calls["torch.fft.rfft"] = (
            (lambda: torch.fft.rfft(fr * win)) if power
            else (lambda: torch.fft.rfft(fr)))
        got: dict = {}
        for _ in range(rounds):
            for k, fn in calls.items():
                got.setdefault(k, []).append(device_ms(fn, calls=20))
        out["shapes"][at] = dict(
            route=rfft.route_of(n),
            median={k: float(np.median(v)) for k, v in got.items()},
            rounds=got)
        del x, fr
        torch.cuda.empty_cache()
    if save is not None:
        torch.save(kept, save)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="change")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--power", action="store_true")
    ap.add_argument("--save", help="keep the default outputs in this file")
    ap.add_argument("--against", help="hold the outputs to this file's")
    ap.add_argument("--clusters", action="store_true",
                    help="route \"cluster\" at every cluster size")
    args = ap.parse_args(argv)
    print(json.dumps(run(Path(args.root), args.label, args.rounds,
                         args.power, args.save, args.against,
                         args.clusters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
