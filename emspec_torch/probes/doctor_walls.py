"""The wall of ``python -m emspec_torch doctor --kernels`` (and with
``--full``) for two checkouts on one card, in turns, a process each:

    python3 -P emspec_torch/probes/doctor_walls.py --parent PARENT

Each checkout first runs ``doctor --kernels`` once untimed (its kernel
library and native ring are built at first use), then each set runs in
turns (parent, change, change, parent), the quick set ``--rounds``
times and the full set ``--full-rounds`` times; a run must exit 0.
Prints the card's name and power limit, one line a run (its wall and
doctor's kernels row) and, last, one JSON line: each side's walls and
median by set.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def doctor(root: Path, full: bool, tmp: str) -> tuple:
    """One ``doctor --kernels`` process of the checkout at ``root`` →
    (wall s, its kernels row)."""
    env = dict(os.environ, PYTHONPATH=str(root))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "emspec_torch", "doctor",
                        "--kernels"] + (["--full"] if full else []),
                       cwd=tmp, env=env, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    row = [ln for ln in r.stdout.splitlines() if " cuda kernels " in ln]
    if r.returncode != 0:
        raise SystemExit(f"doctor --kernels{' --full' if full else ''} of "
                         f"{root}: exit {r.returncode}\n{r.stdout[-3000:]}"
                         f"\n{r.stderr[-3000:]}")
    return wall, row[0] if row else ""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the other checkout's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--full-rounds", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sides = {"parent": args.parent.resolve(), "change": ROOT}
    walls = {f"{side} {s}": [] for side in sides for s in ("quick", "full")}
    with tempfile.TemporaryDirectory() as tmp:
        for side, root in sides.items():
            wall, _ = doctor(root, False, tmp)
            print(f"{side}: first run (builds) {wall:.2f} s", flush=True)
        for full in (False, True):
            for _ in range(args.full_rounds if full else args.rounds):
                for side in ("parent", "change", "change", "parent"):
                    wall, row = doctor(sides[side], full, tmp)
                    key = f"{side} {'full' if full else 'quick'}"
                    walls[key].append(wall)
                    print(f"{key}: {wall:.2f} s | {row}", flush=True)
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(json.dumps({"card": smi, "walls_s": walls, "median_s": med}),
          flush=True)


if __name__ == "__main__":
    main()
