"""The enhanced batch sum's forms at each batch cell of ``chip_smoke.py``,
on one card.  For each cell's grid (the absolute (t, rows) grid of its B1
ids on a seeded signal): B2's sorted route in its batch form and its
tiles form (``reach`` given, ``form=`` forced) and in its global-sort form
(no bound), each held bit for bit to the CPU plain sum of the card's ids,
and B2's atomic route (the sum ``exact_sums=False`` runs: the relative
histogram and its fold for one bank, one absolute-grid B2 for several),
the device ms of each in turns (batch, tiles, sort, atomic, atomic, sort,
tiles, batch; three rounds, medians), with both plans, ``index_add_``'s
device ms at the same ids, the plain version's (``histogram_plain`` on
the card: ms by CUDA events over back-to-back calls, and device ms), and
the bounds: bytes (8 a deposit, 4 a cell)
over 3.35 TB/s, and the chain (the longest cell's run of deposits at 4
cycles a dependent add, at the card's top SM clock).  With ``--sweep``:
the batch form at other row bands, row blocks and entry layouts
(``batch_plan``'s ``bands``, ``row_shift`` and ``packed``), each
bit-equal to the plain sum, in turns.
``--cells`` picks cells.

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
TURNS = ("batch", "tiles", "sort", "atomic",
         "atomic", "sort", "tiles", "batch") * 3
CHAIN_CYCLES = 4        # one dependent float add
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="change")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--cells", default=",".join(CELLS))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("batch_sorted_ab: needs a card")

    from emspec_torch import Settings
    from emspec_torch.bench.measure import cuda_ms, device_ms
    from emspec_torch.dsp.kernels import scatter as sc
    from emspec_torch.pipeline import Pipeline

    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    dev = torch.device("cuda", 0)
    out: dict = {}
    for name in args.cells.split(","):
        kw, ch, seconds, sr = CELLS[name]
        s = Settings(channels=ch, **kw)
        pipe = Pipeline(s, dev)
        xt = pipe.to_device(signal(seconds, ch, sr, seed=1))
        t = pipe.num_columns(xt.shape[-1])
        ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xt, t),
                                                 pipe.params())
        ids = pipe._absolute_ids(ids_rel, t, pipe.reach)
        lead = ids.shape[:-2]
        lanes = int(np.prod(lead)) if lead else 1
        fi = ids.reshape(lead + (-1,)).contiguous()
        fc = contrib.reshape(lead + (-1,)).contiguous()
        cells, K = t * pipe.rows, ids.shape[-1]
        bound = dict(route=sc.SORTED, reach=pipe.reach, frame_len=K,
                     column_len=pipe.rows)
        ok = (fi >= 0) & (fi < cells)
        flat = (torch.where(ok, fi, cells).long()
                + torch.arange(lanes, device=dev).reshape(lead + (1,))
                * (cells + 1)).reshape(-1)
        vals0 = torch.where(ok, fc, 0.0).reshape(-1)
        forms = {
            "batch": lambda: sc.histogram(fi, fc, cells, form="batch",
                                          **bound),
            "tiles": lambda: sc.histogram(fi, fc, cells, form="tiles",
                                          **bound),
            "sort": lambda: sc.histogram(fi, fc, cells, route=sc.SORTED),
            "atomic": lambda: (pipe._scatter_relative(ids_rel, contrib, t)
                               if pipe.use_relative_batch
                               else pipe._scatter_absolute(ids, contrib, t)),
        }
        plain = sc.histogram_plain(fi.cpu(), fc.cpu(), cells)
        equal = {f: bool(torch.equal(forms[f]().cpu(), plain))
                 for f in ("batch", "tiles", "sort")}
        turns: dict = {}
        for who in TURNS:
            turns.setdefault(who, []).append(device_ms(forms[who], 5))
        med = {k: float(np.median(v)) for k, v in turns.items()}
        runs = torch.bincount(flat, minlength=lanes * (cells + 1)).reshape(
            lanes, cells + 1)[:, :cells]
        row = dict(
            shape=dict(lead=list(lead), t=t, k=K, rows=pipe.rows,
                       reach=pipe.reach, deposits=int(fi.numel()),
                       valid=int(ok.sum())),
            equal_plain=equal, form=sc.sorted_form(t, K, pipe.reach,
                                                   pipe.rows, lanes),
            batch_plan=sc.batch_plan(t, K, pipe.reach, pipe.rows, lanes),
            tiles_plan=sc.tile_plan(t, K, pipe.reach, column=pipe.rows),
            turns_device_ms=turns, median_device_ms=med,
            index_add_device_ms=device_ms(
                lambda: torch.zeros(lanes * (cells + 1), device=dev)
                .index_add_(0, flat, vals0), 5),
            plain_ms=cuda_ms(lambda: sc.histogram_plain(fi, fc, cells), 10),
            plain_device_ms=device_ms(
                lambda: sc.histogram_plain(fi, fc, cells), 5),
            bytes_bound_ms=(8.0 * fi.numel() + 4.0 * lanes * cells)
            / HBM_BYTES_PER_S * 1e3,
            longest_run=int(runs.max()),
            chain_bound_ms=int(runs.max()) * CHAIN_CYCLES / clock_hz * 1e3)
        if args.sweep:
            plan0 = sc.batch_plan(t, K, pipe.reach, pipe.rows, lanes)
            shapes = sorted({(b, r, pk) for b in {1, plan0["bands"],
                                                  2 * plan0["bands"]}
                             for r in (0, 2) for pk in (False, True)
                             if b <= sc.BATCH_BANDS and sc.batch_plan(
                                 t, K, pipe.reach, pipe.rows, lanes, bands=b,
                                 row_shift=r)["fits"]})
            sweep: dict = {}
            for b, r, pk in shapes:
                plan = sc.batch_plan(t, K, pipe.reach, pipe.rows, lanes,
                                     bands=b, row_shift=r, packed=pk)
                sweep[f"{b}/{r}/{int(pk)}"] = dict(plan=plan, equal_plain=bool(
                    torch.equal(_forced(sc, fi, fc, cells, lanes, t, K,
                                        pipe.reach, pipe.rows, plan).cpu(),
                                plain)), turns=[])
            for _ in range(3):
                for b, r, pk in shapes + shapes[::-1]:
                    plan = sweep[f"{b}/{r}/{int(pk)}"]["plan"]
                    sweep[f"{b}/{r}/{int(pk)}"]["turns"].append(device_ms(
                        lambda plan=plan: _forced(sc, fi, fc, cells, lanes,
                                                  t, K, pipe.reach,
                                                  pipe.rows, plan), 5))
            for v in sweep.values():
                v["median"] = float(np.median(v["turns"]))
            row["sweep"] = sweep
            print(name, "bands/row_shift/packed", json.dumps(
                {key: (round(v["median"], 4), v["equal_plain"],
                       v["plan"]["cols"]) for key, v in sweep.items()}),
                file=sys.stderr, flush=True)
        out[name] = row
        print(name, json.dumps(med), equal, row["batch_plan"]["bands"],
              f"index_add_ {row['index_add_device_ms']:.4f}, plain "
              f"{row['plain_ms']:.4f} ({row['plain_device_ms']:.4f} device), "
              f"bytes "
              f"{row['bytes_bound_ms']:.4f}, chain {row['chain_bound_ms']:.4f}"
              f" (run {row['longest_run']})", file=sys.stderr, flush=True)
    print(json.dumps({"label": args.label, "card": smi("name,power.limit"),
                      "cells": out}), flush=True)
    return 0


def _forced(sc, fi, fc, cells, lanes, t, K, reach, rows, plan):
    """The batch form launched at ``plan`` (another grid than its own
    choice), as ``histogram`` launches its own."""
    import torch
    out = torch.empty(fi.shape[:-1] + (cells,), device=fi.device)
    rc = sc.kernels_build.library().emspec_histogram_batch(
        fi.data_ptr(), fc.data_ptr(), out.data_ptr(), lanes, t, K, rows,
        reach, plan["cols"], plan["bands"].bit_length() - 1,
        plan["row_shift"], plan["cap"], int(plan["packed"]), 0,
        sc.launch_stream(fi))
    sc.kernels_build.check(rc, "histogram")
    return out


if __name__ == "__main__":
    sys.exit(main())
