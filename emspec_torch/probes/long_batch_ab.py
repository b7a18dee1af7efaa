"""B2's batch form past 2^31 deposits a lane: two checks of a checkout
against its parent, on one card.

``--process``: the north star (32768 points, hop 800) on 37 minutes of
seeded 48 kHz audio (2.18 billion deposits: more than 2^31 a lane)
through ``Pipeline.process`` of the package under ``--root``: prints
whether it returned (with B2's route counts, the wall and the card's peak
reserved memory) or the error it raised.  A checkout whose batch forms
refuse a lane of 2^31 deposits raises at B2 here.

``--inproc PARENT``: the batch form's kernel of PARENT's and of this
checkout's ``csrc/histogram_batch.cu``, each built into a library of its
own (under this checkout's ``emspec_torch/_build/ab``), on the same ids in
one process: at each batch cell (``CELLS``: batch mono, batch16, north,
stress, wide, ext262144, the ids of this checkout's B1 on ``chip_smoke``'s
signals) both held bit for bit to the CPU plain sum, then their device ms
(``bench.measure.device_ms``) in turns, parent first in even rounds.

    python3 -P emspec_torch/probes/long_batch_ab.py --root PARENT --process
    python3 -P emspec_torch/probes/long_batch_ab.py --inproc PARENT

Prints one JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ring_ab import signal  # noqa: E402  (beside this file)

SR = 48_000
NORTH = dict(mode="enhanced", multires=False, fft_size=32768, hop=800)
LONG_MINUTES = 37.0
# cell → (Settings keywords, channels, seconds of audio, sample rate)
CELLS = {
    "batch": (dict(mode="enhanced", multires=False, fft_size=8192), 1, 16.0,
              SR),
    "batch16": (dict(mode="enhanced", multires=False, fft_size=8192), 16,
                16.0, SR),
    "north": (NORTH, 1, 16.0, SR),
    "stress": (dict(mode="enhanced", multires=False, fft_size=32768,
                    sample_rate=96000), 16, 4.0, 96000),
    "wide": (dict(mode="enhanced", multires=False, fft_size=8192, hop=64),
             1, 2.0, SR),
    "ext262144": (dict(mode="enhanced", multires=False, fft_size=262144,
                       sample_rate=96000), 1, 8.0, 96000),
}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def process(root: Path) -> dict:
    """``--process`` for the package under ``root``."""
    sys.path.insert(0, str(root.resolve()))
    import torch
    from emspec_torch import Settings
    from emspec_torch.dsp.kernels.scatter import histogram
    from emspec_torch.pipeline import Pipeline

    s = Settings(**NORTH)
    pipe = Pipeline(s, "cuda")
    x = signal(LONG_MINUTES * 60.0, 1, SR, seed=37)
    t = pipe.num_columns(x.size)
    before = dict(histogram.route_launches)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = dict(root=str(root), frames=t, deposits=t * (pipe.n_max // 2 + 1))
    try:
        vis = pipe.process(x)[0]
        torch.cuda.synchronize()
        out.update(returned=True, vis_shape=list(vis.shape),
                   finite=bool(torch.isfinite(vis).all()))
    except Exception as e:          # what the checkout raises, reported
        out.update(returned=False, error=f"{type(e).__name__}: {e}")
    out.update(wall_s=time.perf_counter() - t0,
               b2_routes={k: v - before[k]
                          for k, v in histogram.route_launches.items()},
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 2**30)
    return out


def inproc(parent: Path, change: Path, rounds: int) -> dict:
    """``--inproc``: both checkouts' batch kernels on the same ids."""
    sys.path.insert(0, str(change.resolve()))
    import torch
    from emspec_torch import Settings, kernels_build
    from emspec_torch.bench.measure import device_ms
    from emspec_torch.dsp.kernels import scatter as sc
    from emspec_torch.pipeline import Pipeline

    out_dir = change / "emspec_torch" / "_build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    roots = {"parent": parent.resolve(), "change": change.resolve()}
    builds = {label: subprocess.Popen(
        [kernels_build._nvcc(), *kernels_build.NVCC_FLAGS, "-shared", "-o",
         str(out_dir / f"histogram_batch_{label}.so"),
         str(root / "emspec_torch" / "csrc" / "histogram_batch.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, root in roots.items()}
    kernels = {}
    for label, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"long_batch_ab: {label} build failed:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"histogram_batch_{label}.so")
                         ).emspec_histogram_batch
        fn.argtypes = kernels_build._SIGNATURES["emspec_histogram_batch"]
        fn.restype = ctypes.c_int
        kernels[label] = fn
    dev = torch.device("cuda", 0)
    runs: dict = {label: {} for label in kernels}
    for name, (kw, ch, seconds, sr) in CELLS.items():
        pipe = Pipeline(Settings(channels=ch, **kw), dev)
        xt = pipe.to_device(signal(seconds, ch, sr, seed=1))
        t = pipe.num_columns(xt.shape[-1])
        ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xt, t),
                                                 pipe.params())
        ids = pipe._absolute_ids(ids_rel, t, pipe.reach)
        lead = ids.shape[:-2]
        lanes = int(np.prod(lead)) if lead else 1
        K, R, rows = ids.shape[-1], pipe.reach, pipe.rows
        fi = ids.reshape(lead + (-1,)).contiguous()
        fc = contrib.reshape(lead + (-1,)).contiguous()
        plan = sc.batch_plan(t, K, R, rows, lanes)
        got = torch.empty(lead + (t * rows,), device=dev)
        args = (fi.data_ptr(), fc.data_ptr(), got.data_ptr(), lanes, t, K,
                rows, R, plan["cols"], plan["bands"].bit_length() - 1,
                plan["row_shift"], plan["cap"], int(plan["packed"]), 0,
                torch.cuda.current_stream().cuda_stream)

        def call(label):
            rc = kernels[label](*args)
            if rc:
                raise RuntimeError(f"{label} batch form: CUDA error {rc}")
        want = sc.histogram_plain(fi.cpu(), fc.cpu(), t * rows)
        for label in kernels:
            got.fill_(7.0)
            call(label)
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"long_batch_ab: {label}'s batch form "
                                 f"differs from the plain sum at {name}")
            runs[label][name] = []
        for r in range(rounds):
            for label in (("parent", "change") if r % 2 == 0
                          else ("change", "parent")):
                runs[label][name].append(device_ms(lambda: call(label), 5))
    med = {label: {k: float(np.median(v)) for k, v in cells.items()}
           for label, cells in runs.items()}
    return dict(inproc=rounds, device_ms=runs, median_device_ms=med,
                change_over_parent={k: med["change"][k] / med["parent"][k]
                                    for k in CELLS})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--process", action="store_true")
    ap.add_argument("--inproc", metavar="PARENT", default=None)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if args.process:
        out = process(Path(args.root))
    elif args.inproc is not None:
        out = inproc(Path(args.inproc), Path(__file__).resolve().parents[2],
                     args.rounds)
    else:
        ap.error("--process or --inproc PARENT")
    print(json.dumps(dict(card=card(), **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
