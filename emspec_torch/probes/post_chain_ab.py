"""A/B of the batch paths between two checkouts on one card: for each
batch cell, the wall per ``Pipeline.process`` call (CUDA events over
back-to-back calls, host dispatch included), the device's own time per
call (CUDA events with the host's queueing hidden behind a device-side
sleep) and the post chain's stage alone (``postprocess_batch`` on the
cell's power), for the package under ``--root``.

    python3 -P emspec_torch/probes/post_chain_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/post_chain_ab.py --root . --label change

Run the checkouts in turns in one machine (parent, change, change,
parent): two machines differ in host and power limit.  Imports only what
every checkout of the port has (``Settings``, ``Pipeline``, the post
chain), and prints one JSON line a run.  Needs a card.

``--tail`` times ``post_tail`` alone instead (its device ms a call on
each of ``TAIL_CASES``' real power, and the chunks repaired), and
``--turns PARENT`` runs that for the parent checkout and this one in
turns, a process each (parent, change; change, parent; ...), and prints
each side's median device ms over ``--rounds`` rounds as a last JSON
line.  ``--inproc PARENT`` times the two checkouts' ``post_tail``
kernels in one process instead: each ``csrc/post_chain.cu`` built into
a library of its own (under this checkout's ``emspec_torch/_build/ab``),
both held bit for bit to ``post_tail_plain`` and called on the same
inputs in turns, so that no difference between processes enters:

    python3 -P emspec_torch/probes/post_chain_ab.py --turns PARENT --rounds 3
    python3 -P emspec_torch/probes/post_chain_ab.py --inproc PARENT --rounds 5
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SR = 48_000
CELLS = {        # name → (Settings keywords, seconds, channels)
    "batch": (dict(mode="enhanced", multires=False, fft_size=8192), 16.0, 1),
    "batch16": (dict(mode="enhanced", multires=False, fft_size=8192), 16.0,
                16),
    "multires": ({}, 16.0, 1),
    "wide": (dict(mode="enhanced", multires=False, fft_size=8192, hop=64),
             2.0, 1),
    "stress": (dict(mode="enhanced", multires=False, fft_size=32768,
                    sample_rate=96000), 4.0, 16),
    "north": (dict(mode="enhanced", multires=False, fft_size=32768,
                   hop=800), 16.0, 1),
}


# post_tail alone: (the cell whose power it takes, smoothing)
TAIL_CASES = (("multires", 0.0), ("multires", 0.6), ("multires", 0.9),
              ("multires", 0.99), ("batch", 0.0), ("batch", 0.6))


def signal(seconds: float, channels: int, sr: int, seed: int = 0):
    """A chirp to 9 kHz (channel c from 100 + 150·c Hz), three tones of
    0.1 and 1% Gaussian noise from ``seed`` (as ``chip_smoke.signal``)."""
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
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tail", action="store_true",
                    help="post_tail alone on TAIL_CASES")
    ap.add_argument("--turns", metavar="PARENT", default=None,
                    help="--tail for PARENT and this checkout in turns")
    ap.add_argument("--inproc", metavar="PARENT", default=None,
                    help="PARENT's and this checkout's post_tail kernels "
                    "in turns in one process")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if args.turns is not None:
        return turns(args.turns, args.rounds)
    if args.inproc is not None:
        args.root = str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("post_chain_ab: needs a card")
    from emspec_torch import Settings
    from emspec_torch.pipeline import Pipeline
    from emspec_torch.post.chain import PostState, postprocess_batch

    dev = torch.device("cuda", 0)

    def events_ms(fn, iters):
        for _ in range(3):
            fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def device_ms(fn, calls):
        fn()
        torch.cuda.synchronize()
        cycles = 50_000_000
        for _ in range(4):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            marks[0].record()
            torch.cuda._sleep(cycles)
            marks[1].record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            queued = (time.perf_counter() - t0) * 1e3
            marks[2].record()
            torch.cuda.synchronize()
            if queued < 0.5 * marks[0].elapsed_time(marks[1]):
                return marks[1].elapsed_time(marks[2]) / calls
            cycles *= 4
        return None

    out = {}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.tail or args.inproc is not None:
        from emspec_torch.dsp.kernels import ema
        from emspec_torch.dsp.kernels.ema import ema_scan
        from emspec_torch.dsp.kernels.post import post_head, post_tail
        from emspec_torch.post import chain

        def tail_inputs(name, smoothing):
            """(power columns first, refs, y0, the post params) of a case."""
            kw, seconds, channels = CELLS[name]
            s = Settings(**kw).replace(channels=channels,
                                       smoothing=smoothing)
            pipe = Pipeline(s, dev)
            p = pipe.params()
            x = signal(seconds, channels, s.sample_rate)
            xg = pipe.to_device(x)
            t = pipe.num_columns(x.shape[-1])
            cols = pipe._enhanced_power(xg, t, p).movedim(-2, 0).contiguous()
            pp = p.post
            peak = post_head(cols, pp.low_end_ramp, pp.gain,
                             1.0 - chain.AGC_DECAY)
            refs, _ = ema_scan(PostState.init(cols.shape[1:], dev).agc_ref,
                               chain.AGC_DECAY, peak)
            return cols, refs, torch.zeros(cols.shape[1:], device=dev), pp
    if args.inproc is not None:
        return inproc(Path(args.inproc), Path(args.root), args.rounds,
                      tail_inputs, device_ms, smi)
    if args.tail:
        for name, smoothing in TAIL_CASES:
            cols, refs, y0, pp = tail_inputs(name, smoothing)
            counter = ema.repair_counter(dev)
            counter.zero_()
            post_tail(cols, refs, y0, pp)
            torch.cuda.synchronize()
            out[f"{name}, smoothing {smoothing}"] = dict(
                shape=list(cols.shape), repaired=int(counter.item()),
                device_ms=device_ms(lambda: post_tail(cols, refs, y0, pp),
                                    20))
        print(json.dumps({"label": args.label, "card": smi, "tail": out}),
              flush=True)
        return 0
    for name, (kw, seconds, channels) in CELLS.items():
        s = Settings(**kw).replace(channels=channels)
        pipe = Pipeline(s, dev)
        p = pipe.params()
        x = signal(seconds, channels, s.sample_rate)
        xg = pipe.to_device(x)
        t = pipe.num_columns(x.shape[-1])
        cols = pipe._enhanced_power(xg, t, p).movedim(-2, 0).contiguous()
        st = PostState.init(cols.shape[1:], dev)
        out[name] = dict(
            wall_ms=events_ms(lambda: pipe.process(xg, p), args.iters),
            device_ms=device_ms(lambda: pipe.process(xg, p), 10),
            post_stage_ms=events_ms(lambda: postprocess_batch(
                cols, st, p.post, s.agc_global), args.iters),
            post_stage_device_ms=device_ms(lambda: postprocess_batch(
                cols, st, p.post, s.agc_global), 10))
    print(json.dumps({"label": args.label, "card": smi, "cells": out}),
          flush=True)
    return 0


def inproc(parent: Path, change: Path, rounds: int, tail_inputs, device_ms,
           card: str) -> int:
    """``--inproc``: both checkouts' ``post_tail`` kernels, a library each,
    on the same inputs in one process, in turns (parent first in even
    rounds); fails unless both are bit-equal to ``post_tail_plain``."""
    import ctypes
    import math

    import torch
    from emspec_torch import kernels_build
    from emspec_torch.dsp.kernels import ema
    from emspec_torch.dsp.kernels.ema import scan_scratch
    from emspec_torch.dsp.kernels.post import _SCALARS, post_tail_plain

    out_dir = change / "emspec_torch" / "_build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    roots = {"parent": parent.resolve(), "change": change.resolve()}
    builds = {label: subprocess.Popen(
        [kernels_build._nvcc(), *kernels_build.NVCC_FLAGS, "-shared", "-I",
         str(root / "emspec_torch" / "csrc"), "-o",
         str(out_dir / f"post_chain_{label}.so"),
         str(root / "emspec_torch" / "csrc" / "post_chain.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, root in roots.items()}
    kernels = {}
    for label, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"post_chain_ab: {label} build failed:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"post_chain_{label}.so")
                         ).emspec_post_tail
        fn.argtypes = kernels_build._SIGNATURES["emspec_post_tail"]
        fn.restype = ctypes.c_int
        kernels[label] = fn
    dev = torch.device("cuda", 0)
    counter = ema.repair_counter(dev)
    runs = {label: {} for label in kernels}
    for name, smoothing in TAIL_CASES:
        case = f"{name}, smoothing {smoothing}"
        cols, refs, y0, pp = tail_inputs(name, smoothing)
        t, rows = cols.shape[0], cols.shape[-1]
        c = math.prod(cols.shape[1:])
        L, scratch = scan_scratch(t, c, cols)
        out, y_final = torch.empty_like(cols), torch.empty_like(y0)
        args = (cols.data_ptr(), refs.data_ptr(), y0.data_ptr(),
                pp.low_end_ramp.data_ptr(),
                *(getattr(pp, k).data_ptr() for k in _SCALARS),
                out.data_ptr(), y_final.data_ptr(), scratch.data_ptr(),
                counter.data_ptr(), -1, t, c, rows, L,
                torch.cuda.current_stream().cuda_stream)

        def call(label):
            rc = kernels[label](*args)
            if rc:
                raise RuntimeError(f"post_tail ({label}): CUDA error {rc}")
        want = post_tail_plain(cols, refs, y0, pp)
        for label in kernels:
            out.fill_(7.0)
            call(label)
            torch.cuda.synchronize()
            if not (torch.equal(out, want[0])
                    and torch.equal(y_final, want[1])):
                raise SystemExit(f"post_chain_ab: {label} post_tail differs "
                                 f"from its plain version at {case}")
            runs[label][case] = []
        for r in range(rounds):
            for label in (("parent", "change") if r % 2 == 0
                          else ("change", "parent")):
                runs[label][case].append(
                    device_ms(lambda: call(label), 20))
    print(json.dumps({"inproc": rounds, "card": card, "device_ms": runs,
                      "median_device_ms": {
                          label: {case: float(np.median(v))
                                  for case, v in got.items()}
                          for label, got in runs.items()}}), flush=True)
    return 0


def turns(parent: str, rounds: int) -> int:
    """``--tail`` for the parent checkout and this one in turns, a process
    each, then each side's medians."""
    here = Path(__file__).resolve()
    change = str(here.parents[2])
    runs = {"parent": [], "change": []}
    for r in range(rounds):
        order = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for label in order:
            root = parent if label == "parent" else change
            res = subprocess.run(
                [sys.executable, "-P", str(here), "--root", root, "--label",
                 label, "--tail"], capture_output=True, text=True)
            sys.stdout.write(res.stdout)
            if res.returncode:
                sys.stderr.write(res.stderr)
                return res.returncode
            runs[label].append(json.loads(res.stdout.splitlines()[-1]))
    medians = {label: {case: float(np.median(
        [run["tail"][case]["device_ms"] for run in got]))
        for case in got[0]["tail"]} for label, got in runs.items()}
    print(json.dumps({"turns": rounds, "card": runs["change"][0]["card"],
                      "median_device_ms": medians}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
