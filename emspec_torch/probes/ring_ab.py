"""The live hop's ordered sums against B2's atomic route, for two
checkouts on one card.  For the package under ``--root``, at each
enhanced live cell (``CELLS``):

* ``hops``: two graphed ``Stream``s a cell, one summing each hop through
  B2's atomic route and one through its ring form (each cell in bin
  order) — ``Stream(..., exact_sums=False)`` and the default where the
  checkout's default is ordered, else the default and ``exact_sums=True``
  — each fed the same audio, then their device ms a hop (the graph
  replayed, ``bench.measure.device_ms``) in turns (atomic, ordered,
  ordered, atomic; three rounds);
* ``kernel``: at the hop of the cell's middle frame (B1's ids, bit-equal
  to the live step's), the ring form alone and the atomic route alone
  (the relative histogram the atomic hop launches), device ms in the same
  turns; with ``--clusters`` the ring form at every cluster size that
  fits, each first held bit for bit to its plain version on the CPU at
  frames t = 0 … P + 1 (the drop below column 0 and the slot wrap), with
  NaN/Inf behind dropped ids.

    python3 -P emspec_torch/probes/ring_ab.py --root PARENT --label parent
    python3 -P emspec_torch/probes/ring_ab.py --root . --label change

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
# cell → (Settings keywords, channels, seconds of audio, sample rate)
CELLS = {
    "live": (dict(mode="enhanced", multires=False, fft_size=8192), 1, 3.0,
             SR),
    "direct_live": (dict(mode="enhanced", multires=False, fft_size=8192,
                         fft_method="direct", fft_impl="fourstep"), 1, 3.0,
                    SR),
    "north_live": (dict(mode="enhanced", multires=False, fft_size=32768,
                        hop=800), 1, 3.0, SR),
    "stress_live": (dict(mode="enhanced", multires=False, fft_size=32768,
                         sample_rate=96000, channels=16), 16, 2.0, 96000),
    "wide_live": (dict(mode="enhanced", multires=False, fft_size=8192,
                       hop=64), 1, 2.0, SR),
    "multires_live": ({}, 1, 2.0, SR),
}
TURNS = ("atomic", "ordered", "ordered", "atomic") * 3


def signal(seconds: float, channels: int, sr: int, seed: int = 0):
    """``chip_smoke.signal``: a chirp to 9 kHz a channel, three tones of
    0.1 and 1% Gaussian noise from ``seed``."""
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
    ap.add_argument("--clusters", action="store_true",
                    help="check and time the ring form at every cluster "
                         "size that fits (the change only)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ring_ab: needs a card")

    from emspec_torch import Settings
    from emspec_torch.bench.measure import device_ms
    from emspec_torch.dsp.kernels import scatter
    from emspec_torch.pipeline import Pipeline
    from emspec_torch.stream import Stream

    dev = torch.device("cuda", 0)
    ordered_default = inspect.signature(Stream).parameters[
        "exact_sums"].default is True
    relative_ring = "t" in inspect.signature(scatter.histogram_ring).parameters
    out: dict = {"ordered_default": ordered_default, "cells": {}}
    for name, (kw, ch, seconds, sr) in CELLS.items():
        s = Settings(**kw)
        x = signal(seconds, ch, sr)
        streams = {}
        for who in ("atomic", "ordered"):
            exact = who == "ordered"
            st = (Stream(s, dev, exact_sums=exact) if exact != ordered_default
                  else Stream(s, dev))
            for i in range(0, x.shape[-1], 4096):
                st.push(x[..., i:i + 4096])
            streams[who] = st
        hop: dict = {"atomic": [], "ordered": []}
        for who in TURNS:
            hop[who].append(device_ms(streams[who]._graph.replay, 200))
        for st in streams.values():
            st.close()

        pipe = Pipeline(s, dev)
        xt = pipe.to_device(x)
        frames = pipe.num_columns(xt.shape[-1])
        ids_rel, contrib = pipe._deposit_ids_rel(
            pipe._bank_inputs(xt, frames), pipe.params())
        mid = frames // 2
        rel = ids_rel[..., mid, :].contiguous()
        vals = contrib[..., mid, :].contiguous()
        P, C, k = 2 * pipe.reach + 1, pipe.rows, rel.shape[-1]
        ring = torch.rand((P,) + rel.shape[:-1] + (C,), device=dev)
        t_dev = torch.tensor(mid, dtype=torch.int32, device=dev)
        if relative_ring:
            def ring_call(cluster=None):
                return scatter.histogram_ring(rel, vals, ring, t_dev,
                                              cluster=cluster)
        else:
            ids = pipe._ring_ids(rel, mid).contiguous()   # the parent's

            def ring_call(cluster=None):
                return scatter.histogram_ring(ids, vals, ring)
        rel_m = torch.where(rel >= max(pipe.reach - mid, 0) * C, rel, -1)

        def atomic_call():
            return scatter.histogram(rel_m, vals, P * C)
        kern: dict = {"atomic": [], "ordered": []}
        for who in TURNS:
            kern[who].append(device_ms(ring_call if who == "ordered"
                                       else atomic_call))
        cell = dict(hop_device_ms=hop, kernel_device_ms=kern,
                    median_hop={w: float(np.median(v))
                                for w, v in hop.items()},
                    median_kernel={w: float(np.median(v))
                                   for w, v in kern.items()},
                    shape=dict(lanes=int(rel[..., 0].numel()), k=k, P=P,
                               C=C))
        if args.clusters and relative_ring:
            cell["plan"] = scatter.ring_plan(k, P, C,
                                             lanes=cell["shape"]["lanes"])
            cell["by_cluster"] = clusters(torch, scatter, device_ms, rel,
                                          vals, P, C, dev)
        out["cells"][name] = cell
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi, **out}), flush=True)
    return 0


def clusters(torch, scatter, device_ms, rel, vals, P, C, dev) -> dict:
    """The ring form at each cluster size that fits, in each form (a
    cluster, and ``local``: no cluster, each CTA staging the whole hop):
    held bit for bit to its plain version on the CPU at t = 0 … P + 1
    (NaN/Inf behind a tenth of the ids, dropped), then its device ms at
    the middle frame's t."""
    k, lanes = rel.shape[-1], int(rel[..., 0].numel())
    rng = np.random.default_rng(k)
    pick = torch.from_numpy(rng.random(tuple(rel.shape)) < 0.1).to(dev)
    bad = torch.where(pick, torch.where(rel % 2 == 0, -1, P * C + 3),
                      rel).to(torch.int32)
    bad_v = torch.where(pick, torch.where(rel % 3 == 0, float("inf"),
                                          float("nan")), vals)
    base = torch.rand((P,) + rel.shape[:-1] + (C,), device=dev)
    res = {}
    for local in (False, True):
        for s in (1, 2, 4, 8, 16):
            key = f"{'local' if local else 'cluster'} {s}"
            plan = scatter.ring_plan(k, P, C, s, lanes, local=local)
            occ = (1 if local else scatter.ring_occupancy(k, P, C, s, lanes)
                   ) if plan["fits"] else 0
            if not plan["fits"] or occ == 0:
                res[key] = dict(fits=plan["fits"], occupancy=occ)
                continue
            wrong = []
            for t in list(range(P + 2)) + [1000]:
                t_dev = torch.tensor(t, dtype=torch.int32, device=dev)
                for ids, v in ((rel, vals), (bad, bad_v)):
                    want = scatter.histogram_ring_plain(
                        scatter.ring_ids(ids.cpu(), t, P, C), v.cpu(),
                        base.cpu().clone())
                    got = scatter.histogram_ring(ids, v, base.clone(), t_dev,
                                                 cluster=s, local=local)
                    if not torch.equal(got.cpu(), want):
                        wrong.append(t)
            t_dev = torch.tensor(P + 3, dtype=torch.int32, device=dev)
            ring = base.clone()
            res[key] = dict(fits=True, occupancy=occ, wrong_at_t=wrong,
                            device_ms=device_ms(
                                lambda: scatter.histogram_ring(
                                    rel, vals, ring, t_dev, cluster=s,
                                    local=local)))
    return res


if __name__ == "__main__":
    sys.exit(main())
