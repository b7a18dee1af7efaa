"""Equal runs of the default paths, for two checkouts on one card.  For
the package under ``--root``, with default ``Settings`` keywords and no
``exact_sums`` argument, at enhanced 8192 and at the display default on
16 s of audio: the cells (of ``vis``) and pixels (of ``rgba``) in which
two ``Stream`` runs in 1024-sample pushes differ, in which a run in
777-sample pushes and one push of the whole signal differ from the
first, in which ``stream_signal`` differs from ``Pipeline.process``,
and in which two ``process`` calls differ — what
``tests/test_torch_cuda.py``'s default-path pins hold at 0.

    python3 -P emspec_torch/probes/default_equal_runs.py --root PARENT --label parent
    python3 -P emspec_torch/probes/default_equal_runs.py --root . --label change

Prints one JSON line a run.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from ring_ab import signal  # noqa: E402  (beside this file)

SR = 48_000
CELLS = {"8192": dict(mode="enhanced", multires=False, fft_size=8192),
         "display": {}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("default_equal_runs: needs a card")

    from emspec_torch import Settings
    from emspec_torch.pipeline import Pipeline
    from emspec_torch.stream import Stream, stream_signal

    dev = torch.device("cuda", 0)
    x = signal(16.0, 1, SR, seed=53)

    def run(s, push):
        st = Stream(s, dev, ring_seconds=x.size / SR + 1.0)
        cols = []
        for i in range(0, x.size, push):
            cols += st.push(x[i:i + push])
        cols += st.flush()
        st.close()
        return (torch.stack([c.vis for c in cols]),
                torch.stack([c.rgba for c in cols]))

    def differ(a, b) -> list:
        return [int((a[0] != b[0]).sum()),
                int((a[1] != b[1]).reshape(-1, 4).any(-1).sum())]

    out = {}
    for name, kw in CELLS.items():
        s = Settings(**kw)
        first = run(s, 1024)
        vis_s, rgba_s = stream_signal(x, s, dev)
        pipe = Pipeline(s, dev)
        b1, b2 = pipe.process(x), pipe.process(x)
        out[name] = {
            "two_streams": differ(first, run(s, 1024)),
            "777_pushes": differ(first, run(s, 777)),
            "one_push": differ(first, run(s, x.size)),
            "stream_signal_vs_process": differ(
                (torch.from_numpy(vis_s), torch.from_numpy(rgba_s)),
                (b1[0].cpu(), b1[1].cpu())),
            "two_process_calls": differ(b1[:2], b2[:2]),
            "cells": int(first[0].numel())}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "card": smi,
                      "differing_cells_and_pixels": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
