"""Runnable examples of the port, a counterpart of each of the JAX
package's ``examples/*.py``, printing what its twin prints:

    python -m emspec_torch.examples.<name> [--device cpu]

Each runs on the card unless given ``--device cpu``.  ``multichip_sharded``
and ``time_parallel_render`` run alone at world size 1 and across cards
under ``torchrun --nproc-per-node N -m emspec_torch.examples.<name>``
(rank 0 prints).
"""

from __future__ import annotations

import argparse


def parse_args(doc: str, argv=None, out: str | None = None):
    """``--device`` (``cuda``, the default, or ``cpu``) and, where the
    example writes a file, its path (default ``out``).  Without a card
    and without ``--device cpu``: one line on stderr, exit 2."""
    import torch

    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if out is not None:
        ap.add_argument("out", nargs="?", default=out,
                        help=f"output file (default: {out or 'none'})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.exit(2, f"{ap.prog}: no CUDA device is available — run on a "
                f"machine with an NVIDIA GPU, or pass --device cpu\n")
    return args
