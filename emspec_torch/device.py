"""Device and dtype policy of the port.

* float32 throughout (``DTYPE``), as the JAX package's production path.
* No TF32 anywhere: a float32 matmul or convolution silently run in TF32
  keeps ~3 decimal digits, the torch twin of the bf16 truncation the JAX
  package hit on the TPU (ROADMAP.md fault-watch (a)).
* Entry points (``Pipeline``, ``get_pipeline``, ``Stream``,
  ``stream_signal``) run on the card unless the caller passes
  ``device="cpu"``; nothing moves work to the CPU when CUDA is missing.
* ``CARD_LOCK`` keeps a CUDA graph capture and a prewarm job apart.
"""

from __future__ import annotations

import threading

import torch

DTYPE = torch.float32

# One process-wide lock around the card work that must not overlap: a
# ``Stream``'s warm-up and graph capture, a ``prewarm`` job, and the
# release of a dropped stream's memory.  ``torch.cuda.graph`` captures in
# its default "global" mode, which another thread breaks with any unsafe
# CUDA call (a synchronize, an allocation outside the graph's pool) made
# while the capture records; a prewarm job runs eager work on another
# thread, so the two take turns.
CARD_LOCK = threading.RLock()


def apply_precision_policy() -> None:
    """Full-float32 matmuls and convolutions (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def as_device(device) -> torch.device:
    """``"cuda"``/``"cpu"``/``torch.device`` → ``torch.device``; a bare
    ``"cuda"`` resolves to the current card so two devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
