"""Device and dtype policy of the port.

* float32 throughout (``DTYPE``), as the JAX package's production path.
* No TF32 anywhere: a float32 matmul or convolution silently run in TF32
  keeps ~3 decimal digits, the torch twin of the bf16 truncation the JAX
  package hit on the TPU (ROADMAP.md fault-watch (a)).
* No implicit device choice: every entry point takes the ``device`` the
  caller passes, and nothing moves work to the CPU when CUDA is missing.
"""

from __future__ import annotations

import torch

DTYPE = torch.float32


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
