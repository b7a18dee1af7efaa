"""emspec_torch — the PyTorch/CUDA port of emspec for NVIDIA Hopper.

The JAX package ``emspec`` stays the reference; this package mirrors its
module names (``emspec_torch.pipeline`` ↔ ``emspec.pipeline`` …) so each
counterpart is easy to find.  It imports ``torch`` and never ``jax``:
host-only helpers come from the jax-free ``emspec`` modules
(``emspec.config``, ``emspec.dsp.windows``, ``emspec.io.*``,
``emspec.post._cmap_data``) and the numpy table functions that live in
jax-importing modules are copied into :mod:`emspec_torch.tables`.

The slice ported so far is the main path: enhanced (reassigned) mode, one
bank, batch (``Pipeline.process``) and live (``Stream``), with three hand-
written CUDA kernels (``emspec_torch/csrc``).  ROADMAP.md lists the rest.

>>> from emspec_torch import Settings, get_pipeline, Stream
>>> pipe = get_pipeline(Settings(multires=False, fft_size=8192), "cuda")
>>> vis, rgba, state = pipe.process(samples)
"""

from emspec.config import Settings  # noqa: F401  (jax-free)
from emspec_torch.device import apply_precision_policy

apply_precision_policy()

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("Pipeline", "PipelineParams", "get_pipeline"):
        from emspec_torch import pipeline
        return getattr(pipeline, name)
    if name in ("Stream", "stream_signal"):
        from emspec_torch import stream
        return getattr(stream, name)
    raise AttributeError(f"module 'emspec_torch' has no attribute {name!r}")
