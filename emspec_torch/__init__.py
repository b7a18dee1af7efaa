"""emspec_torch — the PyTorch/CUDA port of emspec for NVIDIA Hopper.

The JAX package ``emspec`` stays the reference; this package mirrors its
module names (``emspec_torch.pipeline`` ↔ ``emspec.pipeline`` …) so each
counterpart is easy to find.  It imports ``torch`` and never ``jax``, and
nothing of the JAX package: the host-only code it needs is copied
(``config``, ``dsp.windows``, ``io.ring``, ``post._cmap_data``, the numpy
table functions in ``tables``), each copy pinned to its original by the
tests.

Ported so far: enhanced and natural mode, each on one bank or on the
multires banks — the display default ``Settings()`` is enhanced multires
8192/2048/512 at hop 128 — in batch (``Pipeline.process``), live
(``Stream``) and as images (``render``, ``pipeline.render_image_multires``
and ``render_images_channels``); the stencil and direct methods, every
frame size 512–262144 on one bank, the ``xla`` (``torch.fft``) and
``fourstep`` FFT engines; through hand-written CUDA kernels
(``emspec_torch/csrc``), one for each Pallas kernel of the JAX package.
ROADMAP.md lists the rest.  Entry points run on the card unless the
caller passes ``device="cpu"``.

>>> from emspec_torch import Settings, get_pipeline, Stream
>>> pipe = get_pipeline(Settings())
>>> vis, rgba, state = pipe.process(samples)
>>> image = render(samples)                  # (rows, t, 4) uint8
"""

from emspec_torch.config import Settings  # noqa: F401
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


def render(samples, settings: Settings | None = None, device="cuda"):
    """Offline convenience: audio (samples,) → RGBA image (rows, t, 4) on
    ``device`` (``emspec.render``).  Multires settings take the
    log-frequency display pipeline; the single-bank linear-frequency
    raster (``emspec.render.raster``) is not ported yet (ROADMAP.md)."""
    s = settings or Settings()
    if not s.multires:
        raise NotImplementedError(
            "the single-bank raster (emspec.render.raster) is not ported "
            "to emspec_torch yet (ROADMAP.md); use multires settings")
    from emspec_torch.pipeline import render_image_multires
    return render_image_multires(samples, s, device)
