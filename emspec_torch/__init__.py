"""emspec_torch — the PyTorch/CUDA port of emspec for NVIDIA Hopper.

The JAX package ``emspec`` stays the reference; this package mirrors its
module names (``emspec_torch.pipeline`` ↔ ``emspec.pipeline`` …) so each
counterpart is easy to find.  It imports ``torch`` and never ``jax``, and
nothing of the JAX package: the host-only code it needs is copied
(``config``, ``dsp.windows``, ``io.ring``, ``io.wav``, ``io.synth``,
``io.resample``, ``io.capture``, ``post._cmap_data``, ``render.png``,
``render.apng``, ``utils.notes``, ``utils.update``,
``integrations.live_state``, ``shell.page``, the numpy table functions
in ``tables``, the native runtime's C++ source and the Max for Live
device), each copy pinned to its original by the tests.

Ported so far: enhanced and natural mode, each on one bank or on the
multires banks — the display default ``Settings()`` is enhanced multires
8192/2048/512 at hop 128 — in batch (``Pipeline.process``), live
(``Stream``) and as images (``render``: ``render.raster`` on one bank,
``pipeline.render_image_multires`` and ``render_images_channels`` on the
banks); the scrolling ``Waterfall``, ``animate_frames``; the live app
(``EmSpecApp``, the web shell ``shell.ShellServer`` and the tkinter
window, live capture, the terminal view, ``prewarm``) and the CLI
(``python -m emspec_torch render|export|stream|animate|live|gui|presets|
doctor|note``; a bare call opens ``gui``); checkpoints of a live stream
(``utils.checkpoint``), tracing (``utils.tracing``), channel and time
sharding on ``torch.distributed`` (``parallel``, ``render
--time-parallel``); the stencil and direct methods, every frame size
512–262144 on one bank, the ``xla`` (``torch.fft``) and ``fourstep`` FFT engines; through
hand-written CUDA kernels (``emspec_torch/csrc``), one for each Pallas
kernel of the JAX package and one for the batch post chain's EMA scan;
the native ingest runtime (``native``: the C++ ring the live path reads
through, framing, the WAV decoder, built at first use) and the examples
(``python -m emspec_torch.examples.<name>``).  Entry points run on the
card unless the caller passes ``device="cpu"``.

>>> from emspec_torch import Settings, get_pipeline, Stream
>>> pipe = get_pipeline(Settings())
>>> vis, rgba, state = pipe.process(samples)
>>> image = render(samples)                  # (rows, t, 4) uint8
"""

import emspec_torch.render  # noqa: F401  (see ``render`` below)
from emspec_torch.config import Settings  # noqa: F401
from emspec_torch.device import apply_precision_policy

apply_precision_policy()

__version__ = "0.1.0"


_LAZY = {
    "Pipeline": "pipeline", "PipelineParams": "pipeline",
    "get_pipeline": "pipeline", "Stream": "stream",
    "stream_signal": "stream", "Waterfall": "render.waterfall",
    "animate_frames": "render.animate", "write_apng": "render.apng",
    "read_apng": "render.apng", "EmSpecApp": "app", "prewarm": "pipeline",
    "ShardedPipeline": "parallel", "ShardedStream": "parallel",
    "channel_mesh": "parallel", "ch_time_mesh": "parallel",
    "TimeParallelRenderer": "parallel",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f"emspec_torch.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module 'emspec_torch' has no attribute {name!r}")


# ``render`` the function shares its name with the ``render`` subpackage:
# the first import of a submodule binds the package's attribute to the
# subpackage, so the subpackage is imported above, before this def, and the
# function keeps the name for good.
def render(samples, settings: Settings | None = None, device="cuda"):
    """Offline convenience: audio (samples,) → RGBA image (rows, t, 4) on
    ``device`` (``emspec.render``).  Multires settings take the
    log-frequency display pipeline; otherwise the single-bank
    linear-frequency raster."""
    s = settings or Settings()
    if s.multires:
        from emspec_torch.pipeline import render_image_multires
        return render_image_multires(samples, s, device)
    from emspec_torch.render.raster import render_image
    return render_image(samples, s, device)
