"""P-direct: enhanced mode with one bank and the direct method (triple
windowing, kernel B5 → three real FFTs, ``torch.fft`` or the four-step
engine) of the port against the JAX package on the CPU, and the port's
streaming loop against its batch path.

Tolerances: power grids through ``compare_grids`` (total energy ≤ 1e-4
relative, 3×3 max-filters within 1e-3·peak on all but 1e-4 of the cells:
a float32 rounding flip moves a quantized deposit one cell); ``vis``
through ``compare_vis`` (2/255 on all but 1e-4 of the cells); streaming
≡ batch bit for bit on the ``xla`` engine, within 1e-6 in ``vis`` on the
``fourstep`` engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.io import synth
from emspec.pipeline import Pipeline as JaxPipeline
from emspec.stream import Stream as JaxStream
from emspec.stream import stream_signal as jax_stream_signal
from emspec_torch.config import Settings
from emspec_torch.convert import params_from_jax, stream_state_from_jax
from emspec_torch.dsp.kernels.window import windowed_frames
from emspec_torch.pipeline import Pipeline
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.validate import compare_grids, compare_vis

SR = 48_000


def _kw(n, hop, rows, impl="xla", channels=1, **extra):
    kw = dict(mode="enhanced", multires=False, fft_size=n, hop=hop,
              raster_height=rows, fft_method="direct", fft_impl=impl,
              channels=channels, smoothing=0.3)
    kw.update(extra)
    return kw


def _signal(seconds, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    x = (synth.chirp(100.0, 9000.0, seconds)
         + synth.multitone([440.0, 880.0, 1320.0], seconds, amplitude=0.3)
         + 0.01 * rng.standard_normal(int(seconds * SR))).astype(np.float32)
    if channels == 2:
        x = np.stack([x, (synth.tone(300.0, seconds, amplitude=0.5)
                          + 0.02 * rng.standard_normal(x.shape[-1])
                          ).astype(np.float32)])
    return x


@pytest.mark.parametrize("n,hop,rows,impl,channels,scatter", [
    (1024, 256, 128, "xla", 1, "auto"),
    (1024, 256, 128, "fourstep", 2, "pallas"),
    (8192, 2048, 512, "fourstep", 1, "auto"),
    (8192, 2048, 512, "xla", 2, "pallas"),
])
def test_process_matches_jax(n, hop, rows, impl, channels, scatter):
    """The JAX reference runs its segment-sum scatter (its Pallas one has
    no CPU mode outside interpret mode); the port runs ``scatter``."""
    kw = _kw(n, hop, rows, impl, channels, scatter=scatter)
    x = _signal(2.0 if n == 8192 else 1.0, channels)
    jp = JaxPipeline(JaxSettings(**{**kw, "scatter": "segment_sum"}))
    tp = Pipeline(Settings(**kw), "cpu")
    assert tp.reach == jp.reach and tp.fft_impl == jp.fft_impl == impl
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    vis_j, rgba_j, _ = jp.process(x, jparams)
    vis_t, rgba_t, _ = tp.process(x, p)
    assert vis_t.shape == vis_j.shape and rgba_t.shape == rgba_j.shape
    t_count = tp.num_columns(x.shape[-1])
    want = jax.jit(jp._enhanced_power, static_argnums=1)(
        jnp.asarray(x), t_count, jparams)
    got = tp._enhanced_power(tp.to_device(x), t_count, p)
    cmp = compare_grids(torch.from_numpy(np.array(want)), got)
    assert cmp.ok, cmp
    ok, worst, share = compare_vis(torch.from_numpy(np.array(vis_j)), vis_t)
    assert ok, (worst, share)


@pytest.mark.parametrize("impl", ["xla", "fourstep"])
def test_direct_agrees_with_stencil(impl):
    """The direct and stencil methods compute the same spectra (the
    stencils are exact for the periodic Hann): grids agree."""
    kw = _kw(1024, 256, 128, impl)
    x = _signal(1.0, seed=5)
    d = Pipeline(Settings(**kw), "cpu")
    s = Pipeline(Settings(**{**kw, "fft_method": "stencil"}), "cpu")
    t = d.num_columns(x.shape[-1])
    cmp = compare_grids(s._enhanced_power(s.to_device(x), t, s.params()),
                        d._enhanced_power(d.to_device(x), t, d.params()))
    assert cmp.ok, cmp


@pytest.mark.parametrize("scatter", ["segment_sum", "pallas"])
@pytest.mark.parametrize("impl", ["xla", "fourstep"])
@pytest.mark.parametrize("channels", [1, 2])
def test_streaming_equals_batch(scatter, impl, channels):
    s = Settings(**_kw(1024, 256, 128, impl, channels, scatter=scatter,
                       smoothing=0.5))
    x = _signal(0.5, channels, seed=4)
    vis_b, rgba_b, _ = Pipeline(s, "cpu").process(x)
    vis_s, rgba_s = stream_signal(x, s, "cpu", chunk=777)
    assert vis_s.shape == tuple(vis_b.shape)
    if impl == "fourstep":
        np.testing.assert_allclose(vis_s, vis_b.numpy(), atol=1e-6)
    else:
        np.testing.assert_array_equal(vis_s, vis_b.numpy())
        np.testing.assert_array_equal(rgba_s, rgba_b.numpy())


def test_params_match_jax_and_convert():
    kw = _kw(8192, 2048, 512, "fourstep", gain=6.0, freq_scale=1.5,
             reassign_floor_db=-100.0)
    jp = JaxPipeline(JaxSettings(**kw)).params()
    conv = params_from_jax(jp, "cpu")
    own = Pipeline(Settings(**kw), "cpu").params()
    want = jax.tree_util.tree_leaves(
        (jp.post, jp.lut, jp.logmap_a, jp.logmap_b, jp.power_floor, jp.i0,
         jp.w0, jp.band_rows, jp.band_bins))
    for got in (own, conv):
        leaves = jax.tree_util.tree_leaves(tuple(got))
        assert len(leaves) == len(want)
        for a, b in zip(want, leaves):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (own.band_bins[0].numpy() == 1.0).all()


def test_jax_stream_checkpoint_resumes_in_port():
    kw = _kw(1024, 256, 128, "fourstep", smoothing=0.6)
    x = _signal(0.4, seed=3)
    half = x.shape[-1] // 2
    js = JaxStream(JaxSettings(**kw))
    cols_a = js.push(x[:half])
    saved = js.state_pytree()
    ts = Stream(Settings(**kw), "cpu", params=params_from_jax(js.params, "cpu"))
    ts.load_state(stream_state_from_jax(saved))
    ts.ring = js.ring
    cols_b = ts.push(x[half:]) + ts.flush()
    assert [c.index for c in cols_b] == list(
        range(len(cols_a), len(cols_a) + len(cols_b)))
    ref_vis, _ = jax_stream_signal(x, JaxSettings(**kw))
    got = np.stack([np.asarray(c.vis) for c in cols_a]
                   + [c.vis.numpy() for c in cols_b])
    ok, worst, share = compare_vis(torch.from_numpy(ref_vis),
                                   torch.from_numpy(got))
    assert ok, (worst, share)


def test_nan_sample_leaves_no_nan_and_no_launch_on_cpu():
    x = _signal(0.5, seed=8)
    x[5000] = np.nan
    x[9000] = np.inf
    before = windowed_frames.launches
    for scatter in ("segment_sum", "pallas"):
        s = Settings(**_kw(1024, 256, 128, "fourstep", scatter=scatter))
        vis, _, st = Pipeline(s, "cpu").process(x)
        assert torch.isfinite(vis).all() and torch.isfinite(st.agc_ref).all()
        vis_s, _ = stream_signal(x, s, "cpu")
        assert np.isfinite(vis_s).all()
    assert windowed_frames.launches == before
