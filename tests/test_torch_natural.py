"""P-natural: natural mode (one bank, or the multires banks 8192/2048/512)
of the port against the JAX package on the CPU, on both FFT engines, and
the port's streaming loop against its batch path.

Inputs come from numpy seeds and go to both packages; the port's params
are carried across with ``emspec_torch.convert``.  Tolerances:
* power grid (…, t, rows): within 1e-5·peak per cell (natural power is
  not quantized; pocketfft in torch and XLA's FFT, or the two four-step
  products, differ in float32 rounding only);
* ``vis``: within 1e-4 per cell (a faint cell's dB value amplifies a
  relative rounding difference; readings are ≤ 4e-6);
* streaming ≡ batch: bit for bit on the ``xla`` engine (rfft is batch-
  shape-stable, as the JAX package pins), within 1e-6 in ``vis`` on the
  ``fourstep`` engine (its float32 products may round differently at a
  different batch shape).
"""

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
from emspec_torch.pipeline import Pipeline
from emspec_torch.stream import Stream, stream_signal

SR = 48_000
CASES = {
    "single-xla": dict(multires=False, fft_size=2048),
    "single-fourstep": dict(multires=False, fft_size=1024,
                            fft_impl="fourstep"),
    "multires-xla": dict(),
    "multires-fourstep": dict(fft_impl="fourstep"),
}


def _kw(case, channels=1, **extra):
    kw = dict(mode="natural", smoothing=0.3, raster_height=256,
              channels=channels)
    kw.update(CASES[case])
    kw.update(extra)
    return kw


def _signal(seconds, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    x = (synth.chirp(60.0, 9000.0, seconds)
         + synth.multitone([110.0, 440.0, 3520.0], seconds, amplitude=0.2)
         + 0.01 * rng.standard_normal(int(seconds * SR))).astype(np.float32)
    if channels == 2:
        x = np.stack([x, (synth.tone(300.0, seconds, amplitude=0.5)
                          + 0.02 * rng.standard_normal(x.shape[-1])
                          ).astype(np.float32)])
    return x


def _jax_power(jp, x, t_count, jparams):
    return np.asarray(jax.jit(jp._natural_power, static_argnums=1)(
        jnp.asarray(x), t_count, jparams))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_process_matches_jax(case, channels):
    kw = _kw(case, channels)
    x = _signal(1.0, channels, seed=channels)
    jp, tp = JaxPipeline(JaxSettings(**kw)), Pipeline(Settings(**kw), "cpu")
    assert (tp.sizes, tp.offsets, tp.hop, tp.n_max, tp.reach) == (
        jp.sizes, jp.offsets, jp.hop, jp.n_max, jp.reach)
    assert tp.fft_impl == jp.fft_impl
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    vis_j, rgba_j, st_j = jp.process(x, jparams)
    vis_t, rgba_t, st_t = tp.process(x, p)
    assert vis_t.shape == vis_j.shape and rgba_t.dtype == torch.uint8
    t_count = tp.num_columns(x.shape[-1])
    want = _jax_power(jp, x, t_count, jparams)
    got = tp._natural_power(tp.to_device(x), t_count, p).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    np.testing.assert_allclose(vis_t.numpy(), np.asarray(vis_j), atol=1e-4)
    np.testing.assert_allclose(st_t.agc_ref.numpy(), np.asarray(st_j.agc_ref),
                               atol=1e-3)


@pytest.mark.parametrize("case", ["single-xla", "multires-fourstep"])
def test_nonfinite_samples_scrubbed_like_jax(case):
    """NaN/Inf samples: the frames they touch render black in both
    packages, nothing non-finite reaches the AGC state, and the stream
    recovers once the bad samples leave the window."""
    kw = _kw(case)
    x = _signal(1.0, seed=8)
    x[9000] = np.nan
    x[20000] = np.inf
    x[20001] = -np.inf
    jp, tp = JaxPipeline(JaxSettings(**kw)), Pipeline(Settings(**kw), "cpu")
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    t_count = tp.num_columns(x.shape[-1])
    want = _jax_power(jp, x, t_count, jparams)
    got = tp._natural_power(tp.to_device(x), t_count, p).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want == 0).all(axis=-1).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    vis_j, _, st_j = jp.process(x, jparams)
    vis_t, _, st_t = tp.process(x, p)
    assert torch.isfinite(vis_t).all() and torch.isfinite(st_t.agc_ref).all()
    np.testing.assert_allclose(vis_t.numpy(), np.asarray(vis_j), atol=1e-4)
    vis_s, _ = stream_signal(x, Settings(**kw), "cpu", chunk=1000)
    np.testing.assert_allclose(vis_s, vis_t.numpy(), atol=1e-6)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_streaming_equals_batch(case, channels):
    s = Settings(**_kw(case, channels, smoothing=0.5))
    x = _signal(0.5, channels, seed=4)
    vis_b, rgba_b, _ = Pipeline(s, "cpu").process(x)
    vis_s, rgba_s = stream_signal(x, s, "cpu", chunk=777)
    assert vis_s.shape == tuple(vis_b.shape)
    if s.fft_impl == "fourstep":
        np.testing.assert_allclose(vis_s, vis_b.numpy(), atol=1e-6)
    else:
        np.testing.assert_array_equal(vis_s, vis_b.numpy())
        np.testing.assert_array_equal(rgba_s, rgba_b.numpy())


def test_params_match_jax_and_convert():
    kw = _kw("multires-xla", gain=6.0, colormap="magma", freq_scale=1.5)
    jp = JaxPipeline(JaxSettings(**kw)).params()
    own = Pipeline(Settings(**kw), "cpu").params()
    conv = params_from_jax(jp, "cpu")
    want = jax.tree_util.tree_leaves(
        (jp.post, jp.lut, jp.logmap_a, jp.logmap_b, jp.power_floor, jp.i0,
         jp.w0, jp.band_rows, jp.band_bins))
    for got in (own, conv):
        leaves = jax.tree_util.tree_leaves(tuple(got))
        assert len(leaves) == len(want) == 8 + 4 + 4 * 3
        for a, b in zip(want, leaves):
            assert np.asarray(a).dtype == b.numpy().dtype
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("case", ["single-xla", "multires-xla"])
def test_jax_stream_checkpoint_resumes_in_port(case):
    """A JAX natural-mode Stream snapshot, converted, resumes in the port:
    the resumed columns continue the JAX stream's own."""
    kw = _kw(case, smoothing=0.6)
    x = _signal(0.5, seed=3)
    half = x.shape[-1] // 2
    js = JaxStream(JaxSettings(**kw))
    cols_a = js.push(x[:half])
    saved = js.state_pytree()
    ts = Stream(Settings(**kw), "cpu", params=params_from_jax(js.params, "cpu"))
    ts.load_state(stream_state_from_jax(saved))
    ts.ring = js.ring                      # host ring, shared here
    cols_b = ts.push(x[half:]) + ts.flush()
    assert [c.index for c in cols_b] == list(
        range(len(cols_a), len(cols_a) + len(cols_b)))
    ref_vis, _ = jax_stream_signal(x, JaxSettings(**kw))
    got = np.stack([np.asarray(c.vis) for c in cols_a]
                   + [c.vis.numpy() for c in cols_b])
    np.testing.assert_allclose(got, ref_vis, atol=1e-4)


def test_stream_state_roundtrip_bit_exact():
    s = Settings(**_kw("multires-xla", smoothing=0.6))
    x = _signal(0.4, seed=2)
    half = x.shape[-1] // 2
    st1 = Stream(s, "cpu")
    cols_a = st1.push(x[:half])
    st2 = Stream(s, "cpu")
    st2.load_state(st1.state_dict())
    st2.ring = st1.ring
    cols_b = st2.push(x[half:]) + st2.flush()
    ref, _ = stream_signal(x, s, "cpu")
    got = np.stack([c.vis.numpy() for c in cols_a + cols_b])
    np.testing.assert_array_equal(got, ref)
