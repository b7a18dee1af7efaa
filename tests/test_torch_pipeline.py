"""The port's main path (enhanced, single bank) against the JAX package
on the CPU, and its streaming loop against its own batch path.

Inputs come from numpy seeds and go to both packages; the port's params
are carried across with ``emspec_torch.convert``.  Tolerances:
* power grid: total energy ≤ 1e-4 relative and 3×3 max-filters within
  1e-3·peak on all but 1e-4 of the cells (``compare_grids``; XLA and
  torch round log2/log10 and the FFT differently in the last ulp, which
  can move a quantized deposit one cell — ROADMAP fault-watch (c));
* ``vis``: 3×3 (time × row) max-filters within 2/255 (two display
  quanta) on all but 1e-4 of the cells (``compare_vis``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.config import Settings
from emspec.io import synth
from emspec.pipeline import Pipeline as JaxPipeline
from emspec.stream import Stream as JaxStream
from emspec.stream import stream_signal as jax_stream_signal
from emspec_torch.convert import params_from_jax, stream_state_from_jax
from emspec_torch.pipeline import Pipeline, get_pipeline
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.validate import compare_grids, compare_vis

SR = 48_000


def _settings(n, hop, rows, channels=1, **kw):
    kw.setdefault("smoothing", 0.3)
    return Settings(mode="enhanced", multires=False, fft_size=n, hop=hop,
                    raster_height=rows, channels=channels, **kw)


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


def _vis_maxf_close(want, got):
    ok, worst, share = compare_vis(torch.from_numpy(np.array(want)),
                                   torch.from_numpy(np.array(got)))
    assert ok, (worst, share)


@pytest.mark.parametrize("n,hop,rows,seconds,channels", [
    (1024, 256, 128, 1.0, 1),
    (8192, 2048, 512, 2.0, 1),
    (8192, 2048, 512, 2.0, 2),
])
def test_process_matches_jax(n, hop, rows, seconds, channels):
    s = _settings(n, hop, rows, channels)
    x = _signal(seconds, channels)
    jp = JaxPipeline(s)
    tp = Pipeline(s, "cpu")
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    vis_j, rgba_j, st_j = jp.process(x, jparams)
    vis_t, rgba_t, st_t = tp.process(x, p)
    assert vis_t.shape == vis_j.shape and rgba_t.shape == rgba_j.shape
    assert rgba_t.dtype == torch.uint8
    t_count = tp.num_columns(x.shape[-1])
    power_j = jax.jit(jp._enhanced_power, static_argnums=1)(
        jnp.asarray(x), t_count, jparams)
    power_t = tp._enhanced_power(tp.to_device(x), t_count, p)
    cmp = compare_grids(torch.from_numpy(np.array(power_j)), power_t)
    assert cmp.ok, cmp
    _vis_maxf_close(np.asarray(vis_j), vis_t.numpy())
    np.testing.assert_allclose(st_t.agc_ref.numpy(), np.asarray(st_j.agc_ref),
                               atol=0.05)       # dB


def test_params_match_jax_and_convert():
    s = _settings(8192, 2048, 512, gain=6.0, colormap="viridis",
                  freq_scale=1.5, reassign_floor_db=-100.0)
    jp = JaxPipeline(s).params()
    tp = Pipeline(s, "cpu").params()
    cp = params_from_jax(jp, "cpu")
    for got in (tp, cp):
        for a, b in zip(jax.tree_util.tree_leaves(
                (jp.post, jp.lut, jp.logmap_a, jp.logmap_b, jp.power_floor)),
                jax.tree_util.tree_leaves(tuple(got))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("scatter", ["auto", "pallas"])
@pytest.mark.parametrize("channels", [1, 2])
def test_streaming_equals_batch_bit_exact(scatter, channels):
    """Port stream ≡ port batch, bit for bit on the CPU, for both scatter
    routes (segment sum: each cell adds in (frame, bin) order either way;
    relative: the fold adds frames in the ring's order)."""
    s = _settings(1024, 256, 128, channels, scatter=scatter, smoothing=0.5)
    x = _signal(0.5, channels, seed=4)
    vis_b, rgba_b, _ = Pipeline(s, "cpu").process(x)
    vis_s, rgba_s = stream_signal(x, s, "cpu", chunk=777)
    assert vis_s.shape == tuple(vis_b.shape)
    np.testing.assert_array_equal(vis_s, vis_b.numpy())
    np.testing.assert_array_equal(rgba_s, rgba_b.numpy())


def test_scatter_routes_agree():
    s = _settings(1024, 256, 128)
    x = _signal(0.5, seed=6)
    a = Pipeline(s.replace(scatter="segment_sum"), "cpu").process(x)[0]
    b = Pipeline(s.replace(scatter="pallas"), "cpu").process(x)[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_stream_state_roundtrip_bit_exact():
    s = _settings(1024, 256, 128, smoothing=0.6)
    x = _signal(0.4, seed=2)
    half = x.shape[-1] // 2
    st1 = Stream(s, "cpu")
    cols_a = st1.push(x[:half])
    st2 = Stream(s, "cpu")
    st2.load_state(st1.state_dict())
    st2.ring = st1.ring
    cols_b = st2.push(x[half:]) + st2.flush()
    ref, _ = stream_signal(x, s, "cpu")
    got = {c.index: c.vis.numpy() for c in cols_a + cols_b}
    assert sorted(got) == list(range(ref.shape[0]))
    for i in range(ref.shape[0]):
        np.testing.assert_array_equal(got[i], ref[i])


def test_jax_stream_checkpoint_resumes_in_port():
    """A JAX Stream snapshot, converted, resumes in the port: the resumed
    columns match the JAX stream's own (vis tolerance above)."""
    s = _settings(1024, 256, 128, smoothing=0.6)
    x = _signal(0.4, seed=3)
    half = x.shape[-1] // 2
    js = JaxStream(s)
    cols_a = js.push(x[:half])
    saved = js.state_pytree()
    ts = Stream(s, "cpu", params=params_from_jax(js.params, "cpu"))
    ts.load_state(stream_state_from_jax(saved))
    ts.ring = js.ring                      # host ring, shared here
    cols_b = ts.push(x[half:]) + ts.flush()
    assert [c.index for c in cols_b] == list(
        range(len(cols_a), len(cols_a) + len(cols_b)))
    ref_vis, _ = jax_stream_signal(x, s)
    got = np.stack([np.asarray(c.vis) for c in cols_a]
                   + [c.vis.numpy() for c in cols_b])
    _vis_maxf_close(ref_vis, got)


def test_nan_sample_leaves_no_nan():
    x = _signal(0.5, seed=8)
    x[5000] = np.nan
    x[9000] = np.inf
    for scatter in ("segment_sum", "pallas"):
        s = _settings(1024, 256, 128, scatter=scatter)
        vis, rgba, st = Pipeline(s, "cpu").process(x)
        assert torch.isfinite(vis).all() and torch.isfinite(st.agc_ref).all()
        vis_s, _ = stream_signal(x, s, "cpu")
        assert np.isfinite(vis_s).all()


@pytest.mark.parametrize("kw", [
    dict(multires=True), dict(mode="natural"), dict(fft_method="direct"),
    dict(fft_impl="fourstep"), dict(fft_size=32768), dict(fft_size=65536),
])
def test_unsupported_settings_raise(kw):
    base = dict(mode="enhanced", multires=False, fft_size=8192)
    base.update(kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Pipeline(Settings(**base), "cpu")


def test_get_pipeline_caches_structural_projection():
    a = get_pipeline(_settings(1024, 256, 128, gain=2.0), "cpu")
    b = get_pipeline(_settings(1024, 256, 128, gain=9.0), "cpu")
    c = get_pipeline(_settings(2048, 256, 128), "cpu")
    assert a is b and a is not c
    assert a.reach == 2 and c.reach == 4


def test_short_signal_and_push_after_flush():
    s = _settings(1024, 256, 128)
    with pytest.raises(ValueError, match="at least 1024"):
        Pipeline(s, "cpu").process(np.zeros(1000, np.float32))
    st = Stream(s, "cpu")
    st.push(np.zeros(2000, np.float32))
    st.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        st.push(np.zeros(10, np.float32))


def test_pause_resume_and_overrun_skip():
    s = _settings(1024, 256, 128)
    x = _signal(1.0, seed=9)
    st = Stream(s, "cpu", ring_seconds=0.05)
    st.pause()
    assert st.push(x[:4000]) == []
    st.resume()
    cols = st.push(x[4000:])               # far more than the ring holds
    assert st.dropped_frames > 0
    idx = [c.index for c in cols]
    assert idx == sorted(idx) and st.last_column() is cols[-1]
    assert all(torch.isfinite(c.vis).all() for c in cols)
