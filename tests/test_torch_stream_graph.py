"""The live step with its hop counter ``t`` as a device tensor, on the
CPU: hop by hop against the JAX package's step, bit-exact against the
port's own batch path, guarded against any host read of ``t``, and the
``Stream``'s static tensors (the params setter, ``load_state``, an
overrun re-prime) against the JAX ``Stream``.

Five settings: enhanced with the relative histogram (``scatter="pallas"``;
the CPU runs B2's plain version), enhanced with the segment sum, natural
on the multires banks 8192/2048/512, the direct method, and enhanced on
the multires banks (the display default, three banks' deposits a hop;
the CPU's ``"auto"`` is the segment sum).  Each hop
sequence starts the window from zero (hops t < R emit nothing), re-primes
it mid-stream as an overrun does, and ends with the flush (a zeroed
window and R zero hops).

Tolerances against JAX, per hop: the masked hops and the emit indices
bit-equal; ``vis`` by ``compare_vis`` (enhanced: a float32 rounding flip
moves a quantized deposit one cell) or within 1e-4 (natural: float32 FFT
rounding only); on enhanced multires ``compare_vis`` admits a 1e-3 share
of the cells (``VIS_FRAC``): at hop 128 its 0.5 s raster holds ~20× the
deposits of the 1024-point settings' in 19k cells, so a few deposits
flip a row (one log2 ulp), and each one moved touches 3–9 cells of the
max-filtered raster through the smoothing EMA; RGBA bit-equal wherever the two ``vis`` quantize to the
same entry; the post state's AGC reference within 0.05 dB and its
smoothing state like ``vis``.  Against the port's batch path and between
the port's own runs: bit for bit.

The JAX package's relative histogram is a Pallas kernel, so its side of
the ``"pallas"`` setting runs through its plain reference, the segment
sum (the JAX package pins the two backends within 1e-5)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from emspec.config import Settings as JaxSettings
from emspec.io import synth
from emspec.pipeline import Pipeline as JaxPipeline
from emspec.stream import Stream as JaxStream
from emspec_torch.config import Settings
from emspec_torch.convert import params_from_jax
from emspec_torch.pipeline import Pipeline
from emspec_torch.stream import Stream
from emspec_torch.validate import compare_vis

SR = 48_000
CONFIGS = {
    "pallas": dict(mode="enhanced", multires=False, fft_size=1024, hop=256,
                   raster_height=128, scatter="pallas"),
    "segment_sum": dict(mode="enhanced", multires=False, fft_size=1024,
                        hop=256, raster_height=128, scatter="segment_sum"),
    "natural-multires": dict(mode="natural", raster_height=128),
    "direct": dict(mode="enhanced", multires=False, fft_size=1024, hop=256,
                   raster_height=128, fft_method="direct"),
    "enhanced-multires": dict(mode="enhanced", raster_height=128),
}
VIS_FRAC = {"enhanced-multires": 1e-3}    # compare_vis share, else 1e-4
SLIDERS = dict(gain=4.0, db_range=70.0, colormap="viridis", freq_scale=1.3,
               smoothing=0.4, brightness=0.6)


def _kw(config, **extra):
    kw = dict(smoothing=0.5, **CONFIGS[config])
    kw.update(extra)
    return kw


def _jax_settings(config, **extra):
    kw = _kw(config, **extra)
    if kw.get("scatter") == "pallas":
        kw["scatter"] = "segment_sum"
    return JaxSettings(**kw)


def _signal(seconds, seed):
    rng = np.random.default_rng(seed)
    return (synth.chirp(80.0, 9000.0, seconds)
            + synth.multitone([220.0, 440.0, 3520.0], seconds, amplitude=0.2)
            + 0.01 * rng.standard_normal(int(seconds * SR))
            ).astype(np.float32)


class _NoHostRead(torch.Tensor):
    """A tensor that refuses every read to the host: a Python branch, an
    int cast or an index on ``t`` fails."""

    def _refuse(self, *args, **kwargs):
        raise AssertionError("host read of the device hop counter")

    __bool__ = __int__ = __index__ = __float__ = item = tolist = _refuse


class _NoValueReads(TorchDispatchMode):
    """Fails any read of any tensor's value to the host (``roll`` or an
    index reading a 0-d tensor in C++, a branch on a comparison): on the
    card each one would end a graph capture."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("host read of a tensor inside the step")
        return func(*args, **(kwargs or {}))


def _plan(x, n, hop, reach, first, jump):
    """(window prefix or None, block) per hop, as ``Stream`` stages them:
    hops 0..first−1 from a primed window, a re-prime at frame ``jump``
    (an overrun's skip-ahead) running to the last full frame, then the
    flush: a zeroed window and ``reach`` zero hops."""
    def prime(f):
        return np.concatenate([np.zeros(hop, np.float32),
                               x[f * hop:f * hop + n - hop]])

    def block(f):
        return x[f * hop + n - hop:f * hop + n]

    last = (x.shape[-1] - n) // hop
    plan = [(prime(0) if f == 0 else None, block(f)) for f in range(first)]
    plan += [(prime(f) if f == jump else None, block(f))
             for f in range(jump, last + 1)]
    zero = np.zeros(hop, np.float32)
    plan += [(np.zeros(n, np.float32) if i == 0 else None, zero)
             for i in range(reach)]
    return plan


def _port_hops(pipe, p, plan, guard=False):
    """Drive ``_stream_step_rolling`` through ``plan`` → (vis, rgba,
    emit index) per hop and the final post state, all numpy."""
    window, (t, acc, post) = pipe.init_roll_carry()
    if guard:
        t = t.as_subclass(_NoHostRead)
    carry = (window, (t, acc, post))
    vis, rgba, idx = [], [], []
    for w_init, block in plan:
        if w_init is not None:
            carry[0].copy_(torch.from_numpy(w_init))
        with _NoValueReads() if guard else contextlib.nullcontext():
            carry, (v, c, i) = pipe._stream_step_rolling(
                carry, torch.from_numpy(block), p)
        vis.append(np.array(v))
        rgba.append(np.array(c))
        idx.append(int(np.array(i)))
    post = carry[1][2]
    return (np.stack(vis), np.stack(rgba), idx,
            (np.array(post.smooth), np.array(post.agc_ref)))


def _jax_hops(jp, jparams, plan):
    step = jax.jit(jp._stream_step_rolling)
    carry = jp.init_roll_carry()
    vis, rgba, idx = [], [], []
    for w_init, block in plan:
        if w_init is not None:
            carry = (jnp.asarray(w_init), carry[1])
        carry, (v, c, i) = step(carry, jnp.asarray(block), jparams)
        vis.append(np.asarray(v))
        rgba.append(np.asarray(c))
        idx.append(int(i))
    post = carry[1][2]
    return (np.stack(vis), np.stack(rgba), idx,
            (np.asarray(post.smooth), np.asarray(post.agc_ref)))


def _close_to_jax(config, want, got):
    """``vis``-like arrays (hops, rows) at this file's tolerance."""
    if CONFIGS[config]["mode"] == "natural":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        ok, worst, share = compare_vis(torch.from_numpy(np.array(want)),
                                       torch.from_numpy(np.array(got)),
                                       frac=VIS_FRAC.get(config, 1e-4))
        assert ok, (worst, share)


def _rgba_agree(vis_j, vis_t, rgba_j, rgba_t):
    """RGBA bit-equal wherever the two ``vis`` pick the same entry."""
    same = (np.clip(np.round(vis_j * 255), 0, 255)
            == np.clip(np.round(vis_t * 255), 0, 255))
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(rgba_t[same], rgba_j[same])


def _setup(config, seconds=0.5, seed=1):
    kw = _kw(config)
    tp = Pipeline(Settings(**kw), "cpu")
    jp = JaxPipeline(_jax_settings(config))
    return kw, tp, jp, _signal(seconds, seed)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_hops_match_jax_step(config):
    kw, tp, jp, x = _setup(config)
    n, hop, R = tp.n_max, tp.hop, tp.reach
    plan = _plan(x, n, hop, R, first=R + 6, jump=R + 14)
    jparams = jp.params()
    vis_t, rgba_t, idx_t, (sm_t, ref_t) = _port_hops(
        tp, params_from_jax(jparams, "cpu"), plan)
    vis_j, rgba_j, idx_j, (sm_j, ref_j) = _jax_hops(jp, jparams, plan)
    assert idx_t == idx_j == [t - R for t in range(len(plan))]
    # hops t < R emit nothing, bit for bit in both
    np.testing.assert_array_equal(vis_t[:R], vis_j[:R])
    np.testing.assert_array_equal(rgba_t[:R], rgba_j[:R])
    assert not vis_t[:R].any()
    _close_to_jax(config, vis_j, vis_t)
    _rgba_agree(vis_j, vis_t, rgba_j, rgba_t)
    np.testing.assert_allclose(ref_t, ref_j, rtol=0, atol=0.05)   # dB
    _close_to_jax(config, sm_j[None], sm_t[None])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_hops_bit_exact_with_batch_and_guarded_t(config):
    """From the start through the flush, the step emits the batch path's
    columns bit for bit and ends in its post state; the same hops with a
    ``t`` that refuses every host read, and no read of any tensor's value
    inside the step, give the same bits."""
    kw, tp, _, x = _setup(config, seconds=0.4, seed=2)
    n, hop, R = tp.n_max, tp.hop, tp.reach
    last = (x.shape[-1] - n) // hop
    plan = _plan(x, n, hop, R, first=0, jump=0)
    assert len(plan) == last + 1 + R
    p = tp.params()
    vis, rgba, _, (sm, ref) = _port_hops(tp, p, plan)
    vis_b, rgba_b, st_b = tp.process(x, p)
    np.testing.assert_array_equal(vis[R:], vis_b.numpy())
    np.testing.assert_array_equal(rgba[R:], rgba_b.numpy())
    np.testing.assert_array_equal(sm, st_b.smooth.numpy())
    np.testing.assert_array_equal(ref, st_b.agc_ref.numpy())
    guarded = _port_hops(tp, p, _plan(x, n, hop, R, first=R + 3,
                                      jump=R + 7), guard=True)
    plain = _port_hops(tp, p, _plan(x, n, hop, R, first=R + 3, jump=R + 7))
    for a, b in zip(guarded[:2] + guarded[3], plain[:2] + plain[3]):
        np.testing.assert_array_equal(a, b)
    assert guarded[2] == plain[2]


def _collect(stream, pushes, swap=None):
    """Push each chunk (``swap(stream)`` before chunk ``len(pushes)//2``),
    then flush → (emit indices, vis, rgba) host arrays."""
    cols = []
    for i, chunk in enumerate(pushes):
        if swap is not None and i == len(pushes) // 2:
            swap(stream)
        cols += stream.push(chunk)
    cols += stream.flush()
    return ([c.index for c in cols], np.stack([np.asarray(c.vis) for c in cols]),
            np.stack([np.asarray(c.rgba) for c in cols]))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_params_setter_mid_stream_matches_jax(config):
    """A slider move, a colormap change and a Freq-Scale zoom mid-stream:
    the port's setter copies into the tensors the step reads (the same
    objects before and after), the JAX stream swaps its params at the same
    hop, and the two streams agree."""
    kw = _kw(config)
    x = _signal(0.5, seed=3)
    pushes = [x[i:i + 1500] for i in range(0, x.shape[-1], 1500)]
    ts, js = Stream(Settings(**kw), "cpu"), JaxStream(_jax_settings(config))
    held = [t for t in ts.params.post] + [ts.params.lut, *ts.params.i0]
    before = [t.clone() for t in held]

    def swap_port(st):
        st.params = st.pipe.params(Settings(**kw).replace(**SLIDERS))

    def swap_jax(st):
        st.params = st.pipe.params(_jax_settings(config, **SLIDERS))
    idx_t, vis_t, rgba_t = _collect(ts, pushes, swap_port)
    idx_j, vis_j, rgba_j = _collect(js, pushes, swap_jax)
    assert idx_t == idx_j
    assert all(a is b for a, b in zip(
        held, [t for t in ts.params.post] + [ts.params.lut, *ts.params.i0]))
    assert not all(torch.equal(a, b) for a, b in zip(before, held))
    _close_to_jax(config, vis_j, vis_t)
    _rgba_agree(vis_j, vis_t, rgba_j, rgba_t)
    with pytest.raises(ValueError, match="params"):
        ts.params = Pipeline(Settings(**kw).replace(raster_height=64),
                             "cpu").params()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_state_roundtrip_into_static_tensors(config):
    """``load_state`` copies into the stream's own carry tensors (the same
    objects before and after) and the resumed stream continues bit for
    bit; ``state_dict`` reads ``t`` back from the device."""
    kw = _kw(config)
    x = _signal(0.4, seed=4)
    half = x.shape[-1] // 2
    st1 = Stream(Settings(**kw), "cpu")
    cols_a = st1.push(x[:half])
    sd = st1.state_dict()
    assert sd["carry"][1][0] == st1._t == int(st1._carry[1][0])
    st2 = Stream(Settings(**kw), "cpu")
    held = [st2._carry[0], *st2._carry[1][:2], *st2._carry[1][2]]
    st2.load_state(sd)
    assert all(a is b for a, b in zip(
        held, [st2._carry[0], *st2._carry[1][:2], *st2._carry[1][2]]))
    st2.ring = st1.ring
    cols_b = st2.push(x[half:]) + st2.flush()
    ref = Stream(Settings(**kw), "cpu")
    want = ref.push(x) + ref.flush()
    got = cols_a + cols_b
    assert [c.index for c in got] == [c.index for c in want]
    for a, b in zip(got, want):
        assert torch.equal(a.vis, b.vis) and torch.equal(a.rgba, b.rgba)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_overrun_reprime_matches_jax_stream(config):
    """A push far larger than the ring: both streams skip to the newest
    full frame, re-prime the window, count the same dropped frames and
    emit the same column indices and values."""
    kw = _kw(config)
    x = _signal(1.0, seed=5)
    tp = Pipeline(Settings(**kw), "cpu")
    ring = (tp.n_max + 10 * tp.hop) / SR
    pushes = [x[:tp.n_max + 4 * tp.hop], x[tp.n_max + 4 * tp.hop:]]
    ts = Stream(Settings(**kw), "cpu", ring_seconds=ring)
    js = JaxStream(_jax_settings(config), ring_seconds=ring)
    idx_t, vis_t, rgba_t = _collect(ts, pushes)
    idx_j, vis_j, rgba_j = _collect(js, pushes)
    assert ts.dropped_frames == js.dropped_frames > 0
    assert idx_t == idx_j
    _close_to_jax(config, vis_j, vis_t)
    _rgba_agree(vis_j, vis_t, rgba_j, rgba_t)
