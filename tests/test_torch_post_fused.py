"""The batch post chain's fused form (``dsp.kernels.post``: ``post_head``
and ``post_tail`` around the chunk-parallel ``ema_scan``) on the CPU: a
torch mirror of the kernels' schedule, and the fused composition against
the torch chain and the JAX package.

The mirror (``mirror_scan``) runs what ``csrc/ema_chunk.cuh`` runs, for
every chunk and column at once: chunks of ``chunk_len(t, C)`` steps, each
speculating from a warm-up of ``window_len(α, s_k)`` steps (from y0 where
that reaches step 0, else from 0), the boundaries verified bit for bit,
and the failed ones repaired by walking the exact and the speculative
trajectories until their bits agree.  Tolerances:

* the mirror against the plain loop: bit for bit (int32 views, so NaN
  payloads count), at every W, forced W = 0 included, and with NaN and
  ±inf in b;
* the fused composition (the plain versions through ``_fused_batch``)
  against ``postprocess_batch`` on the CPU: bit for bit;
* against JAX's ``postprocess_batch(associative=False)``:
  ``test_torch_post_scan``'s bounds — ``vis`` and the smoothing state
  1e-6 absolute (float32 log10 ulps differ between XLA and torch; the
  display quantum is 1/255), the AGC state 1e-4 dB.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.config import Settings
from emspec.dsp.multires import log_freq_axis
from emspec.post import chain as jchain
from emspec_torch.convert import post_state_from_jax
from emspec_torch.dsp.kernels import ema, post
from emspec_torch.post import chain as tchain

ROWS = 48
L = ema.MIN_CHUNK           # the chunk length at every mirror shape below
TS = (0, 1, L - 1, L, L + 1, 2 * L + 1, 5937)
LEADS = ((), (16,), (2, 3))
_jax_batch = jax.jit(jchain.postprocess_batch, static_argnums=(3, 4))


def _alphas():
    """(id, α): the display default's slider, two slider values as 0-d
    float32 tensors, and the AGC's decay as a Python float."""
    return [("0", torch.tensor(np.float32(0.0))),
            ("0.37", torch.tensor(np.float32(0.37))),
            ("0.6", torch.tensor(np.float32(0.6))),
            ("0.99", 0.99)]


ALPHAS = _alphas()


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _step(y, alpha, x):
    return torch.mul(y, alpha) + x


def mirror_scan(y0: torch.Tensor, alpha, b: torch.Tensor,
                window: int | None = None):
    """The kernels' schedule → (ys, y_final, repaired chunks)."""
    t = b.shape[0]
    if t == 0:
        return b, y0, 0
    c = math.prod(b.shape[1:])
    bf, y0f = b.reshape(t, c), y0.reshape(c)
    Lc = ema.chunk_len(t, c)
    K = -(-t // Lc)
    s = torch.arange(K) * Lc
    end = torch.clamp(s + Lc, max=t)
    w = torch.tensor([0] + [ema.window_len(float(alpha), int(sk), window)
                            for sk in s[1:]])
    start = s - w
    # speculate: every chunk at once, relative step r from −max W
    y = torch.where((start == 0)[:, None], y0f, torch.zeros(K, c))
    ys = torch.empty_like(bf)
    rec = y.clone()
    for r in range(-int(w.max()), Lc):
        j = s + r
        on = (j >= start) & (j < end)
        if bool(on.any()):
            x = bf[torch.clamp(j, 0, t - 1)]
            y = torch.where(on[:, None], _step(y, alpha, x), y)
        if r == -1:
            rec = y.clone()
        if r >= 0:
            ys[j[on]] = y[on]
    fin, y_final = y, y[K - 1].clone()
    # verify and repair: the columns walk in lockstep over the steps
    bad = torch.zeros(K, c, dtype=torch.bool)
    bad[1:] = _bits(rec[1:]) != _bits(fin[:-1])
    walking = torch.zeros(c, dtype=torch.bool)
    ye, ysp = torch.zeros(c), torch.zeros(c)
    counted = torch.full((c,), -1)
    repaired = 0
    j = t
    if bool(bad.any()):
        j = int(s[int(bad.any(1).nonzero()[0])])
    while j < t:
        k = j // Lc
        if j == int(s[k]):
            start_now = ~walking & bad[k]
            ye = torch.where(start_now, fin[k - 1], ye)
            ysp = torch.where(walking | start_now, rec[k], ysp)
            walking |= start_now
        if not bool(walking.any()):
            later = bad[k + 1:].any(1).nonzero()
            j = t if later.numel() == 0 else int(s[k + 1 + int(later[0])])
            continue
        x = bf[j]
        ye, ysp = _step(ye, alpha, x), _step(ysp, alpha, x)
        met = walking & (_bits(ye) == _bits(ysp))
        store = walking & ~met
        ys[j] = torch.where(store, ye, ys[j])
        new = store & (counted != k)
        repaired += int(new.sum())
        counted = torch.where(new, k, counted)
        walking &= ~met
        j += 1
    y_final = torch.where(walking, ye, y_final)
    return ys.reshape(b.shape), y_final.reshape(y0.shape), repaired


def _series(t, lead, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((t,) + lead).astype(
                np.float32)),
            torch.from_numpy(rng.standard_normal(lead).astype(np.float32)))


def _assert_bit_equal(got, want):
    ys, fin = got
    ps, pfin = want
    assert ys.shape == ps.shape and fin.shape == pfin.shape
    assert torch.equal(_bits(ys), _bits(ps))
    assert torch.equal(_bits(fin), _bits(pfin))


@pytest.mark.parametrize("lead", LEADS, ids=str)
@pytest.mark.parametrize("alpha", [a for _, a in ALPHAS],
                         ids=[i for i, _ in ALPHAS])
@pytest.mark.parametrize("t", TS)
def test_mirror_bit_equal_to_the_plain_loop(t, alpha, lead):
    """Every chunk boundary (L − 1, L, L + 1, 2L + 1), the multires length,
    each α, leads of 1, 16 and 6 columns, nonzero y0."""
    b, y0 = _series(t, lead, seed=t + len(lead))
    assert t == 0 or ema.chunk_len(t, max(1, math.prod(lead))) == L
    ys, fin, _ = mirror_scan(y0, alpha, b)
    _assert_bit_equal((ys, fin), ema.ema_scan_plain(y0, alpha, b))
    if t == 0:
        assert fin is y0


@pytest.mark.parametrize("lead", LEADS, ids=str)
@pytest.mark.parametrize("t", TS)
def test_mirror_forced_repair_of_every_chunk(t, lead):
    """W forced to 0 at α = 0.99: every boundary fails, the repair walks
    every chunk after the first, and the result is still the loop's."""
    b, y0 = _series(t, lead, seed=50 + t)
    ys, fin, repaired = mirror_scan(y0, 0.99, b, window=0)
    _assert_bit_equal((ys, fin), ema.ema_scan_plain(y0, 0.99, b))
    chunks = -(-t // L)
    assert repaired == max(chunks - 1, 0) * max(1, math.prod(lead))


@pytest.mark.parametrize("alpha", [a for _, a in ALPHAS],
                         ids=[i for i, _ in ALPHAS])
@pytest.mark.parametrize("t,c", [(372, 512), (1437, 512), (372, 8192)])
def test_mirror_at_the_paths_shapes(t, c, alpha):
    """Chunks longer than the shortest (48 steps at 372 × 8192) and the
    paths' widths; with the default W the speculation mostly holds."""
    rng = np.random.default_rng(t + c)
    b = torch.from_numpy(rng.uniform(0, 1, (t, c)).astype(np.float32))
    y0 = torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32))
    ys, fin, repaired = mirror_scan(y0, alpha, b)
    _assert_bit_equal((ys, fin), ema.ema_scan_plain(y0, alpha, b))
    K = -(-t // ema.chunk_len(t, c))
    assert repaired <= (K - 1) * c // 2


@pytest.mark.parametrize("alpha", [a for _, a in ALPHAS],
                         ids=[i for i, _ in ALPHAS])
@pytest.mark.parametrize("window", [None, 0])
def test_mirror_propagates_nan_and_inf_as_the_loop(alpha, window):
    """NaN, +inf and −inf in b, at chunk boundaries and inside chunks:
    the same bits as the plain loop, payloads included."""
    b, y0 = _series(200, (5,), seed=3)
    b[L - 1, 0] = float("nan")
    b[L, 1] = float("inf")
    b[2 * L + 3, 2] = float("-inf")
    b[5 * L, 3] = float("inf")
    b[5 * L + 1, 3] = float("-inf")
    b[150:, 4] = float("nan")
    ys, fin, _ = mirror_scan(y0, alpha, b, window)
    _assert_bit_equal((ys, fin), ema.ema_scan_plain(y0, alpha, b))


def test_schedule_depends_on_the_shape_alone():
    """L from (t, C): a multiple of 8, at least ``MIN_CHUNK``, about
    ``TARGET_THREADS`` threads where the shape has them; W from α: 1 at
    0, capped at s, s at |α| ≥ 1 or NaN, growing as α nears 1 (24 bits
    of contraction and 4/(1 − α) steps more)."""
    for t, c in [(5937, 512), (372, 512), (372, 8192), (5937, 1), (1, 1)]:
        Lc = ema.chunk_len(t, c)
        assert Lc % 8 == 0 and Lc >= ema.MIN_CHUNK
        assert Lc == ema.MIN_CHUNK or -(-t // Lc) * c <= \
            ema.TARGET_THREADS + c
    assert ema.chunk_len(5937, 512) == 48
    assert ema.window_len(0.0, 48) == 1
    assert ema.window_len(0.6, 10_000) < ema.window_len(0.99, 10_000) < \
        ema.window_len(0.999, 100_000)
    assert 35 <= ema.window_len(0.6, 10_000) <= 50
    assert 1800 <= ema.window_len(0.99, 10_000) <= 2300
    assert ema.window_len(0.99, 48) == 48
    assert ema.window_len(1.0, 96) == ema.window_len(float("nan"), 96) == 96
    assert ema.window_len(0.6, 96, forced=0) == 0


# ------------------------------------------------------------ the chain
def _params(smoothing):
    s = Settings(smoothing=smoothing, agc_strength=0.8)
    f = log_freq_axis(ROWS, s.freq_min, s.sample_rate / 2.0)
    return (jchain.PostParams.from_settings(s, f),
            tchain.PostParams.from_settings(s, f, "cpu"))


def _power(shape, seed):
    rng = np.random.default_rng(seed)
    p = 10.0 ** rng.uniform(-14.0, 0.0, shape)
    p[rng.uniform(size=shape) < 0.05] = 0.0
    return p.astype(np.float32)


@contextlib.contextmanager
def _one_thread():
    """torch's CPU ``log10`` (MKL's vector math, split over the intra-op
    threads) gave 1-ulp differences on part of a 300 × 48 tensor between
    two calls in one process, once in a few runs of this file, and never
    with one thread: the two sides of a bit-for-bit comparison of CPU
    chains run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _fused_plain(power, st, tp, agc_global):
    """The card's composition with every wrapper on its plain version:
    no kernel launches on the CPU."""
    before = (post.post_head.launches, ema.ema_scan.launches,
              post.post_tail.launches)
    got = tchain._fused_batch(power, st, tp, agc_global,
                              tuple(range(1, power.ndim - 1)), None)
    assert (post.post_head.launches, ema.ema_scan.launches,
            post.post_tail.launches) == before
    return got


@pytest.mark.parametrize("smoothing", [0.0, 0.6])
@pytest.mark.parametrize("lead,agc_global", [((), False), ((3,), False),
                                             ((3,), True), ((2, 2), True)])
def test_fused_composition_matches_the_chain_and_jax(lead, agc_global,
                                                     smoothing):
    jp, tp = _params(smoothing)
    power = _power((300,) + lead + (ROWS,), seed=7 + len(lead))
    js = jchain.PostState.init(lead + (ROWS,))
    st = post_state_from_jax(js, "cpu")
    with _one_thread():
        got, gst = _fused_plain(torch.from_numpy(power), st, tp, agc_global)
        want, wst = tchain.postprocess_batch(torch.from_numpy(power), st, tp,
                                             agc_global)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(gst.smooth), _bits(wst.smooth))
    assert torch.equal(_bits(gst.agc_ref), _bits(wst.agc_ref))
    jwant, jst = _jax_batch(jnp.asarray(power), js, jp, agc_global, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=1e-6)
    np.testing.assert_allclose(gst.smooth.numpy(), np.asarray(jst.smooth),
                               atol=1e-6)
    np.testing.assert_allclose(gst.agc_ref.numpy(), np.asarray(jst.agc_ref),
                               atol=1e-4)


@pytest.mark.parametrize("window", [None, 0])
def test_post_tail_on_the_mirrored_schedule(window):
    """``post_tail``'s cell (stages 1–7 in, 8 out) on the mirror, forced
    repair included: the plain ``post_tail`` bit for bit."""
    _, tp = _params(0.6)
    power = torch.from_numpy(_power((200, 2, ROWS), seed=5))
    refs = post.post_head_plain(power, tp.low_end_ramp, tp.gain)
    y0 = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, ROWS)).astype(np.float32))
    with _one_thread():
        vis = post.agc_gate_norm(post.boost_db(power, tp.low_end_ramp,
                                               tp.gain), refs, tp)
        want, wfin = post.post_tail_plain(power, refs, y0, tp)
    ys, fin, _ = mirror_scan(y0, tp.smoothing, (1.0 - tp.smoothing) * vis,
                             window)
    assert torch.equal(_bits(post.brightness_clip(ys, tp)), _bits(want))
    assert torch.equal(_bits(fin), _bits(wfin))


def test_post_head_scale_rounds_as_the_scan_input():
    """``scale``·peak is the AGC scan's input as ``_ema_scan`` forms it,
    ``(1.0 − 0.99)·peak``."""
    _, tp = _params(0.0)
    power = torch.from_numpy(_power((64, 3, ROWS), seed=2))
    with _one_thread():
        peak = post.post_head_plain(power, tp.low_end_ramp, tp.gain)
        _, want = tchain._boost_db_peak(power, tp, False, (1,))
        scaled = post.post_head_plain(power, tp.low_end_ramp, tp.gain,
                                      scale=1.0 - tchain.AGC_DECAY)
    assert torch.equal(peak, want)
    assert torch.equal(scaled, (1.0 - tchain.AGC_DECAY) * want)


def test_empty_series_keeps_the_state():
    _, tp = _params(0.6)
    st = tchain.PostState.init((2, ROWS), "cpu")
    out, st2 = _fused_plain(torch.zeros(0, 2, ROWS), st, tp, False)
    assert out.shape == (0, 2, ROWS)
    assert st2.smooth is st.smooth and st2.agc_ref is st.agc_ref


@pytest.mark.parametrize("which", ["post_head", "post_tail", "chain"])
def test_wrappers_refuse_a_tensor_off_cpu_and_cuda(which):
    """No fallback: a meta tensor goes to the kernel or raises."""
    _, tp = _params(0.0)
    meta = tchain.PostParams(*(x.to("meta") for x in tp))
    power = torch.empty((4, ROWS), device="meta")
    with pytest.raises(ValueError, match="post_head|post_tail"):
        if which == "post_head":
            post.post_head(power, meta.low_end_ramp, meta.gain)
        elif which == "post_tail":
            post.post_tail(power, torch.empty(4, device="meta"),
                           torch.empty(ROWS, device="meta"), meta)
        else:
            tchain.postprocess_batch(
                power, tchain.PostState.init((ROWS,), "meta"), meta)
