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
  ±inf in b; and ``post_tail``'s scan in the form its kernel picks
  (``mirror_post_tail_scan``: pipelined above |α| = 0.5) the same way
  over zero-input runs, with the form's rule held to a brute-force
  search for the fixed points of ``y ← RN(α·y)``;
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


# ----------------------------------------- post_tail's two scan forms
PIPE_TILE = 288      # csrc/post_chain.cu kPipeTile: steps a tile
PIPE_COLS = 4        # kPipeCols: columns a block (a chain warp's lanes)
TINY = np.float32(2.0 ** -149)
SILENCE_ALPHAS = (0.5, 0.51, 0.6, 0.75, 0.9, 0.99)


def mirror_pipelined(y0: torch.Tensor, alpha, b: torch.Tensor):
    """The pipelined form: every block's chain warp steps its
    ``PIPE_COLS`` columns from y0 through tiles of ``PIPE_TILE`` steps
    (the blocks side by side, as on the card) → (ys, y_final)."""
    t = b.shape[0]
    c = math.prod(b.shape[1:])
    bf, y = b.reshape(t, c), y0.reshape(c).clone()
    ys = torch.empty_like(bf)
    for c0 in range(0, c, PIPE_COLS):
        cols = slice(c0, c0 + PIPE_COLS)
        for m in range(-(-t // PIPE_TILE)):
            for i in range(m * PIPE_TILE, min(t, (m + 1) * PIPE_TILE)):
                y[cols] = _step(y[cols], alpha, bf[i, cols])
                ys[i, cols] = y[cols]
    return ys.reshape(b.shape), y.reshape(y0.shape)


def mirror_post_tail_scan(y0, alpha, b, window=None):
    """``post_tail``'s scan as its kernel runs it → (ys, y_final, repaired
    chunks, form): the form by ``post.pipelined``, the chunk-parallel one
    on ``mirror_scan``."""
    if post.pipelined(float(alpha), window):
        ys, fin = mirror_pipelined(y0, alpha, b)
        return ys, fin, 0, "pipelined"
    ys, fin, repaired = mirror_scan(y0, alpha, b, window)
    return ys, fin, repaired, "chunked"


def _silence_case(case: str, alpha: float, window):
    """(b, y0) on 6 columns of 20 chunks (L = 16): b = (1 − α)·vis with
    vis in [0.05, 1], and runs of exact zeros (a gated cell's input)."""
    t, c = 20 * L, 6
    rng = np.random.default_rng(SILENCE_CASES.index(case))
    a = np.float32(alpha)
    vis = rng.uniform(0.05, 1.0, (t, c)).astype(np.float32)
    y0 = rng.uniform(0.2, 1.0, c).astype(np.float32)
    runs = {"run 1": 1, "run L - 1": L - 1, "run L": L, "run 3L + 5": 3 * L + 5}
    if case in runs:
        for j in range(c):          # each column's run at its own offset
            s0 = 5 * L + 3 + 7 * j
            vis[s0:s0 + runs[case], j] = 0.0
    elif case.startswith("silent from 0"):
        vis[:8 * L] = 0.0
        if case.endswith("y0 0"):
            y0[:] = 0.0
    elif case == "inside a warm-up":
        # from inside chunk 8's warm-up to inside chunk 9's
        w8 = ema.window_len(a, 8 * L, window)
        w9 = ema.window_len(a, 9 * L, window)
        vis[8 * L - max(w8 // 2, 1):9 * L - w9 // 2 + L // 2] = 0.0
    elif case == "non-finite":
        vis[4 * L:10 * L] = 0.0
        vis[4 * L - 1, 0] = np.nan              # NaN just before
        vis[10 * L, 1] = np.inf                 # ±inf, NaN just after
        vis[10 * L, 2] = -np.inf
        vis[10 * L, 3] = np.nan
        vis[:4 * L, 4:] = 0.0                   # y0 +inf and NaN in silence
        y0[4], y0[5] = np.inf, np.nan
    b = (np.float32(1.0) - a) * vis
    return torch.from_numpy(b), torch.from_numpy(y0)


SILENCE_CASES = ("run 1", "run L - 1", "run L", "run 3L + 5",
                 "silent from 0, y0 0", "silent from 0, y0 > 0",
                 "inside a warm-up", "non-finite")


@pytest.mark.parametrize("window", [None, 0])
@pytest.mark.parametrize("alpha", SILENCE_ALPHAS, ids=str)
@pytest.mark.parametrize("case", SILENCE_CASES)
def test_post_tail_forms_bit_equal_over_silence(case, alpha, window):
    """``post_tail``'s scan in the form its kernel takes (pipelined above
    one half, chunk-parallel at 0.5 and with W forced to 0) against the
    plain loop, bit for bit, over zero-input runs of 1, L − 1, L and
    3L + 5 steps, columns silent from step 0 (y0 0 and > 0), a stretch
    from inside one warm-up to inside the next, NaN and ±inf beside a
    stretch and y0 = ±inf or NaN; the pipelined form repairs nothing."""
    b, y0 = _silence_case(case, alpha, window)
    a = torch.tensor(np.float32(alpha))
    ys, fin, repaired, form = mirror_post_tail_scan(y0, a, b, window)
    _assert_bit_equal((ys, fin), ema.ema_scan_plain(y0, a, b))
    assert form == ("pipelined" if alpha > 0.5 and window is None
                    else "chunked")
    if form == "pipelined":
        assert repaired == 0


def _kmax(alpha) -> int:
    """The largest k with RN(α·k·2⁻¹⁴⁹) = k·2⁻¹⁴⁹ in float32, by search."""
    a = np.float32(alpha)
    k = np.arange(int(0.5 / (1.0 - float(a))) + 4, dtype=np.float32)
    return int(np.nonzero(a * (k * TINY) == k * TINY)[0].max())


def test_the_kernels_form_rule_against_a_fixed_point_search():
    """The kernel is pipelined exactly where zero inputs hold
    ``y ← RN(α·y)`` on a nonzero fixed point (k_max ≥ 1): a brute-force
    float32 search over α ∈ [0, 1) on a grid of 10⁻⁴ (and 0.5's
    neighbours).  From above every α lands on k_max·2⁻¹⁴⁹ (0 at α ≤ 0.5,
    the chunk-parallel form's guess), from 0 stays at 0, and NaN and
    +inf stay themselves: none of those is the guess above one half."""
    grid = np.arange(0, 10_000, dtype=np.float64) / 10_000
    grid = np.concatenate([grid, [np.nextafter(np.float32(0.5), 0),
                                  np.nextafter(np.float32(0.5), 1)]])
    kmax = np.array([_kmax(a) for a in grid.astype(np.float32)])
    assert all(post.pipelined(a) == (k >= 1)
               for a, k in zip(grid.astype(np.float32), kmax))
    assert [_kmax(a) for a in (0.5, 0.6, 0.75, 0.9, 0.99)] == [0, 1, 2, 4, 50]
    for alpha in (0.3, 0.5) + SILENCE_ALPHAS[1:]:
        a = np.float32(alpha)
        y = np.array([1.0, 1e-30, 0.0, np.nan, np.inf], dtype=np.float32)
        for _ in range(12_000):     # > the longest descent, 9,865 at 0.99
            y = a * y + np.float32(0.0)
        assert y[0] == y[1] == _kmax(a) * TINY
        assert y[2] == 0.0 and np.isnan(y[3]) and y[4] == np.inf
    assert post.pipelined(float("nan")) and post.pipelined(-0.7)
    assert not post.pipelined(0.99, window=0)


def test_silence_walks_in_the_chunked_form_only_above_one_half():
    """Why the form turns at one half: after content, 40 chunks of zero
    input.  The chunk-parallel form repairs at most the chunks whose
    warm-up starts within the state's fall to 0 at α = 0.5 (~150 steps),
    and every chunk of the stretch at 0.6, whose exact state stays on
    2⁻¹⁴⁹; the pipelined form walks it once and repairs none."""
    t, c = 50 * L, 4
    rng = np.random.default_rng(9)
    vis = rng.uniform(0.05, 1.0, (t, c)).astype(np.float32)
    vis[8 * L:48 * L] = 0.0
    y0 = torch.zeros(c)
    repaired = {}
    for alpha in (0.5, 0.6):
        a = torch.tensor(np.float32(alpha))
        b = torch.from_numpy((np.float32(1.0) - np.float32(alpha)) * vis)
        ys, fin, repaired[alpha] = mirror_scan(y0, a, b)
        _assert_bit_equal((ys, fin), ema.ema_scan_plain(y0, a, b))
    assert repaired[0.5] <= (-(-150 // L) + 1) * c
    assert repaired[0.6] >= 38 * c
