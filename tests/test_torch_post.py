"""Port post chain and colormap against the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages.  Tolerances:
``vis`` ≤ 1e-6 absolute (float32 log10 ulps differ between XLA and
torch; the display quantum is 1/255) and RGBA within one quantum (a
value on a rounding edge may land on either side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from emspec.config import Settings
from emspec.dsp.multires import log_freq_axis
from emspec.dsp.pallas.lut import lut_lookup as jax_lut_lookup
from emspec.post import chain as jchain
from emspec.post import colormap as jcolormap
from emspec_torch.convert import post_state_from_jax
from emspec_torch.dsp.kernels.lut import lut_lookup
from emspec_torch.post import chain as tchain
from emspec_torch.post.colormap import apply_lut

ROWS = 96
VIS_ATOL = 1e-6
# one jit compile per shape is far cheaper than eager per-op dispatch
_jax_batch = jax.jit(jchain.postprocess_batch, static_argnums=(3,))
_jax_column = jax.jit(jchain.postprocess_column, static_argnums=(3,))


def _params(**kw):
    s = Settings(smoothing=0.4, agc_strength=0.8, **kw)
    f = log_freq_axis(ROWS, s.freq_min, s.sample_rate / 2.0)
    return (jchain.PostParams.from_settings(s, f),
            tchain.PostParams.from_settings(s, f, "cpu"))


def _power(shape, seed):
    rng = np.random.default_rng(seed)
    p = 10.0 ** rng.uniform(-14.0, 0.0, shape)
    p[rng.uniform(size=shape) < 0.05] = 0.0
    return p.astype(np.float32)


def test_post_params_from_settings_match():
    jp, tp = _params(gain=7.0, low_end_boost=2.5)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("lead,agc_global", [((), False), ((2,), False),
                                             ((2,), True), ((3,), True)])
def test_postprocess_batch_matches_jax(lead, agc_global):
    jp, tp = _params()
    power = _power((37,) + lead + (ROWS,), seed=len(lead) + 10 * agc_global)
    js = jchain.PostState.init(lead + (ROWS,))
    want, wstate = _jax_batch(jnp.asarray(power), js, jp, agc_global)
    got, gstate = tchain.postprocess_batch(
        torch.from_numpy(power), post_state_from_jax(js, "cpu"), tp,
        agc_global)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VIS_ATOL)
    np.testing.assert_allclose(gstate.smooth.numpy(),
                               np.asarray(wstate.smooth), atol=VIS_ATOL)
    np.testing.assert_allclose(gstate.agc_ref.numpy(),
                               np.asarray(wstate.agc_ref), atol=1e-4)


@pytest.mark.parametrize("lead,agc_global", [((), False), ((2,), True)])
def test_postprocess_column_matches_jax_and_batch(lead, agc_global):
    """Per-column steps match JAX, and scanning them reproduces the
    port's own batch chain bit for bit (streaming ≡ batch)."""
    jp, tp = _params()
    power = _power((9,) + lead + (ROWS,), seed=3)
    js = jchain.PostState.init(lead + (ROWS,))
    ts = post_state_from_jax(js, "cpu")
    cols = []
    for t in range(power.shape[0]):
        want, js = _jax_column(jnp.asarray(power[t]), js, jp, agc_global)
        got, ts = tchain.postprocess_column(torch.from_numpy(power[t]), ts,
                                            tp, agc_global)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=VIS_ATOL)
        cols.append(got)
    batch, bstate = tchain.postprocess_batch(
        torch.from_numpy(power), tchain.PostState.init(lead + (ROWS,), "cpu"),
        tp, agc_global)
    assert torch.equal(torch.stack(cols), batch)
    assert torch.equal(bstate.smooth, ts.smooth)
    assert torch.equal(bstate.agc_ref, ts.agc_ref)


def test_postprocess_batch_rgba_within_one_quantum():
    jp, tp = _params()
    power = _power((50, 2, ROWS), seed=21)
    js = jchain.PostState.init((2, ROWS))
    want, _ = _jax_batch(jnp.asarray(power), js, jp, False)
    got, _ = tchain.postprocess_batch(torch.from_numpy(power),
                                      post_state_from_jax(js, "cpu"), tp)
    table = jcolormap.lut("inferno")
    rw = np.asarray(jcolormap.apply_lut(want, jnp.asarray(table)))
    rg = apply_lut(got, torch.from_numpy(table.copy())).numpy()
    assert np.abs(rw.astype(int) - rg.astype(int)).max() <= 1


def test_empty_batch_keeps_state():
    _, tp = _params()
    st = tchain.PostState.init((ROWS,), "cpu")
    out, st2 = tchain.postprocess_batch(torch.zeros(0, ROWS), st, tp)
    assert out.shape == (0, ROWS)
    assert torch.equal(st2.smooth, st.smooth)


@pytest.mark.parametrize("cmap", ["inferno", "turbo", "grayscale"])
def test_apply_lut_plain_bit_equal_to_jax(cmap):
    rng = np.random.default_rng(5)
    vals = rng.uniform(-0.1, 1.1, (37, 2, ROWS)).astype(np.float32)
    table = jcolormap.lut(cmap)
    want = np.asarray(jcolormap.apply_lut(jnp.asarray(vals),
                                          jnp.asarray(table)))
    got = apply_lut(torch.from_numpy(vals), torch.from_numpy(table.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_lookup_plain_bit_equal_to_pallas_interpret():
    rng = np.random.default_rng(14)
    idx = rng.integers(0, 256, (300, 64)).astype(np.int32)
    table = jcolormap.lut("magma")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_lut_lookup(jnp.asarray(idx), jnp.asarray(table)))
    before = lut_lookup.launches
    got = lut_lookup(torch.from_numpy(idx), torch.from_numpy(table.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert lut_lookup.launches == before  # the CPU route never launches
