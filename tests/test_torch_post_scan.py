"""The batch post chain's EMA scan (``post.chain._ema_scan``, kernel
``ema_scan``'s plain version on the CPU) against the JAX package, against
the port's own column-by-column chain (the kernel's chunk schedule is
mirrored in ``test_torch_post_fused.py``).

Tolerances:

* the sequential scan against the JAX package's sequential ``lax.scan``:
  XLA's CPU backend contracts its step ``α·y + b`` into one fused
  multiply-add, where the port (and its kernel, ``__fmul_rn`` then
  ``__fadd_rn``) rounds the product first, as the live step does.  Each
  step then differs by at most one rounding of the product, and the
  recurrence shrinks old differences by α a step, so |Δ| ≤ 2·ε·max|y|·
  min(t, 1/(1 − α)).  Against a float32 model of "multiply, round, add,
  round" the port is bit-equal;
* the associative form against JAX's associative form and against the
  sequential form: ~log2(t)·ε relative, the JAX docstring's bound, here
  4·⌈log2 t⌉·ε·max|y| (both compose in another order);
* ``postprocess_batch`` against JAX: ``vis`` 1e-6 absolute
  (``test_torch_post``'s bound: float32 log10 ulps differ between XLA and
  torch; the display quantum is 1/255), the AGC state 1e-4 dB;
* batch ≡ column by column: bit for bit, both EMA inputs hop by hop.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from emspec.config import Settings
from emspec.dsp.multires import log_freq_axis
from emspec.post import chain as jchain
from emspec_torch.convert import post_state_from_jax
from emspec_torch.dsp.kernels import ema
from emspec_torch.post import chain as tchain

ROWS = 48
EPS = float(np.finfo(np.float32).eps)
TS = (0, 1, 7, 372, 1437)
LEADS = ((), (2,), (2, 3))
_jax_scan = jax.jit(jchain._ema_scan, static_argnums=(3,))
_jax_batch = jax.jit(jchain.postprocess_batch, static_argnums=(3, 4))


def _series(t, lead, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t,) + lead).astype(np.float32),
            rng.standard_normal(lead).astype(np.float32))


def _alphas():
    """(JAX α, port α, float α): the AGC's Python-float decay and a
    smoothing slider's 0-d float32 tensor."""
    a = np.float32(0.37)
    return [(jchain.AGC_DECAY, tchain.AGC_DECAY, tchain.AGC_DECAY),
            (jnp.float32(a), torch.tensor(a), float(a))]


def _unfused_model(y0, alpha, xs):
    """float32 numpy: b = (1 − α)·x, then y ← round(round(α·y) + b)."""
    a = np.float32(alpha)
    b = (np.float32(1.0 - alpha) if isinstance(alpha, float)
         else np.float32(1.0) - a) * xs
    y, ys = y0.copy(), np.empty_like(xs)
    for i in range(xs.shape[0]):
        y = (a * y).astype(np.float32) + b[i]
        ys[i] = y
    return ys, y


@pytest.mark.parametrize("lead", LEADS, ids=str)
@pytest.mark.parametrize("t", TS)
def test_sequential_scan_matches_jax_and_the_unfused_step(t, lead):
    xs, y0 = _series(t, lead, seed=t + len(lead))
    for ja, ta, fa in _alphas():
        want, wfin = _jax_scan(jnp.asarray(y0), ja, jnp.asarray(xs), False)
        got, gfin = tchain._ema_scan(torch.from_numpy(y0), ta,
                                     torch.from_numpy(xs), False)
        assert got.shape == xs.shape and gfin.shape == y0.shape
        if t == 0:
            np.testing.assert_array_equal(gfin.numpy(), y0)
            continue
        m_ys, m_fin = _unfused_model(y0, fa, xs)
        np.testing.assert_array_equal(got.numpy(), m_ys)
        np.testing.assert_array_equal(gfin.numpy(), m_fin)
        bound = 2 * EPS * max(1.0, float(np.abs(m_ys).max())) * min(
            t, 1.0 / (1.0 - fa))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=bound)
        np.testing.assert_allclose(gfin.numpy(), np.asarray(wfin), rtol=0,
                                   atol=bound)


@pytest.mark.parametrize("lead", [(), (2, 3)], ids=str)
@pytest.mark.parametrize("t", [1, 7, 372, 1437])
def test_associative_scan_matches_jax_and_the_sequential_form(t, lead):
    xs, y0 = _series(t, lead, seed=100 + t)
    for ja, ta, _ in _alphas():
        want, _ = _jax_scan(jnp.asarray(y0), ja, jnp.asarray(xs), True)
        got, gfin = tchain._ema_scan(torch.from_numpy(y0), ta,
                                     torch.from_numpy(xs), True)
        seq, _ = tchain._ema_scan(torch.from_numpy(y0), ta,
                                  torch.from_numpy(xs), False)
        scale = max(1.0, float(np.abs(seq.numpy()).max()))
        bound = 4 * max(1, math.ceil(math.log2(t))) * EPS * scale
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=bound)
        np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0,
                                   atol=bound)
        assert torch.equal(gfin, got[-1])


def _params(smoothing=0.4):
    s = Settings(smoothing=smoothing, agc_strength=0.8)
    f = log_freq_axis(ROWS, s.freq_min, s.sample_rate / 2.0)
    return (jchain.PostParams.from_settings(s, f),
            tchain.PostParams.from_settings(s, f, "cpu"))


def _power(shape, seed):
    rng = np.random.default_rng(seed)
    p = 10.0 ** rng.uniform(-14.0, 0.0, shape)
    p[rng.uniform(size=shape) < 0.05] = 0.0
    return p.astype(np.float32)


@pytest.mark.parametrize("associative", [False, True])
@pytest.mark.parametrize("lead,agc_global", [((), False), ((3,), True)])
def test_postprocess_batch_both_forms_match_jax(lead, agc_global,
                                                associative):
    jp, tp = _params()
    power = _power((300,) + lead + (ROWS,), seed=7 + len(lead))
    js = jchain.PostState.init(lead + (ROWS,))
    want, wstate = _jax_batch(jnp.asarray(power), js, jp, agc_global,
                              associative)
    got, gstate = tchain.postprocess_batch(
        torch.from_numpy(power), post_state_from_jax(js, "cpu"), tp,
        agc_global, associative=associative)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(gstate.smooth.numpy(),
                               np.asarray(wstate.smooth), atol=1e-6)
    np.testing.assert_allclose(gstate.agc_ref.numpy(),
                               np.asarray(wstate.agc_ref), atol=1e-4)


@pytest.mark.parametrize("lead,agc_global", [((), False), ((2,), True)])
def test_batch_is_column_by_column_bit_exact_hop_by_hop(lead, agc_global):
    """Both EMA inputs, hop by hop: the AGC reference series and the
    smoothing state the column step carries equal the batch scans'."""
    _, tp = _params()
    power = torch.from_numpy(_power((64,) + lead + (ROWS,), seed=9))
    st0 = tchain.PostState.init(lead + (ROWS,), "cpu")
    st, outs, refs, smooths = st0, [], [], []
    for t in range(power.shape[0]):
        out, st = tchain.postprocess_column(power[t], st, tp, agc_global)
        outs.append(out)
        refs.append(st.agc_ref)
        smooths.append(st.smooth)
    v_db, peak = tchain._boost_db_peak(power, tp, agc_global,
                                       tuple(range(1, power.ndim - 1)))
    b_refs, _ = tchain._ema_scan(st0.agc_ref, tchain.AGC_DECAY, peak, False)
    vis = tchain.agc_gate_norm(v_db, b_refs, tp)
    b_smooth, _ = tchain._ema_scan(st0.smooth, tp.smoothing, vis, False)
    for t in range(power.shape[0]):
        assert torch.equal(b_refs[t], refs[t]), t
        assert torch.equal(b_smooth[t], smooths[t]), t
    batch, bst = tchain.postprocess_batch(power, st0, tp, agc_global)
    assert torch.equal(batch, torch.stack(outs))
    assert torch.equal(bst.smooth, st.smooth)
    assert torch.equal(bst.agc_ref, st.agc_ref)


class _NoValueReads(TorchDispatchMode):
    """Fails any read of a tensor's value to the host: a slider's α read
    on the host would rebuild per value and break a graph."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("host read of a tensor")
        return func(*args, **(kwargs or {}))


def test_smoothing_tensor_swapped_without_rebuild_or_host_read():
    """A new smoothing value is a new 0-d tensor in the same params: the
    chain gives what params built from those settings give, and reads no
    tensor value on the host, in either form."""
    _, tp = _params(0.4)
    _, tp_want = _params(0.8)
    power = torch.from_numpy(_power((50, ROWS), seed=4))
    st = tchain.PostState.init((ROWS,), "cpu")
    swapped = tp._replace(smoothing=torch.tensor(np.float32(0.8)))
    for assoc in (False, True):
        want, wst = tchain.postprocess_batch(power, st, tp_want,
                                             associative=assoc)
        with _NoValueReads():
            got, gst = tchain.postprocess_batch(power, st, swapped,
                                                associative=assoc)
        assert torch.equal(got, want) and torch.equal(gst.smooth, wst.smooth)
        other, _ = tchain.postprocess_batch(power, st, tp, associative=assoc)
        assert not torch.equal(other, got)


def test_empty_series_keeps_state_in_both_forms():
    _, tp = _params()
    st = tchain.PostState.init((2, ROWS), "cpu")
    for assoc in (False, True, None):
        out, st2 = tchain.postprocess_batch(torch.zeros(0, 2, ROWS), st, tp,
                                            associative=assoc)
        assert out.shape == (0, 2, ROWS)
        assert st2.smooth is st.smooth and st2.agc_ref is st.agc_ref


def test_wrapper_refuses_a_tensor_off_cpu_and_cuda():
    """No fallback: a tensor that is not on the CPU goes to the kernel or
    raises — here a meta tensor, which the kernel cannot take."""
    b = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="ema_scan"):
        ema.ema_scan(torch.empty(3, device="meta"), 0.5, b)

