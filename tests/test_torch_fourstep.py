"""The four-step engine (``emspec_torch.dsp.fourstep``) and kernel B4's
plain version against the JAX package and numpy on the CPU (the kernel
against its plain version, on a card: ``tests/test_torch_cuda.py``).

Tolerance: 2e-5·max|X|, the JAX package's own bound for its four-step
paths (``tests/test_pallas.py:165``); the float32 products round
differently in XLA, torch and the kernel, all far inside it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from emspec.dsp import fourstep as jax_fourstep
from emspec.dsp.pallas.fft4 import fft4_steps123 as jax_fft4_steps123
from emspec_torch.dsp import fourstep
from emspec_torch.dsp.kernels.fourstep import (
    fft4_steps123, fft4_steps123_plain, supported)

TOL = 2e-5
SIZES = [n for n in sorted(fourstep._FACTORS) if n <= 32768]


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _close(got, want, scale):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale
    assert err < TOL, err


def test_factors_and_tables_bit_equal():
    assert fourstep._FACTORS == jax_fourstep._FACTORS
    for n in fourstep._FACTORS:
        assert supported(*fourstep._FACTORS[n])
        for got, want in zip(fourstep._tables(n), jax_fourstep._tables(n)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lead", [(), (1,), (3,)], ids=["1d", "b1", "b3"])
def test_fft_fourstep_matches_jax_and_numpy(n, lead):
    a, b = _pair(lead + (n,), n + len(lead))
    got_r, got_i = fourstep.fft_fourstep(torch.from_numpy(a),
                                         torch.from_numpy(b))
    assert got_r.shape == a.shape and got_r.dtype == torch.float32
    want_r, want_i = jax_fourstep.fft_fourstep(jnp.asarray(a), jnp.asarray(b),
                                               use_pallas=False)
    ref = np.fft.fft(a.astype(np.float64) + 1j * b, axis=-1)
    scale = float(np.abs(ref).max())
    for g, w in ((got_r, want_r), (got_i, want_i), (got_r, ref.real),
                 (got_i, ref.imag)):
        _close(g.numpy(), np.asarray(w, np.float64), scale)


@pytest.mark.parametrize("b", [1, 3])
def test_steps123_plain_matches_pallas_interpret(b):
    """The plain B4 against the TPU kernel itself (interpret mode), 8192."""
    n1, n2 = fourstep._FACTORS[8192]
    zr, zi = _pair((b, n1, n2), 11 + b)
    with pltpu.force_tpu_interpret_mode():
        want_r, want_i = jax_fft4_steps123(jnp.asarray(zr), jnp.asarray(zi))
    got_r, got_i = fft4_steps123_plain(torch.from_numpy(zr),
                                       torch.from_numpy(zi))
    scale = float(np.abs(np.asarray(want_r) + 1j * np.asarray(want_i)).max())
    _close(got_r.numpy(), np.asarray(want_r, np.float64), scale)
    _close(got_i.numpy(), np.asarray(want_i, np.float64), scale)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["1d", "b3"])
def test_fft_fourstep_matches_jax_pallas_path(lead):
    """The port's engine against the JAX engine on its Pallas B4 branch
    (interpret mode), 8192."""
    a, b = _pair(lead + (8192,), 21)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fourstep.fft_fourstep(jnp.asarray(a), jnp.asarray(b),
                                         use_pallas=True)
    got = fourstep.fft_fourstep(torch.from_numpy(a), torch.from_numpy(b))
    scale = float(np.abs(np.asarray(want[0]) + 1j * np.asarray(want[1])).max())
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w, np.float64), scale)


@pytest.mark.parametrize("n", [256, 512, 1024, 8192, 32768])
def test_rfft_fourstep_matches_jax_and_numpy(n):
    """n = 256 takes the h ∉ _FACTORS fallback (full complex transform)."""
    x = _pair((2, n), n)[0]
    got = fourstep.rfft_fourstep(torch.from_numpy(x)).numpy()
    assert got.shape == (2, n // 2 + 1) and got.dtype == np.complex64
    want = np.asarray(jax_fourstep.rfft_fourstep(jnp.asarray(x)))
    ref = np.fft.rfft(x.astype(np.float64), axis=-1)
    scale = float(np.abs(ref).max())
    _close(got, want.astype(np.complex128), scale)
    _close(got, ref, scale)


@pytest.mark.parametrize("n", [512, 8192])
def test_packed_pair_fft_matches_jax(n):
    a, b = _pair((4, n), n + 1)
    b = b * np.float32(n / 8)                # a t·h-like scale gap
    ga, gb = fourstep.packed_pair_fft(torch.from_numpy(a), torch.from_numpy(b))
    wa, wb = jax_fourstep.packed_pair_fft(jnp.asarray(a), jnp.asarray(b))
    scale = float(np.abs(np.fft.fft(a + 1j * b.astype(np.float64))).max())
    _close(ga.numpy(), np.asarray(wa, np.complex128), scale)
    _close(gb.numpy(), np.asarray(wb, np.complex128), scale)


def test_wrapper_routes_cpu_to_plain_and_raises_elsewhere():
    before = fft4_steps123.launches
    zr, zi = (torch.from_numpy(v) for v in _pair((2, 16, 32), 3))
    got = fft4_steps123(zr, zi)
    want = fft4_steps123_plain(zr, zi)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fft4_steps123.launches == before
    meta = torch.empty(2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="fft4_steps123"):
        fft4_steps123(meta, meta)


def test_supported_factorizations():
    assert supported(16, 16) and supported(512, 512) and supported(64, 128)
    assert not supported(8, 16) and not supported(1024, 16)
    assert not supported(16, 24)
