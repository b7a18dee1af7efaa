"""The four-step engine (``emspec_torch.dsp.fourstep``) and kernel B4's
plain version against the JAX package and numpy on the CPU (the kernel
against its plain version, on a card: ``tests/test_torch_cuda.py``).

A plain PyTorch mirror of the kernel's two routes (``csrc/fourstep.cu``:
the tile copies, the Stockham passes' job, digit and twiddle maps, the
in-register radix-R DFTs, with the ``.cu``'s own expressions) is held to
``fft4_steps123_plain`` and a float64 numpy FFT at every ``_FACTORS``
size, where an index mistake of the schedule shows without a card.

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
    SMALL_MAX, fft4_steps123, fft4_steps123_plain, radix_tables, route_of,
    supported)

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


# ------------------------------------------- kernel B4's radix schedule, mirrored
LOG2_TABLE, LOG2_STRIP, LOG2_BLOCK_POINTS, SMALL_MAX_LOG2N = 9, 4, 11, 14


def _log2(v):
    return v.bit_length() - 1


def _bitrev(i, bits):
    return sum(((i >> q) & 1) << (bits - 1 - q) for q in range(bits))


def _rot16(v, t, w16):
    """v·W_16^t as ``rot16``: t = 0 and t = 4 (−i) exactly."""
    if t == 0:
        return v
    if t == 4:
        return torch.complex(v.imag, -v.real)
    return v * w16[t]


def _dft(x, l2r, w16):
    """``dft<L2R>``: bit-reversal, then radix-2 DIT stages, on x[..., R]."""
    R = 1 << l2r
    x = x[..., [_bitrev(i, l2r) for i in range(R)]].clone()
    for s in range(l2r):
        h = 1 << s
        for i0 in range(0, R, 2 * h):
            for j in range(h):
                u = x[..., i0 + j].clone()
                t = _rot16(x[..., i0 + j + h], j * (8 >> s), w16)
                x[..., i0 + j] = u + t
                x[..., i0 + j + h] = u - t
    return x


def _pass(buf, w, lines, log2m, log2ns, l2r, threads, P, step2):
    """``pass<P, L2R>`` on every block at once: buf (blocks, tile)."""
    log2_lines, ldiv, hi, lo, es = lines
    R, G = 1 << l2r, P // (1 << l2r)
    log2q = log2m - l2r
    assert threads * G == (1 << log2_lines) << log2q      # every butterfly
    job = (torch.arange(threads)[None] + threads * torch.arange(G)[:, None]
           ).reshape(-1)
    L = job & ((1 << log2_lines) - 1)
    jj = job >> log2_lines
    col = L & ((1 << ldiv) - 1)
    base = (L >> ldiv) * hi + col * lo
    r = torch.arange(R)
    src = base[:, None] + (jj[:, None] + (r << log2q)) * es
    v = buf[:, src]
    k = jj & ((1 << log2ns) - 1)
    if log2ns > 0:
        sh = LOG2_TABLE - log2ns - l2r
        v[..., 1:] = v[..., 1:] * w[(k[:, None] * r[1:]) << sh]
    v = _dft(v, l2r, w[::32])
    d = ((jj >> log2ns) << (log2ns + l2r)) + k
    e = d[:, None] + (r << log2ns)
    if step2 is not None:
        tw, log2n2, c0 = step2
        v = v * tw[(e << log2n2)[None] + c0[:, None, None]
                   + col[None, :, None]]
    dst = base[:, None] + e * es
    # in place: the writes land exactly where the reads came from
    assert src.unique().numel() == src.numel() == dst.unique().numel()
    assert torch.equal(src.unique(), dst.unique())
    buf[:, dst] = v


def _line_fft(buf, w, lines, log2m, threads, P, step2=None):
    """``line_fft<P>``: radix-16 passes, the last taking the remainder."""
    done = 0
    while done < log2m:
        l2r = min(4, log2m - done)
        _pass(buf, w, lines, log2m, done, l2r, threads, P,
              step2 if done + l2r == log2m else None)
        done += l2r


def _tile_maps(rows, log2w, log2src):
    """``load_tile``/``store_tile``: plane offsets and tile addresses."""
    per_row = log2w - 2
    g = torch.arange(rows << per_row)
    row, c = g >> per_row, (g & ((1 << per_row) - 1)) << 2
    q = torch.arange(4)
    return (((row << log2src) + c)[:, None] + q).reshape(-1), \
        ((row * ((1 << log2w) + 1) + c)[:, None] + q).reshape(-1)


def _tables(n1, n2):
    return tuple(torch.view_as_complex(torch.from_numpy(t))
                 for t in radix_tables(n1, n2))


def _small_route(zr, zi):
    """``small_kernel``: F frames a block, steps 1–3 in one tile."""
    b, n1, n2 = zr.shape
    l1, l2 = _log2(n1), _log2(n2)
    log2n = l1 + l2
    log2f = max(LOG2_BLOCK_POINTS - log2n, 0)
    P = 16 if log2n < SMALL_MAX_LOG2N else 32
    threads = (1 << (log2n + log2f)) // P
    F, fs = 1 << log2f, n1 * (n2 + 1)
    blocks = -(-b // F)
    w, tw = _tables(n1, n2)
    z = torch.zeros(blocks * F * n1 * n2, dtype=torch.complex64)
    z[:b * n1 * n2] = torch.complex(zr, zi).reshape(-1)
    src, dst = _tile_maps(F << l1, l2, l2)
    buf = torch.zeros(blocks, F * fs, dtype=torch.complex64)
    buf[:, dst] = z.reshape(blocks, -1)[:, src]
    _line_fft(buf, w, (log2f + l2, l2, fs, 1, n2 + 1), l1, threads, P,
              (tw, l2, torch.zeros(blocks, dtype=torch.long)))
    _line_fft(buf, w, (log2f + l1, 0, n2 + 1, 0, 1), l2, threads, P)
    out = torch.empty(blocks, F * n1 * n2, dtype=torch.complex64)
    out[:, src] = buf[:, dst]
    X = out.reshape(-1)[:b * n1 * n2].reshape(b, n1, n2)
    return X.real.contiguous(), X.imag.contiguous()


def _large_route(zr, zi):
    """``cols_kernel`` (16 columns of a frame, steps 1+2) into the scratch
    B, then ``rows_kernel`` (16 rows of B, step 3)."""
    b, n1, n2 = zr.shape
    l1, l2 = _log2(n1), _log2(n2)
    w, tw = _tables(n1, n2)
    z = torch.complex(zr, zi).reshape(-1)
    blk = torch.arange(b << (l2 - LOG2_STRIP))
    c0 = (blk & ((1 << (l2 - LOG2_STRIP)) - 1)) << LOG2_STRIP
    at = ((blk >> (l2 - LOG2_STRIP)) << (l1 + l2)) + c0
    src, dst = _tile_maps(n1, LOG2_STRIP, l2)
    buf = torch.zeros(blk.numel(), n1 * 17, dtype=torch.complex64)
    buf[:, dst] = z[at[:, None] + src]
    _line_fft(buf, w, (LOG2_STRIP, LOG2_STRIP, 0, 1, 17), l1, n1, 16,
              (tw, l2, c0))
    B = torch.full_like(z, float("nan"))
    B[at[:, None] + src] = buf[:, dst]
    at = torch.arange(b << (l1 - LOG2_STRIP)) << (LOG2_STRIP + l2)
    src, dst = _tile_maps(16, l2, l2)
    buf = torch.zeros(at.numel(), 16 * (n2 + 1), dtype=torch.complex64)
    buf[:, dst] = B[at[:, None] + src]
    _line_fft(buf, w, (LOG2_STRIP, 0, n2 + 1, 0, 1), l2, n2, 16)
    X = torch.full_like(z, float("nan"))
    X[at[:, None] + src] = buf[:, dst]
    X = X.reshape(b, n1, n2)
    return X.real.contiguous(), X.imag.contiguous()


def _check_mirror(mirror, n1, n2, b, seed):
    zr, zi = _pair((b, n1, n2), seed)
    gr, gi = mirror(torch.from_numpy(zr), torch.from_numpy(zi))
    pr, pi = fft4_steps123_plain(torch.from_numpy(zr), torch.from_numpy(zi))
    ref = np.fft.fft((zr.astype(np.float64) + 1j * zi).reshape(b, -1),
                     axis=-1).reshape(b, n2, n1).transpose(0, 2, 1)
    scale = float(np.abs(ref).max())
    for g, w in ((gr, ref.real), (gi, ref.imag), (gr, pr.double().numpy()),
                 (gi, pi.double().numpy())):
        _close(g.numpy(), w, scale)


@pytest.mark.parametrize("n", sorted(fourstep._FACTORS))
@pytest.mark.parametrize("b", [1, 3])
def test_radix_mirror_matches_plain_and_numpy(n, b):
    """The route the kernel takes at n, against the plain B4 and a float64
    FFT reindexed to X[k1, k2] = X[k1 + n1·k2]."""
    n1, n2 = fourstep._FACTORS[n]
    mirror = _small_route if route_of(n1, n2) == "small" else _large_route
    _check_mirror(mirror, n1, n2, b, n + b)


@pytest.mark.parametrize("n", [n for n in sorted(fourstep._FACTORS)
                               if n <= SMALL_MAX])
def test_large_route_mirror_at_small_sizes(n):
    """The two-launch route holds every size too (the card times it
    against the one-launch route at 16384)."""
    _check_mirror(_large_route, *fourstep._FACTORS[n], 2, n + 7)


def test_routes_by_size_only():
    assert [route_of(*fourstep._FACTORS[n]) for n in sorted(fourstep._FACTORS)
            ] == ["small"] * 7 + ["large"] * 4
    assert SMALL_MAX == 1 << SMALL_MAX_LOG2N
    assert not supported(48, 16) and not supported(16, 1024)
