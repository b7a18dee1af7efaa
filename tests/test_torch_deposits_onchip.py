"""Kernel B1's on-chip routes (``emspec_torch/csrc/deposits.cu``: the
block route for N ≤ 16384, the two-CTA cluster route at 32768) mirrored
in plain PyTorch on the CPU, with the ``.cu``'s index expressions
verbatim: the frame → padded (n1, n2 + 1) tile load of each signal (16-
and 4-byte paths), B4's radix steps 1–3 on the tiles (the schedule of
``tests/test_torch_fourstep.py``'s mirror, checked against
``fft4_steps123_plain``), the step-4 shared address, the epilogue's
unpack pairs (k, m − k) read per bin, its warp map (30 bins a warp,
X[k ∓ 1] from the neighbouring lanes), and the cluster's split of the
bins between its ranks with the columns each copies from the other's
tile and the staged addresses it reads them at.  Each map is
asserted a bijection and every bin 0…N/2 written once; the mirror's
deposits meet the B1 card
criteria against ``deposits_ids_plain`` — ≥ 99.99% equal ids over the
batch, other valid deposits moved one cell, bins 0 and N/2 exact, contrib
within 1e-5·peak — and, at 1024, agree with the JAX package's
``fft4_deposits`` run in interpret mode (histograms by ``compare_grids``:
energy ≤ 1e-4 relative, 3×3 max-filters within 1e-3·peak on all but 1e-4
of the cells)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_fourstep import _line_fft
from test_torch_fourstep import _tables as _radix_tables

from emspec.config import Settings as JaxSettings
from emspec.dsp.frame import frame_signal as jax_frame_signal
from emspec.dsp.pallas.fft4 import fft4_deposits
from emspec.dsp.pallas.scatter import histogram_reference
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.config import Settings
from emspec_torch.dsp.fourstep import _FACTORS
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import (
    CLUSTER_N, SMALL_MAX_N, _twiddles, block_smem, deposits_ids,
    deposits_ids_cluster, deposits_ids_large, deposits_ids_plain, route_of)
from emspec_torch.dsp.kernels.fourstep import fft4_steps123_plain
from emspec_torch.dsp.kernels.scatter import SMEM_BINS, histogram_plain
from emspec_torch.dsp.stft import th_window
from emspec_torch.pipeline import Pipeline
from emspec_torch.validate import compare_grids

THREADS = 512                    # kThreads
BLOCK_MAX_LOG2M = 13             # kBlockMaxLog2M
BATCH = 2                        # kBatch
BINS_PER_WARP = 30               # kBinsPerWarp
STAGE_STRIDE = 67                # kStageStride
SIZES = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def _log2(v):
    return v.bit_length() - 1


def _signal(samples, sr, seed):
    """A chirp 100 Hz → 9 kHz, three tones and 1% noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    sec = samples / sr
    x = (0.5 * np.sin(2 * np.pi * (100.0 * t + 0.5 * 8900.0 / sec * t * t))
         + sum(0.3 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0, 1320.0))
         + 0.01 * rng.standard_normal(samples))
    return x.astype(np.float32)


def _case(n, b, seed):
    """(b, n) frames at hop n/4, 96 kHz, 128 rows, and the plain kwargs."""
    sr = 96000
    pipe = Pipeline(Settings(mode="enhanced", multires=False, fft_size=n,
                             sample_rate=sr, raster_height=128,
                             smoothing=0.3), "cpu")
    x = _signal((b - 1) * pipe.hop + n, sr, seed)
    p = pipe.params()
    kw = dict(n=n, hop=pipe.hop, sr=float(sr), rows=pipe.rows,
              reach=pipe.reach)
    return (frame_signal(torch.from_numpy(x), n, pipe.hop),
            (p.logmap_a, p.logmap_b, p.power_floor), kw)


# ------------------------------------------------------------ the index maps
def _at(k, l1, l2, stride, c0):
    """``Spectrum::at``: Z[k] at row k mod n1, column (k div n1 − c0) mod
    n2 of a tile of row stride ``stride``."""
    return (k & ((1 << l1) - 1)) * stride + (((k >> l1) - c0) & ((1 << l2) - 1))


def spec_addr(k, l1, l2):
    """Z[k], k < m, in a whole tile after steps 1–3 (stride n2 + 1)."""
    return _at(k, l1, l2, (1 << l2) + 1, 0)


def _load_map(m, l2, vec):
    """``load_frame``: tile addresses and the frame index of each complex
    value's real part (its imaginary part is the next sample)."""
    mask = (1 << l2) - 1
    if vec:                       # float4 s[4g..4g+3] → z[2g], z[2g+1]
        g = torch.arange(m >> 1)
        i = 2 * g
        at = (i >> l2) * (mask + 2) + (i & mask)
        return (torch.stack([at, at + 1], 1).reshape(-1),
                torch.stack([4 * g, 4 * g + 2], 1).reshape(-1))
    i = torch.arange(m)
    return (i >> l2) * (mask + 2) + (i & mask), 2 * i


def _slots(n1, n2):
    """The non-padding addresses of one (n1, n2 + 1) tile."""
    a = torch.arange(n1 * (n2 + 1))
    return a[a % (n2 + 1) != n2]


def _load(frames, th, n1, n2, vec):
    """Each frame's raw and t·h tiles, (b, 2, n1·(n2 + 1)) complex64;
    the padding, which nothing loads, is NaN."""
    addr, src = _load_map(n1 * n2, _log2(n2), vec)
    tiles = torch.full((frames.shape[0], 2, n1 * (n2 + 1)), float("nan"),
                       dtype=torch.complex64)
    re, im = frames[:, src], frames[:, src + 1]
    tiles[:, 0, addr] = torch.complex(re, im)
    tiles[:, 1, addr] = torch.complex(re * th[src], im * th[src + 1])
    return tiles


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("vec", [True, False], ids=["16B", "4B"])
def test_load_map_is_a_bijection_onto_the_tile(n, vec):
    """Every sample pair lands once, on a non-padding slot, at the step-1
    place of z[i] = row i div n2, column i mod n2."""
    n1, n2 = _FACTORS[n // 2]
    addr, src = _load_map(n // 2, _log2(n2), vec)
    assert torch.equal(torch.sort(addr).values, _slots(n1, n2))
    assert torch.equal(torch.sort(src).values, torch.arange(0, n, 2))
    i = src // 2
    assert torch.equal(addr, (i // n2) * (n2 + 1) + i % n2)


@pytest.mark.parametrize("n", SIZES)
def test_step4_address_and_unpack_pairs(n):
    """spec_addr over k < m hits every slot the FFT writes once, X[k1, k2]
    of the radix steps (tile address k1·(n2 + 1) + k2) is Z[k1 + n1·k2],
    and ``spectrum_at``'s pair (j', m − j') stays on those slots for every
    bin 0…m, each pair serving bins j' and m − j' only."""
    n1, n2 = _FACTORS[n // 2]
    l1, l2 = _log2(n1), _log2(n2)
    m = n // 2
    k = torch.arange(m)
    a = spec_addr(k, l1, l2)
    assert torch.equal(torch.sort(a).values, _slots(n1, n2))
    assert torch.equal(a, (k % n1) * (n2 + 1) + k // n1)
    # bank spread of a warp's strided read: stride n2 + 1 ≡ 1 (mod 16)
    # complex values, so 16 consecutive bins hit 16 distinct bank pairs
    for k0 in range(0, min(m, 512), 16):
        assert (a[k0:k0 + 16] % 16).unique().numel() == 16
    jl, jm = _pair(torch.arange(m + 1), m)
    assert int(jl.max()) <= m // 2 and int(jm.max()) < m
    assert torch.equal(torch.where(jl == 0, 0, m - jl), jm)
    served = {}
    for j, p in enumerate(jl.tolist()):
        served.setdefault(p, set()).add(j)
    assert all(bins <= {p, m - p} for p, bins in served.items())


def _warp_map(k0, k1, warps):
    """``deposits_of``'s loop: the bin of every lane in every round,
    (rounds, 32), and which lanes own theirs (lanes 1…30, k0 <= k < k1)."""
    stride = warps * BINS_PER_WARP
    ks = []
    for w in range(warps):
        b0 = k0 + w * BINS_PER_WARP - 1
        while b0 + 1 < k1:                                  # warp-uniform
            ks.extend(b0 + j * stride + torch.arange(32) for j in range(BATCH))
            b0 += BATCH * stride
    K = torch.stack(ks)
    lane = torch.arange(32)
    return K, (lane >= 1) & (lane <= 30) & (K >= k0) & (K < k1)


@pytest.mark.parametrize("k0,k1,warps", [(0, 257, 1), (0, 4097, 16),
                                         (0, 8193, 16), (0, 8193, 4),
                                         (8193, 16385, 16)])
def test_warp_map_owns_every_bin_once(k0, k1, warps):
    """Each bin of [k0, k1) is owned once; lanes l ∓ 1 of the owner hold
    bins k ∓ 1, from which the shuffles take X[k ∓ 1]."""
    K, own = _warp_map(k0, k1, warps)
    assert torch.equal(torch.sort(K[own]).values, torch.arange(k0, k1))
    assert bool((K[:, 1:] - K[:, :-1] == 1).all())


# ----------------------------------------------------------- the arithmetic
def _fft(tiles, n1, n2, *, count):
    """``tile_fft``: steps 1–3 of ``count`` tiles in one buffer, the
    thread count and P of the route (block: 2m/P threads, P = 16 below
    m = 8192; cluster: 512 threads, P = 32)."""
    l1, l2 = _log2(n1), _log2(n2)
    log2m = l1 + l2
    if count == 2:
        P = 16 if log2m < BLOCK_MAX_LOG2M else 32
        threads = (2 << log2m) // P
    else:
        P, threads = 32, THREADS
        assert (1 << log2m) // P == threads
    assert threads <= THREADS
    w, tw = _radix_tables(n1, n2)
    fs = n1 * (n2 + 1)
    buf = tiles.reshape(-1, count * fs).clone()
    lc = _log2(count)
    _line_fft(buf, w, (lc + l2, l2, fs, 1, n2 + 1), l1, threads, P,
              (tw, l2, torch.zeros(buf.shape[0], dtype=torch.long)))
    _line_fft(buf, w, (lc + l1, 0, n2 + 1, 0, 1), l2, threads, P)
    return buf.reshape(tiles.shape)


def _pair(j, m):
    """``spectrum_at``'s pair: j' = min(j, m − j) and its mirror."""
    jl = torch.where(j > m // 2, m - j, j)
    return jl, torch.where(jl == 0, 0, m - jl)


def _spectrum_at(Z, j, n, l1, l2):
    """``spectrum_at``: X[j], 0 <= j <= m, from the packed spectrum
    Z = (tile, row stride, c0) with ``emspec::unpack_pair``'s
    expressions; every value read must be one the tile holds."""
    m = n // 2
    z, stride, c0 = Z
    jl, jm = _pair(j, m)
    zk = z[..., _at(jl, l1, l2, stride, c0)]
    zmk = z[..., _at(jm, l1, l2, stride, c0)]
    assert bool(torch.isfinite(zk).all() and torch.isfinite(zmk).all())
    w = torch.view_as_complex(_twiddles(n, "cpu"))[jl]
    ze = torch.complex(0.5 * (zk.real + zmk.real), 0.5 * (zk.imag - zmk.imag))
    zo = torch.complex(0.5 * (zk.imag + zmk.imag), -0.5 * (zk.real - zmk.real))
    t = torch.complex(w.real * zo.real - w.imag * zo.imag,
                      w.real * zo.imag + w.imag * zo.real)
    return torch.where(j > m // 2, torch.complex(ze.real - t.real,
                                                 t.imag - ze.imag), ze + t)


def _deposit_at(k, A, Am1, Ap1, B, scal, *, n, hop, sr, rows, reach):
    """``emspec::deposit_at`` in float32, its expressions verbatim."""
    a, bsc, floor_p = (float(s) for s in scal)
    c_dh = float(np.float32(0.5 * np.pi / n))
    bin_scale = float(np.float32(n / (2.0 * np.pi)))
    hz_per_bin = float(np.float32(sr / n))
    inv_n2 = float(np.float32(1.0 / float(n * n)))
    xhr = 0.5 * A.real - 0.25 * (Am1.real + Ap1.real)
    xhi = 0.5 * A.imag - 0.25 * (Am1.imag + Ap1.imag)
    xdr = c_dh * (Am1.imag - Ap1.imag)
    xdi = -c_dh * (Am1.real - Ap1.real)
    power = xhr * xhr + xhi * xhi
    inv = 1.0 / torch.where(power > 1e-30, power, torch.full_like(power, 1e-30))
    dt = (B.real * xhr + B.imag * xhi) * inv
    dw = -(xdi * xhr - xdr * xhi) * inv
    f_hat = (k.to(torch.float32) + dw * bin_scale) * hz_per_bin
    dq = torch.round(dt / float(hop))
    rq = torch.round((torch.log2(torch.where(
        f_hat > 1e-6, f_hat, torch.full_like(f_hat, 1e-6))) - a) * bsc)
    valid = ((power > floor_p) & (rq >= 0) & (rq < rows) & (f_hat > 0)
             & (dt.abs() <= 0.5 * n))
    ids = torch.where(valid, (dq.to(torch.int32) + reach) * rows
                      + rq.to(torch.int32), -1)
    return ids, torch.where(valid, power * inv_n2, torch.zeros_like(power))


def _cluster_parts(m, n2):
    """Each rank of a cluster: (rank, c0, width of the columns it copies
    from the other's tile, its bin ranges).  Rank 0: bins 0 … m/4 − 1 and
    3m/4 + 1 … m, columns [3q, 4q) ∪ [0, q) of the t·h spectrum; rank 1:
    bins m/4 … 3m/4, columns [q − 1, 3q] of the raw one (q = n2/4)."""
    q = n2 // 4
    return [(0, 3 * q, 2 * q, [(0, m // 4), (3 * m // 4 + 1, m + 1)]),
            (1, q - 1, 2 * q + 2, [(m // 4, 3 * m // 4 + 1)])]


def _copy_columns(other, c0, width, l1, l2):
    """``copy_columns``: columns c0 … c0 + width − 1 (mod n2) of each row
    of the other rank's tile → a staged tile of row stride
    ``STAGE_STRIDE`` (NaN where nothing is copied)."""
    n1, n2 = 1 << l1, 1 << l2
    e = torch.arange(width * n1)
    row = e // width
    src = row * (n2 + 1) + ((c0 + e - row * width) & (n2 - 1))
    dst = row * STAGE_STRIDE + e - row * width
    assert width <= STAGE_STRIDE and dst.unique().numel() == dst.numel()
    stage = torch.full(other.shape[:-1] + (n1 * STAGE_STRIDE,), float("nan"),
                       dtype=other.dtype)
    stage[..., dst] = other[..., src]
    return stage


def _epilogue(Zx, Zy, k0, k1, warps, scal, *, n, l1, l2, **kw):
    """``deposits_of`` for bins k0 <= k < k1: every lane unpacks X at its
    bin clamped to k0 − 1 … k1 and Y clamped to k0 … k1 − 1, X[k ∓ 1]
    come from lanes l ∓ 1 (``shfl``), the Hermitian conjugates at k = 0
    and m → (bins, ids, contrib)."""
    K, own, ids, contrib = _epilogue_lanes(Zx, Zy, k0, k1, warps, scal, n=n,
                                           l1=l1, l2=l2, **kw)
    return K[own], ids[:, own], contrib[:, own]


def _epilogue_lanes(Zx, Zy, k0, k1, warps, scal, *, n, l1, l2, **kw):
    """``_epilogue`` on every lane of every warp step: (K, own, ids,
    contrib), the last two (frames, rounds, 32), lanes without a bin of
    their own included (B6's warp_add takes all 32)."""
    m = n // 2
    K, own = _warp_map(k0, k1, warps)
    X = _spectrum_at(Zx, K.clamp(max(k0 - 1, 0), min(k1, m)), n, l1, l2)
    Y = _spectrum_at(Zy, K.clamp(k0, k1 - 1), n, l1, l2)
    xm = torch.cat([X[..., :1], X[..., :-1]], -1)     # shfl up: lane l − 1
    xp = torch.cat([X[..., 1:], X[..., -1:]], -1)     # shfl down: lane l + 1
    Am1 = torch.where(K == 0, torch.conj(xp), xm)
    Ap1 = torch.where(K == m, torch.conj(xm), xp)
    ids, contrib = _deposit_at(K, X, Am1, Ap1, Y, scal, n=n, **kw)
    return K, own, ids, contrib


def _route_parts(frames, *, n, vec=True):
    """The epilogue calls of B1's route at n (block or cluster) on the
    transformed tiles: [(rank, Zx, Zy, k0, k1, warps)], and (l1, l2)."""
    m = n // 2
    n1, n2 = _FACTORS[m]
    l1, l2 = _log2(n1), _log2(n2)
    tiles = _load(frames, th_window(n, "cpu"), n1, n2, vec)
    whole = n2 + 1
    if route_of(n) == "cluster":        # one tile a rank, 512 threads each
        tiles = _fft(tiles, n1, n2, count=1)
        parts = []
        for rank, c0, width, ranges in _cluster_parts(m, n2):
            own = (tiles[:, rank], whole, 0)
            staged = (_copy_columns(tiles[:, 1 - rank], c0, width, l1, l2),
                      STAGE_STRIDE, c0)
            zx, zy = (own, staged) if rank == 0 else (staged, own)
            parts += [(rank, zx, zy, k0, k1, THREADS // 32)
                      for k0, k1 in ranges]
    else:                               # both tiles in one block
        tiles = _fft(tiles, n1, n2, count=2)
        P = 16 if _log2(m) < BLOCK_MAX_LOG2M else 32
        parts = [(0, (tiles[:, 0], whole, 0), (tiles[:, 1], whole, 0), 0,
                  m + 1, 2 * m // P // 32)]
    return parts, (l1, l2)


def _mirror(frames, scal, *, n, vec=True, **kw):
    """B1 on its route at n (block or cluster), in plain PyTorch."""
    m = n // 2
    parts, (l1, l2) = _route_parts(frames, n=n, vec=vec)
    ids = torch.full((frames.shape[0], m + 1), -2, dtype=torch.int32)
    contrib = torch.full((frames.shape[0], m + 1), float("nan"))
    written = []
    for _, zx, zy, k0, k1, warps in parts:
        ks, i, c = _epilogue(zx, zy, k0, k1, warps, scal, n=n, l1=l1, l2=l2,
                             **kw)
        ids[:, ks], contrib[:, ks] = i, c
        written.append(ks)
    assert torch.equal(torch.sort(torch.cat(written)).values,
                       torch.arange(m + 1))             # each bin once
    return ids, contrib


def _assert_b1(im, cm, ip, cp, *, n, rows, reach):
    S = (2 * reach + 1) * rows
    g = compare_grids(histogram_plain(ip, cp, S), histogram_plain(im, cm, S))
    assert g.ok, g
    vm, vp = cm > 0, cp > 0
    both = vm & vp
    agree = (both & (im == ip)) | (~vm & ~vp)
    assert float(agree.float().mean()) >= 0.9999
    moved = (im - ip).abs()[both & (im != ip)]
    assert bool(torch.isin(moved, torch.tensor(
        [1, rows - 1, rows, rows + 1])).all())
    assert bool(agree[:, [0, n // 2]].all())                    # edges exact
    assert bool((im[~vm] == -1).all())
    assert float((cm - cp)[both].abs().max()) <= 1e-5 * float(cp.max())


@pytest.mark.parametrize("n", [512, 8192, 16384, 32768])
def test_tile_fft_matches_plain_steps123(n):
    """The radix steps on the loaded tiles against B4's plain steps 1–3
    on the same (n1, n2) planes: 2e-5·max|X| (B4's bound)."""
    fr, _, _ = _case(n, 2, seed=n % 61)
    n1, n2 = _FACTORS[n // 2]
    tiles = _load(fr, th_window(n, "cpu"), n1, n2, True)
    got = _fft(tiles, n1, n2, count=1 if route_of(n) == "cluster" else 2)
    slots = _slots(n1, n2)
    z = tiles[..., slots].reshape(-1, n1, n2)
    pr, pi = fft4_steps123_plain(z.real.contiguous(), z.imag.contiguous())
    want = torch.complex(pr, pi).reshape(tiles.shape[:-1] + (-1,))
    for sig in (0, 1):                 # the two signals differ ~10³ in scale
        w = want[:, sig]
        err = float((got[:, sig, slots] - w).abs().max())
        assert err <= 2e-5 * float(w.abs().max()), (sig, err)


@pytest.mark.parametrize("n", [512, 8192, 16384, 32768])
@pytest.mark.parametrize("b", [1, 3])
def test_mirror_meets_b1_criteria_against_plain(n, b):
    """The route's mirror against plain B1 (torch.fft); b = 1 gives
    frame 0 of the batch bit for bit (a frame's arithmetic does not
    depend on the batch)."""
    fr, scal, kw = _case(n, b, seed=n % 89)
    im, cm = _mirror(fr, scal, **kw)
    ip, cp = deposits_ids_plain(fr, *scal, **kw)
    _assert_b1(im, cm, ip, cp, n=n, rows=kw["rows"], reach=kw["reach"])
    i1, c1 = _mirror(fr[:1], scal, **kw)
    assert torch.equal(i1, im[:1]) and torch.equal(c1, cm[:1])


@pytest.mark.parametrize("n", [8192, 32768])
def test_both_load_widths_give_the_same_bits(n):
    """The 16-byte and the 4-byte load paths fill the same tiles, so the
    deposits agree bit for bit (the card picks by address and stride)."""
    fr, scal, kw = _case(n, 2, seed=3)
    got = _mirror(fr, scal, vec=False, **kw)
    want = _mirror(fr, scal, vec=True, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cluster_staging_holds_every_read():
    """At 32768 the ranks' bins cover 0…m once and balance (8192 and
    8193); every value a rank reads of the other's spectrum (X on its
    bins ± 1 for rank 1, Y on its bins for rank 0) lies in the columns it
    copied, at distinct staged addresses of one odd row stride; the staged
    tile fits beside the rank's own tile and the W_512 table."""
    n1, n2 = _FACTORS[CLUSTER_N // 2]
    l1, l2 = _log2(n1), _log2(n2)
    m = CLUSTER_N // 2
    owned = []
    for rank, c0, width, ranges in _cluster_parts(m, n2):
        cols = set(((c0 + torch.arange(width)) % n2).tolist())
        bins = []
        for k0, k1 in ranges:
            K, own = _warp_map(k0, k1, THREADS // 32)
            bins.append(K[own])
            read = (K.clamp(max(k0 - 1, 0), min(k1, m)) if rank == 1
                    else K.clamp(k0, k1 - 1))
            for j in _pair(read, m):
                assert set((j // n1).unique().tolist()) <= cols
                a = _at(j.unique(), l1, l2, STAGE_STRIDE, c0)
                assert int(a.max()) < n1 * STAGE_STRIDE
        owned.append(torch.cat(bins))
    assert [o.numel() for o in owned] == [m // 2, m // 2 + 1]
    assert torch.equal(torch.sort(torch.cat(owned)).values,
                       torch.arange(m + 1))
    assert STAGE_STRIDE % 2 == 1 and (n2 + 1) % 2 == 1
    assert 8 * (512 + n1 * (n2 + 1) + n1 * STAGE_STRIDE) == 204800 \
        <= 4 * SMEM_BINS


def test_mirror_matches_pallas_interpret():
    """The block route's mirror against the TPU kernel itself (interpret
    mode), n = 1024, as histograms."""
    n, hop, rows, t = 1024, 256, 128, 8
    jp = JaxPipeline(JaxSettings(mode="enhanced", multires=False, fft_size=n,
                                 hop=hop, raster_height=rows))
    p, R = jp.params(), jp.reach
    x = _signal((t - 1) * hop + n, 48000, seed=3)
    fr = np.asarray(jax_frame_signal(jnp.asarray(x), n, hop))
    with pltpu.force_tpu_interpret_mode():
        ids_j, c_j = fft4_deposits(jnp.asarray(fr), p.logmap_a, p.logmap_b,
                                   p.power_floor, n=n, hop=hop, sr=48000.0,
                                   rows=rows, reach=R)
    P = 2 * R + 1
    want = np.array(histogram_reference(ids_j, c_j, P * rows))
    scal = tuple(torch.tensor(np.float32(v)) for v in
                 (p.logmap_a, p.logmap_b, p.power_floor))
    im, cm = _mirror(torch.from_numpy(np.array(fr)), scal, n=n, hop=hop,
                     sr=48000.0, rows=rows, reach=R)
    got = histogram_plain(im, cm, P * rows)
    cmp = compare_grids(torch.from_numpy(want).reshape(t, P, rows),
                        got.reshape(t, P, rows))
    assert cmp.ok, cmp


# ---------------------------------------------------------------- routing
def test_routes_by_size_only():
    assert [route_of(n) for n in SIZES + (65536, 262144)] == (
        ["block"] * 6 + ["cluster", "cluster_large", "cluster_large"])
    assert SMALL_MAX_N == 1 << (BLOCK_MAX_LOG2M + 1) and CLUSTER_N == 32768
    # the block route's shared memory: 70,656 B at 8192 (three blocks an
    # SM by memory), 136,192 B at 16384, within a block's 227 KB with B6's
    # 2,560 cells
    assert block_smem(8192) == 70656 and block_smem(16384) == 136192
    assert block_smem(16384, 2560) <= 4 * SMEM_BINS


def test_cluster_wrapper_routes_cpu_to_plain_and_checks_size():
    fr, scal, kw = _case(32768, 2, seed=1)
    before = (deposits_ids.launches, deposits_ids_cluster.launches,
              deposits_ids_large.launches)
    want = deposits_ids_plain(fr, *scal, **kw)
    for got in (deposits_ids_cluster(fr, *scal, **kw),
                deposits_ids(fr, *scal, **kw, route="large")):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (deposits_ids.launches, deposits_ids_cluster.launches,
            deposits_ids_large.launches) == before
    meta = torch.empty(2, 8192, device="meta")
    s = torch.empty((), device="meta")
    kw8 = dict(n=8192, hop=2048, sr=48000.0, rows=64, reach=2)
    with pytest.raises(ValueError, match="deposits_ids_cluster"):
        deposits_ids_cluster(meta, s, s, s, **kw8)
    for route in ("cluster", "large", "radix2"):
        with pytest.raises(ValueError, match="route"):
            deposits_ids(meta, s, s, s, **kw8, route=route)
