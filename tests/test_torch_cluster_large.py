"""Kernel B1's route cluster_large (``emspec_torch/csrc/deposits_large.cu``
``xcluster_kernel``: N = 65536, 131072, 262144, a frame a cluster of
8, 16 and 16 CTAs) mirrored in plain PyTorch on the CPU, with the ``.cu``'s
index expressions verbatim: ``cluster_large_plan`` (the ``.cu``'s
``xplan``) and its shared memory at every size, the frame → tile load of
each rank (16- and 4-byte paths), the column FFTs with TW (B4's radix
passes, ``tests/test_torch_fourstep.py``'s mirror), the exchange between
the ranks (which rank holds which (k1, k2) slice after it, each read
from a peer before the peer overwrites it, each store where no later
read looks), the row FFTs, and the epilogue's pairs (the bins j and
m − j of one unpack, a lane each, Z read from the rank holding each
row).  Tolerances: the spectra within 2e-5·max|X|
of float64 ``torch.fft.rfft`` of the raw and the t·h frames (B4's
bound); the deposits meet the B1 criteria against ``deposits_ids_plain``
(≥ 99.99% equal ids, other valid deposits moved one cell, bins 0 and N/2
exact, contrib within 1e-5·peak, grids by ``compare_grids``), b = 1
gives frame 0 bit for bit, and at 65536 the histograms agree with the
JAX package's ``fft4_deposits`` run in interpret mode (as
``tests/test_pallas.py`` runs it), by ``compare_grids``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_deposits_onchip import _assert_b1, _case, _deposit_at
from test_torch_fourstep import _line_fft
from test_torch_fourstep import _tables as _radix_tables

from emspec.config import Settings as JaxSettings
from emspec.dsp.frame import frame_signal as jax_frame_signal
from emspec.dsp.pallas.fft4 import fft4_deposits
from emspec.dsp.pallas.scatter import histogram_reference
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.dsp.fourstep import _FACTORS
from emspec_torch.dsp.kernels.deposits import (
    CLUSTER_LARGE_N, HIST_ROUTES, ROUTES, SMEM_BYTES, _twiddles,
    cluster_large_plan, deposits_hist, deposits_hist_plain, deposits_ids,
    deposits_ids_cluster_large, deposits_ids_large, deposits_ids_plain,
    route_of)
from emspec_torch.dsp.kernels.scatter import histogram_plain
from emspec_torch.dsp.stft import th_window
from emspec_torch.validate import compare_grids

P = 16                           # kXP
HELD = 8                         # kXHeld


def _log2(v):
    return v.bit_length() - 1


def _geometry(n):
    p = cluster_large_plan(n)
    return dict(p, lc=_log2(p["ctas"]), l1=_log2(p["n1"]), l2=_log2(p["n2"]),
                lw=_log2(p["cols"]), la=_log2(p["rows"]), ls=1, m=n // 2)


# ------------------------------------------------------------------ load
def _load_map(g, rank, vec):
    """``xload``: each value's tile address (raw tile; the t·h tile is
    ``tile`` further) and the frame index of its real part."""
    lw, l2 = g["lw"], g["l2"]
    col0 = rank << lw
    total = 1 << (lw + g["l1"])
    if vec:                       # float4 s[2i..2i+3] → z[i], z[i + 1]
        gg = torch.arange(total >> 1)
        c = (gg & ((1 << (lw - 1)) - 1)) << 1
        i = ((gg >> (lw - 1)) << l2) + col0 + c
        at = (gg >> (lw - 1)) * g["stride_before"] + c
        return (torch.stack([at, at + 1], 1).reshape(-1),
                torch.stack([2 * i, 2 * i + 2], 1).reshape(-1))
    e = torch.arange(total)
    i = ((e >> lw) << l2) + col0 + (e & ((1 << lw) - 1))
    return (e >> lw) * g["stride_before"] + (e & ((1 << lw) - 1)), 2 * i


def _load(frames, g, vec=True):
    """Every rank's two tiles, (b, C, 2·tile) complex64, NaN padding."""
    th = th_window(g["m"] * 2, "cpu")
    fs = g["tile"]
    tiles = torch.full((frames.shape[0], g["ctas"], 2 * fs), float("nan"),
                       dtype=torch.complex64)
    for rank in range(g["ctas"]):
        at, src = _load_map(g, rank, vec)
        re, im = frames[:, src], frames[:, src + 1]
        tiles[:, rank, at] = torch.complex(re, im)
        tiles[:, rank, fs + at] = torch.complex(re * th[src], im * th[src + 1])
    return tiles


# -------------------------------------------------------------- exchange
def _exchange_moves(g):
    """The exchange's copies: for each group, (reader rank, peer, address
    read in the peer's tile, address stored in the reader's tile), each
    (C, points/2), element e = thread + i·threads as the kernel takes
    them."""
    C, la, lw, lc, ls = g["ctas"], g["la"], g["lw"], g["lc"], g["ls"]
    fs, wp, q = g["tile"], g["stride_before"], g["stride_after"]
    T = g["threads"]
    e = (torch.arange(T)[None] + T * torch.arange(HELD)[:, None]).reshape(-1)
    assert torch.equal(torch.sort(e).values,
                       torch.arange((C << (la + lw + ls)) // 2))
    ri, sig = e >> (la + lw + ls), (e >> (la + lw)) & ((1 << ls) - 1)
    aa, jj = (e >> lw) & ((1 << la) - 1), e & ((1 << lw) - 1)
    rank = torch.arange(C)[:, None]
    moves = []
    for grp in range(2):
        p = rank ^ ((grp << (lc - 1)) + ri)[None]
        src = sig * fs + ((rank << la) + aa) * wp + jj
        dst = sig * fs + ((p << lw) + jj) * q + aa
        moves.append((rank.expand_as(p), p, src, dst))
    return moves


def _exchange(tiles, g):
    """The exchange on (b, C, 2·tile): each group's reads, then its stores."""
    out = tiles.clone()
    for rank, p, src, dst in _exchange_moves(g):
        v = out[:, p, src]
        out[:, rank, dst] = v
    return out


# ------------------------------------------------------------------ FFTs
def _fft(tiles, g):
    """Steps 1+2 (n1-point column FFTs, TW at column r·W + c), the
    exchange, step 3 (n2-point row FFTs) → (b, C, 2·tile)."""
    b, C, width = tiles.shape
    fs, ls = g["tile"], g["ls"]
    w, tw = _radix_tables(g["n1"], g["n2"])
    buf = tiles.reshape(b * C, width).clone()
    c0 = (torch.arange(b * C) % C) << g["lw"]
    _line_fft(buf, w, (ls + g["lw"], g["lw"], fs, 1, g["stride_before"]),
              g["l1"], g["threads"], P, (tw, g["l2"], c0))
    buf = _exchange(buf.reshape(b, C, width), g).reshape(b * C, width)
    _line_fft(buf, w, (ls + g["la"], g["la"], fs, 1, g["stride_after"]),
              g["l2"], g["threads"], P)
    return buf.reshape(b, C, width)


def _z_at(tiles, g, sig, j):
    """``z_at``: Z[j] of signal sig from the rank holding row j mod n1."""
    row = j & (g["n1"] - 1)
    owner = row >> g["la"]
    at = sig * g["tile"] + (j >> g["l1"]) * g["stride_after"] \
        + (row & ((1 << g["la"]) - 1))
    z = tiles[:, owner, at]
    assert bool(torch.isfinite(z).all())
    return z


def _x_at(tiles, g, sig, j):
    """``x_at``: X[j] (0 <= j <= m) from the pair (j', m − j')."""
    m = g["m"]
    upper = j > m // 2
    jl = torch.where(upper, m - j, j)
    jm = torch.where(jl == 0, 0, m - jl)
    zk, zmk = _z_at(tiles, g, sig, jl), _z_at(tiles, g, sig, jm)
    w = torch.view_as_complex(_twiddles(2 * m, "cpu"))[jl]
    ze = torch.complex(0.5 * (zk.real + zmk.real), 0.5 * (zk.imag - zmk.imag))
    zo = torch.complex(0.5 * (zk.imag + zmk.imag), -0.5 * (zk.real - zmk.real))
    t = torch.complex(w.real * zo.real - w.imag * zo.imag,
                      w.real * zo.imag + w.imag * zo.real)
    return torch.where(upper, torch.complex(ze.real - t.real,
                                            t.imag - ze.imag), ze + t)


def _pairs(g, rank):
    """The pairs rank r takes, its warp steps' lanes in order: qq = (k2 <<
    la) + ℓ, k2 < n2/2 → j = r·A + ℓ + n1·k2 (< m/2), each lane the bins
    j and m − j."""
    la, l2 = g["la"], g["l2"]
    qq = torch.arange(1 << (la + l2 - 1))
    return (rank << la) + (qq & ((1 << la) - 1)) + ((qq >> la) << g["l1"])


def _bins(g, rank):
    """The bins rank r takes: j and m − j of each pair, and m/2 on rank 0."""
    j = _pairs(g, rank)
    out = torch.cat([j, g["m"] - j])
    return torch.cat([out, torch.tensor([g["m"] // 2])]) if rank == 0 else out


def _mirror(frames, scal, *, n, k_lo=0, k_hi=None, vec=True, **kw):
    """Route cluster_large in plain PyTorch → (ids, contrib)."""
    g = _geometry(n)
    m = g["m"]
    k_hi = m + 1 if k_hi is None else k_hi
    tiles = _fft(_load(frames, g, vec), g)
    ids = torch.full((frames.shape[0], k_hi - k_lo), -2, dtype=torch.int32)
    contrib = torch.full((frames.shape[0], k_hi - k_lo), float("nan"))
    seen = []
    for rank in range(g["ctas"]):
        k = _bins(g, rank)
        seen.append(k)
        k = k[(k >= k_lo) & (k < k_hi)]
        X = _x_at(tiles, g, 0, k)
        x1, xm1 = _x_at(tiles, g, 0, torch.tensor([1])), \
            _x_at(tiles, g, 0, torch.tensor([m - 1]))
        Am1 = torch.where(k == 0, torch.conj(x1),
                          _x_at(tiles, g, 0, (k - 1).clamp(min=0)))
        Ap1 = torch.where(k == m, torch.conj(xm1),
                          _x_at(tiles, g, 0, (k + 1).clamp(max=m)))
        Y = _x_at(tiles, g, 1, k)
        i, c = _deposit_at(k, X, Am1, Ap1, Y, scal, n=n, **kw)
        ids[:, k - k_lo], contrib[:, k - k_lo] = i, c
    assert torch.equal(torch.sort(torch.cat(seen)).values,
                       torch.arange(m + 1))                # each bin once
    return ids, contrib


# ----------------------------------------------------------------- tests
def test_plan_and_routing_at_every_size():
    """C = N/points CTAs (8192 points a CTA up to 131072, 16384 at
    262144) of points/16 threads × 16 points (both signals' 2·m/C
    values), W' and Q padded and rows·W' = cols·Q, the transposed stores
    at an odd stride, 8 exchange values a thread in each of two groups,
    and a CTA's shared memory within 227 KB (three CTAs an SM below
    262144); routing by size only."""
    smem = {}
    for n in CLUSTER_LARGE_N:
        g = _geometry(n)
        C, A, W, S = g["ctas"], g["rows"], g["cols"], 2
        assert (g["n1"], g["n2"]) == _FACTORS[n // 2]
        T = g["threads"]
        assert C == n // g["points"] <= 16
        assert T * P == g["points"] == S * g["n1"] * W
        assert A * g["stride_before"] == W * g["stride_after"]
        assert g["stride_before"] > W and g["stride_after"] > A
        assert g["stride_after"] % 2 == 1
        assert g["tile"] == g["n1"] * g["stride_before"] \
            == g["n2"] * g["stride_after"]
        assert 2 * HELD * T == C * A * W * S           # two groups
        smem[n] = g["smem"]
    assert smem == {65536: 73728, 131072: 73728, 262144: 143360}
    assert 3 * smem[65536] <= SMEM_BYTES
    sizes = [1 << k for k in range(9, 19)]
    assert [route_of(n) for n in sizes] == (
        ["block"] * 6 + ["cluster"] + ["cluster_large"] * 3)
    assert ROUTES == ("block", "cluster", "cluster_large", "large")
    # B6 takes the route at 32768 too (tests/test_torch_b6_xcluster.py);
    # B1 stays on its two-CTA cluster there
    assert HIST_ROUTES == ("block", "cluster", "cluster_large", "large")
    assert cluster_large_plan(32768)["ctas"] == 4
    with pytest.raises(ValueError, match="cluster_large_plan"):
        cluster_large_plan(16384)


@pytest.mark.parametrize("n", CLUSTER_LARGE_N)
@pytest.mark.parametrize("vec", [True, False], ids=["16B", "4B"])
def test_load_reads_every_sample_once_into_the_tiles(n, vec):
    g = _geometry(n)
    reads = []
    for rank in range(g["ctas"]):
        at, src = _load_map(g, rank, vec)
        assert at.unique().numel() == at.numel() == g["n1"] * g["cols"]
        assert bool(((at % g["stride_before"]) < g["cols"]).all())
        reads.append(src)
    assert torch.equal(torch.sort(torch.cat(reads)).values,
                       torch.arange(0, n, 2))


@pytest.mark.parametrize("n", CLUSTER_LARGE_N)
def test_exchange_places_every_slice_and_reads_before_stores(n):
    """With each value tagged by (signal, k1, column): afterwards rank r
    holds rows [r·A, (r + 1)·A) of every column at σ·tile + c·Q + ℓ;
    a group's reads never touch what their peer stored in an earlier
    group, and no store lands where a later group reads."""
    g = _geometry(n)
    C, A, W, fs = g["ctas"], g["rows"], g["cols"], g["tile"]
    n1, n2, S = g["n1"], g["n2"], 2
    wp, q = g["stride_before"], g["stride_after"]
    tags = torch.full((1, C, S * fs), -1, dtype=torch.int64)
    sig = torch.arange(S)[:, None, None]
    k1 = torch.arange(n1)[None, :, None]
    jj = torch.arange(W)[None, None, :]
    for rank in range(C):
        at = (sig * fs + k1 * wp + jj).reshape(-1)
        tags[0, rank, at] = (sig * n1 * n2 + k1 * n2 + rank * W + jj
                             ).reshape(-1)
    moves = _exchange_moves(g)
    stored = [set() for _ in range(C)]
    for grp, (rank, p, src, dst) in enumerate(moves):
        for r in range(C):
            for peer in range(C):
                sel = p[r] == peer
                assert not stored[peer] & set(src[r][sel].tolist())
        for r in range(C):
            stored[r] |= set(dst[r].tolist())
        for later in moves[grp + 1:]:
            for r in range(C):
                assert not set(dst[r].tolist()) & set(
                    later[2][later[1] == r].tolist())
    got = _exchange(tags, g)[0]
    ell = torch.arange(A)[None, None, :]
    c = torch.arange(n2)[None, :, None]
    for rank in range(C):
        at = (sig * fs + c * q + ell).reshape(-1)
        want = (sig * n1 * n2 + (rank * A + ell) * n2 + c).reshape(-1)
        assert torch.equal(got[rank, at], want)
        assert at.unique().numel() == at.numel() == S * A * n2


@pytest.mark.parametrize("n", CLUSTER_LARGE_N)
def test_epilogue_lanes_take_neighbours_from_their_run(n):
    """A warp step is 32 consecutive pairs j < m/2, one run of A or two: a
    lane inside a run finds X[j − 1] and X[m − j + 1] on lane l − 1,
    X[j + 1] and X[m − j − 1] on lane l + 1; the run's first and last
    lanes unpack the pair beyond it; every j < m/2 is one rank's, on the
    rank holding row j mod n1."""
    g = _geometry(n)
    run = g["rows"]
    assert 32 % run == 0 and (1 << (g["la"] + g["l2"] - 1)) % 32 == 0
    seen = []
    for rank in range(g["ctas"]):
        j = _pairs(g, rank)
        assert bool(((j % g["n1"]) // run == rank).all())
        seen.append(j)
        j = j.reshape(-1, 32)
        ell = torch.arange(32) % run
        inner = (ell > 0)[1:]
        assert torch.equal(j[:, :-1][:, inner], (j[:, 1:] - 1)[:, inner])
        assert int((j[:, ell == run - 1] + 1).max()) <= g["m"] // 2
    assert torch.equal(torch.sort(torch.cat(seen)).values,
                       torch.arange(g["m"] // 2))


@pytest.mark.parametrize("n", CLUSTER_LARGE_N)
def test_spectra_match_float64_rfft(n):
    """X and Y read through ``x_at`` (every j = 0 … N/2, each from the
    rank holding its rows) against float64 rfft of the raw and the t·h
    frame: 2e-5·max|X| (B4's bound), each signal on its own scale."""
    fr, _, _ = _case(n, 1, seed=n % 61)
    g = _geometry(n)
    tiles = _fft(_load(fr, g), g)
    j = torch.arange(g["m"] + 1)
    th = th_window(n, "cpu").double()
    for sig, x in ((0, fr.double()), (1, fr.double() * th)):
        want = torch.fft.rfft(x)
        err = float((_x_at(tiles, g, sig, j).to(torch.complex128) - want)
                    .abs().max())
        assert err <= 2e-5 * float(want.abs().max()), (sig, err)


@pytest.mark.parametrize("n,b,win", [(65536, 2, None), (65536, 1, None),
                                     (131072, 2, None), (262144, 1, None),
                                     (65536, 2, (700, 9000))])
def test_mirror_meets_b1_criteria_against_plain(n, b, win):
    """The mirror against plain B1 (torch.fft), the whole spectrum and a
    bin window; b = 1 gives frame 0 of the batch bit for bit."""
    fr, scal, kw = _case(n, b, seed=n % 89)
    k = {} if win is None else dict(k_lo=win[0], k_hi=win[1])
    im, cm = _mirror(fr, scal, **kw, **k)
    ip, cp = deposits_ids_plain(fr, *scal, **kw, **k)
    if win is None:
        _assert_b1(im, cm, ip, cp, n=n, rows=kw["rows"], reach=kw["reach"])
    else:
        vm, vp = cm > 0, cp > 0
        agree = ((vm & vp & (im == ip)) | (~vm & ~vp)).float().mean()
        assert float(agree) >= 0.9999
        both = vm & vp
        assert float((cm - cp)[both].abs().max()) <= 1e-5 * float(cp.max())
    if b > 1:
        i1, c1 = _mirror(fr[:1], scal, **kw, **k)
        assert torch.equal(i1, im[:1]) and torch.equal(c1, cm[:1])


def test_both_load_widths_give_the_same_bits():
    fr, scal, kw = _case(65536, 1, seed=3)
    got = _mirror(fr, scal, vec=False, **kw)
    want = _mirror(fr, scal, vec=True, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mirror_matches_pallas_interpret_at_65536():
    """The mirror against the TPU kernel itself (interpret mode), two
    frames of 65536 at hop 16384, as histograms."""
    n, hop, rows, t = 65536, 16384, 128, 2
    jp = JaxPipeline(JaxSettings(mode="enhanced", multires=False,
                                 fft_size=n, hop=hop, raster_height=rows,
                                 sample_rate=96000))
    p, R = jp.params(), jp.reach
    rng = np.random.default_rng(4)
    tt = np.arange((t - 1) * hop + n) / 96000
    x = (np.sin(2 * np.pi * (300 * tt + 2000 * tt * tt))
         + 0.3 * np.sin(2 * np.pi * 1500 * tt)
         + 0.01 * rng.standard_normal(tt.size)).astype(np.float32)
    fr = np.asarray(jax_frame_signal(jnp.asarray(x), n, hop))
    with pltpu.force_tpu_interpret_mode():
        ids_j, c_j = fft4_deposits(jnp.asarray(fr), p.logmap_a, p.logmap_b,
                                   p.power_floor, n=n, hop=hop, sr=96000.0,
                                   rows=rows, reach=R)
    S = (2 * R + 1) * rows
    want = np.array(histogram_reference(ids_j, c_j, S))
    scal = tuple(torch.tensor(np.float32(v)) for v in
                 (p.logmap_a, p.logmap_b, p.power_floor))
    im, cm = _mirror(torch.from_numpy(np.array(fr)), scal, n=n, hop=hop,
                     sr=96000.0, rows=rows, reach=R)
    got = histogram_plain(im, cm, S)
    cmp = compare_grids(torch.from_numpy(want).reshape(t, 2 * R + 1, rows),
                        got.reshape(t, 2 * R + 1, rows))
    assert cmp.ok, cmp


def test_wrapper_routes_cpu_to_plain_and_checks_size():
    fr, scal, kw = _case(65536, 2, seed=1)
    before = (deposits_ids.launches, deposits_ids_cluster_large.launches,
              deposits_ids_large.launches)
    want = deposits_ids_plain(fr, *scal, **kw)
    for got in (deposits_ids_cluster_large(fr, *scal, **kw),
                deposits_ids(fr, *scal, **kw),
                deposits_ids(fr, *scal, **kw, route="cluster_large")):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (deposits_ids.launches, deposits_ids_cluster_large.launches,
            deposits_ids_large.launches) == before
    meta = torch.empty(2, 32768, device="meta")
    s = torch.empty((), device="meta")
    kw32 = dict(n=32768, hop=8192, sr=48000.0, rows=64, reach=2)
    with pytest.raises(ValueError, match="does not take n=32768"):
        deposits_ids(meta, s, s, s, **kw32, route="cluster_large")
    with pytest.raises(ValueError, match="deposits_ids_cluster_large"):
        deposits_ids_cluster_large(meta, s, s, s, **kw32)
    # B6 takes the route too (tests/test_torch_b6_xcluster.py): on a CPU
    # tensor its plain version; below 32768 it is refused
    assert torch.equal(deposits_hist(fr, *scal, 0, **kw,
                                     route="cluster_large"),
                       deposits_hist_plain(fr, *scal, 0, **kw))
    with pytest.raises(ValueError, match="deposits_hist"):
        deposits_hist(fr[:, :16384], *scal, 0, **dict(kw, n=16384),
                      route="cluster_large")
