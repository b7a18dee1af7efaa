"""The port's CUDA kernels against their plain PyTorch versions, on a card
only (marker ``cuda``; each test skips without one).

This file imports nothing of JAX or the JAX package, so it runs on the
machine with the card, which has no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the rest of the
suite).  Tolerances: quantized grids through ``compare_grids``; B1 (each
route) also ≥ 99.99% equal ids, other valid deposits moved one cell,
bins 0 and N/2 exact, contrib within 1e-5·peak, and b = 1 (a live hop)
bit-equal to frame 0 of a batch; its windowed form the same (at 65536
points and hop 128 across the ranks' split ≥ 99.98%, ``WINDOW_AGREE``;
a deposit moved one row and as many columns as float32 plain moves one
from float64 plain, at least one; contrib within 1e-5 of the whole
spectrum's peak), no more ids off float64 plain's than
float32 plain has, and its ids
and unweighted contrib the whole spectrum's slice bit for bit, the band
weight applied within 2.4e-7 relative (one rounding of the product in
another order); B2, B6 (against
B1 → B2 composed) and the probe's ``full`` 1e-5 relative per nonzero bin;
the other probe variants against their own plain versions, 1e-5; B3 and
B5 bit-equal; B4 2e-5·max|X| (the JAX package's four-step bound); B2's
two routes, each forced, also exact zeros, and a path above a block's shared
memory, and the display default ``Settings()`` under each scatter,
against the port's CPU path at PERF.md §2's tolerances, its stream ≡ its
batch within 1e-5 in ``vis``; the live hop's CUDA graph
replay against the eager step within 1.2e-7 in ``vis`` (float atomics
reorder B2's sums), RGBA bit-equal wherever ``vis`` is; the EMA scan
kernel bit-equal to its plain loop (forced repair and non-finite inputs
included), ``post_head`` bit-equal to ``_boost_db_peak``'s peak,
``post_tail`` to its plain version, and the batch post chain bit-equal to
the card's own column-by-column chain, the associative form within
4·⌈log2 t⌉·ε·max|y|; B2's sorted route bit-equal to the plain sum on the
CPU, in both forms (the tiles form at the raster's ids, at reach 1, 2
and 8, added into an output too, the same on a second run); B1's route
cluster_large at 65536–262144 by the B1 criteria against plain (float64
plain settling float32 plain's rounding flips) and against the
three-launch route it replaced, and with a bin window and band weight
by the criteria that hold for a window; the single-bank raster against
the CPU path by ``compare_grids`` and ``compare_vis``, the same on two
runs; B2's ring form bit-equal to its plain version on the CPU at the
six live cells' hop ids (1 and 16 lanes, and 2; NaN/Inf behind dropped
ids, a ring that is not zero, t from 0 past the slot wrap, every cluster
size that fits), and where a hop's entries or a lane's ring outgrow
one CTA (65536–262144 at 96 kHz, 16 lanes at 65536, short hops, 2,048
rows: the hop in windows, the ring in bands, at the plan and forced),
a graphed ``Stream`` there ≡ ``process``; the card's defaults (the
ordered sums): two default
``Stream``s bit-equal, one push and 777-sample pushes bit-equal, the
default stream equal bit for bit to the default ``process`` in ``vis``
and ``rgba`` (the JAX package's ``tests/test_stream.py``), the time
renderer's grid the same on two calls."""

import math

import numpy as np
import pytest
import torch

from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels import ema
from emspec_torch.dsp.kernels.ema import ema_scan, ema_scan_plain
from emspec_torch.dsp.kernels.post import post_head, post_tail, post_tail_plain
from emspec_torch.dsp.kernels.deposits import (
    CLUSTER_LARGE_N, cluster_large_occupancy, cluster_occupancy,
    deposits_hist, deposits_hist_plain, deposits_ids, deposits_ids_cluster,
    deposits_ids_cluster_large, deposits_ids_large, deposits_ids_plain,
    route_of)
from emspec_torch.dsp.kernels.deposits import hist_route_of as hist_route_of_b6
from emspec_torch.dsp.kernels.fourstep import (
    SMALL_MAX, fft4_steps123, fft4_steps123_plain)
from emspec_torch.dsp.kernels.lut import (
    lut_lookup, lut_lookup_plain, lut_values, lut_values_plain)
from emspec_torch import Settings
from emspec_torch.dsp.kernels.scatter import (
    ROUTES, SMEM_BINS, SORTED, SORTED_BATCH, SORTED_RING, SORTED_TILES,
    batch_plan, histogram, histogram_plain, histogram_ring,
    histogram_ring_plain, ring_form, ring_ids, ring_occupancy, ring_plan,
    ring_plan_on)
from emspec_torch.dsp.kernels.scatter import route_of as hist_route_of
from emspec_torch.dsp.kernels.window import (
    windowed_frames, windowed_frames_plain)
from emspec_torch.pipeline import Pipeline
from emspec_torch.post import chain as ema_chain
from emspec_torch.render import raster
from emspec_torch.probes.scatter_ablation import (
    VARIANTS, hist_variant, hist_variant_plain)
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.validate import compare_grids, compare_vis


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tone_noise(samples, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 48000.0
    return (np.sin(2 * np.pi * (150.0 * t + 2000.0 * t * t))
            + 0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.05 * rng.standard_normal(samples)).astype(np.float32)


@pytest.mark.cuda
def test_cuda_deposits_kernel_matches_plain(cuda):
    n, hop, rows, R = 8192, 2048, 512, 2
    x = torch.from_numpy(_tone_noise(39 * hop + n, 9)).to(cuda)
    fr = frame_signal(x, n, hop)
    sc = [torch.tensor(np.float32(v), device=cuda)
          for v in (np.log2(20.0), 511 / (np.log2(24000.0) - np.log2(20.0)),
                    1e-12)]
    ik, ck = deposits_ids(fr, *sc, n=n, hop=hop, sr=48000.0, rows=rows,
                          reach=R)
    ip, cp = deposits_ids_plain(fr, *sc, n=n, hop=hop, sr=48000.0, rows=rows,
                                reach=R)
    S = (2 * R + 1) * rows
    cmp = compare_grids(histogram_plain(ip, cp, S).cpu(),
                        histogram_plain(ik, ck, S).cpu())
    assert cmp.ok, cmp


@pytest.mark.cuda
def test_cuda_histogram_and_lut_kernels_match_plain(cuda):
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(-2, 2562, (37, 4097)).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.uniform(0, 1, (37, 4097)).astype(np.float32)).to(cuda)
    vals[ids < 0] = float("nan")
    got = histogram(ids, vals, 2560)
    want = histogram_plain(ids, vals, 2560)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    idx = torch.from_numpy(rng.integers(0, 256, (99, 512)).astype(np.int32)).to(cuda)
    table = torch.from_numpy(rng.integers(0, 256, (256, 4)).astype(np.uint8)).to(cuda)
    assert torch.equal(lut_lookup(idx, table), lut_lookup_plain(idx, table))


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(fourstep._FACTORS))
@pytest.mark.parametrize("b", [1, 7])
def test_cuda_fourstep_kernel_matches_plain(cuda, n, b):
    n1, n2 = fourstep._FACTORS[n]
    rng = np.random.default_rng(n)
    zr, zi = (torch.from_numpy(rng.standard_normal((b, n1, n2)).astype(
        np.float32)).to(cuda) for _ in range(2))
    before = fft4_steps123.launches
    kr, ki = fft4_steps123(zr, zi)
    assert fft4_steps123.launches == before + 1
    pr, pi = fft4_steps123_plain(zr, zi)
    scale = float(torch.complex(pr, pi).abs().max())
    assert float((kr - pr).abs().max()) / scale < 2e-5
    assert float((ki - pi).abs().max()) / scale < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(fourstep._FACTORS))
def test_cuda_fourstep_single_frame_is_frame_zero(cuda, n):
    """A frame's arithmetic does not depend on the batch: b = 1 gives
    frame 0 of a batch of 5 bit for bit."""
    n1, n2 = fourstep._FACTORS[n]
    rng = np.random.default_rng(n + 1)
    zr, zi = (torch.from_numpy(rng.standard_normal((5, n1, n2)).astype(
        np.float32)).to(cuda) for _ in range(2))
    br, bi = fft4_steps123(zr, zi)
    sr, si = fft4_steps123(zr[:1].clone(), zi[:1].clone())
    assert torch.equal(sr, br[:1]) and torch.equal(si, bi[:1])


@pytest.mark.cuda
def test_cuda_fourstep_offset_view(cuda):
    """A contiguous view 4 bytes into its storage (a live window at an odd
    sample) is not 16-byte aligned: the wrapper copies it, same result."""
    n1, n2 = fourstep._FACTORS[4096]
    rng = np.random.default_rng(3)
    flat = torch.from_numpy(rng.standard_normal((2, 1 + n1 * n2)).astype(
        np.float32)).to(cuda)
    zr, zi = (row[1:].view(1, n1, n2) for row in flat)
    assert zr.data_ptr() % 16 != 0 and zr.is_contiguous()
    got = fft4_steps123(zr, zi)
    want = fft4_steps123(zr.clone(), zi.clone())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [n for n in sorted(fourstep._FACTORS)
                               if n <= SMALL_MAX])
def test_cuda_fourstep_large_route_at_small_sizes(cuda, n):
    """The two-launch route, forced where the one-launch route is the
    default, against the plain version (ragged b = 3)."""
    n1, n2 = fourstep._FACTORS[n]
    rng = np.random.default_rng(n + 2)
    zr, zi = (torch.from_numpy(rng.standard_normal((3, n1, n2)).astype(
        np.float32)).to(cuda) for _ in range(2))
    kr, ki = fft4_steps123(zr, zi, route="large")
    pr, pi = fft4_steps123_plain(zr, zi)
    scale = float(torch.complex(pr, pi).abs().max())
    assert float(torch.maximum((kr - pr).abs().max(),
                               (ki - pi).abs().max())) / scale < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7, 512), (2, 5, 512), (372, 8192), (512,)])
def test_cuda_window_kernel_bit_equal(cuda, shape):
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32)).to(cuda)
    assert torch.equal(windowed_frames(frames), windowed_frames_plain(frames))
    fr = frame_signal(frames.reshape(-1), 256, 64)
    assert torch.equal(windowed_frames(fr), windowed_frames_plain(fr))


@pytest.mark.cuda
@pytest.mark.parametrize("n,hop", [(512, 127), (8192, 2048), (8192, 2047),
                                   (510, 100)])
def test_cuda_window_kernel_misaligned_view(cuda, n, hop):
    """Frames 4 bytes into the signal (4-byte loads), an odd hop, and a
    row length that is not a multiple of 4: still bit-equal."""
    x = torch.from_numpy(np.random.default_rng(n + hop).standard_normal(
        20 * n).astype(np.float32)).to(cuda)
    fr = frame_signal(x[1:], n, hop)
    assert fr.data_ptr() % 16 != 0
    before = windowed_frames.launches
    assert torch.equal(windowed_frames(fr), windowed_frames_plain(fr))
    assert windowed_frames.launches == before + 1


def _scalars(cuda, rows, sr):
    return [torch.tensor(np.float32(v), device=cuda)
            for v in (np.log2(20.0),
                      (rows - 1) / (np.log2(sr / 2.0) - np.log2(20.0)), 1e-12)]


def _b1_case(cuda, n, b, rows=512, sr=96000.0):
    hop = n // 4
    x = torch.from_numpy(_tone_noise((b - 1) * hop + n, n % 101)).to(cuda)
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=2)
    return frame_signal(x, n, hop), _scalars(cuda, rows, sr), kw


def _assert_b1(ik, ck, ip, cp, *, n, rows):
    """The B1 criteria of the card check against plain B1."""
    S = 5 * rows
    cmp = compare_grids(histogram_plain(ip, cp, S).cpu(),
                        histogram_plain(ik, ck, S).cpu())
    assert cmp.ok, cmp
    vk, vp = ck > 0, cp > 0
    both = vk & vp
    agree = (both & (ik == ip)) | (~vk & ~vp)
    assert float(agree.float().mean()) >= 0.9999
    moved = (ik - ip).abs()[both & (ik != ip)]
    assert bool(torch.isin(moved, torch.tensor(
        [1, rows - 1, rows, rows + 1], device=ik.device)).all())
    assert bool(agree[..., [0, n // 2]].all())
    assert bool((ik[~vk] == -1).all())
    assert float((ck - cp)[both].abs().max()) <= 1e-5 * float(cp.max())


def _counts():
    return (deposits_ids.launches, deposits_ids_cluster.launches,
            deposits_ids_large.launches, fft4_steps123.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 65536, 131072, 262144])
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_deposits_large_route_matches_plain(cuda, n, b):
    """The three-launch route (the default above 32768, forced at 32768)."""
    fr, sc, kw = _b1_case(cuda, n, b)
    before = _counts()
    ik, ck = deposits_ids(fr, *sc, **kw, route="large")
    assert _counts() == (before[0], before[1], before[2] + 1, before[3] + 1)
    ip, cp = deposits_ids_plain(fr, *sc, **kw)
    _assert_b1(ik, ck, ip, cp, n=n, rows=kw["rows"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 1024, 2048, 4096, 8192, 16384, 32768])
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_deposits_on_chip_routes(cuda, n, b):
    """The block route (n <= 16384) and the cluster route (32768): one
    launch of their own, no B4 launch; the B1 criteria; b = 1 bit-equal
    to frame 0 of the batch, as an (n,) window too."""
    fr, sc, kw = _b1_case(cuda, n, b)
    route = route_of(n)
    before = _counts()
    ik, ck = deposits_ids(fr, *sc, **kw)
    step = (1, 0) if route == "block" else (0, 1)
    assert _counts() == (before[0] + step[0], before[1] + step[1],
                         before[2], before[3])
    assert ik.shape == ck.shape == (b, n // 2 + 1)
    ip, cp = deposits_ids_plain(fr, *sc, **kw)
    # where float32 plain's rounding flipped, float64 plain decides: at
    # 8192 frame 0's Nyquist bin has Δt/hop on a half-integer tie, which
    # float32 plain rounds up and float64 plain and the kernel round down
    i64, c64 = deposits_ids_plain(fr.double(), *sc, **kw)
    settled = (ik != ip) & (ik == i64) & ((ck > 0) == (c64 > 0))
    ip = torch.where(settled, i64, ip)
    cp = torch.where(settled, c64.float(), cp)
    _assert_b1(ik, ck, ip, cp, n=n, rows=kw["rows"])
    for one in (fr[:1], fr[0]):
        i1, c1 = deposits_ids(one, *sc, **kw)
        assert torch.equal(i1.reshape(1, -1), ik[:1])
        assert torch.equal(c1.reshape(1, -1), ck[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,hop", [(8192, 2048), (8192, 2047), (32768, 800),
                                   (32768, 8191)])
def test_cuda_deposits_misaligned_view(cuda, n, hop):
    """Frames 4 bytes into the signal (and an odd hop) take 4-byte loads:
    the same bits as the aligned copy, which takes 16-byte loads."""
    x = torch.from_numpy(_tone_noise(5 * hop + n + 1, 7)).to(cuda)
    fr = frame_signal(x[1:], n, hop)
    assert fr.data_ptr() % 16 != 0
    sc = _scalars(cuda, 512, 48000.0)
    kw = dict(n=n, hop=hop, sr=48000.0, rows=512, reach=2)
    got = deposits_ids(fr, *sc, **kw)
    want = deposits_ids(fr.contiguous(), *sc, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5])
def test_cuda_deposits_cluster_matches_large_route(cuda, b):
    """At 32768 the cluster route against the three-launch route it
    replaced: the B1 criteria, one against the other."""
    fr, sc, kw = _b1_case(cuda, 32768, b)
    ik, ck = deposits_ids_cluster(fr, *sc, **kw)
    il, cl = deposits_ids(fr, *sc, **kw, route="large")
    _assert_b1(ik, ck, il, cl, n=32768, rows=kw["rows"])
    assert cluster_occupancy(cuda) >= 1


def _agree(ik, ck, ip, cp, rows, band):
    """The B1 criteria that hold for a bin window too: ≥ 99.99% equal ids,
    other valid deposits moved one cell, invalid ones −1 (a valid deposit
    of band weight 0 keeps its id and carries contrib 0), contrib within
    1e-5·peak."""
    vk, vp = ck > 0, cp > 0
    both = vk & vp
    agree = (both & (ik == ip)) | (~vk & ~vp)
    assert float(agree.float().mean()) >= 0.9999
    moved = (ik - ip).abs()[both & (ik != ip)]
    assert bool(torch.isin(moved, torch.tensor(
        [1, rows - 1, rows, rows + 1], device=ik.device)).all())
    assert bool((ik[~vk & (band != 0)] == -1).all())
    assert float((ck - cp)[both].abs().max()) <= 1e-5 * float(cp.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", CLUSTER_LARGE_N)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("win", [False, True], ids=["whole", "window"])
def test_cuda_deposits_cluster_large_route(cuda, n, b, win):
    """Route cluster_large, the default at 65536–262144: one launch of
    its own and no pack, B4 or finish launch; the B1 criteria against
    plain (float64 plain deciding where float32 plain's rounding flipped,
    as at a half-integer Δt/hop) and against the three-launch route it
    replaced; b = 1 bit-equal to frame 0.  With a bin window across the
    ranks' rows and a band weight from a seed (a fifth of it zero), the
    same against the forced large route and plain on that window."""
    fr, sc, kw = _b1_case(cuda, n, b)
    assert route_of(n) == "cluster_large"
    assert cluster_large_occupancy(n, cuda) >= 1
    if win:
        k_lo, k_hi = n // 8 - 37, 3 * n // 8 + 41
        rng = np.random.default_rng(n + b)
        band = rng.uniform(0.0, 1.0, k_hi - k_lo).astype(np.float32)
        band[::5] = 0.0
        kw = dict(kw, k_lo=k_lo, k_hi=k_hi,
                  band=torch.from_numpy(band).to(cuda))
    before = (deposits_ids_cluster_large.launches, _counts())
    ik, ck = deposits_ids(fr, *sc, **kw)
    assert (deposits_ids_cluster_large.launches, _counts()) == (
        before[0] + 1, before[1])
    il, cl = deposits_ids(fr, *sc, **kw, route="large")
    ip, cp = deposits_ids_plain(fr, *sc, **kw)
    i64, c64 = deposits_ids_plain(fr.double(), *sc, **kw)
    settled = (ik != ip) & (ik == i64) & ((ck > 0) == (c64 > 0))
    ip = torch.where(settled, i64, ip)
    cp = torch.where(settled, c64.float(), cp)
    if win:
        _agree(ik, ck, ip, cp, kw["rows"], kw["band"])
        _agree(ik, ck, il, cl, kw["rows"], kw["band"])
    else:
        _assert_b1(ik, ck, ip, cp, n=n, rows=kw["rows"])
        _assert_b1(ik, ck, il, cl, n=n, rows=kw["rows"])
    for one in (fr[:1], fr[0]):
        i1, c1 = deposits_ids(one, *sc, **kw)
        assert torch.equal(i1.reshape(1, -1), ik[:1])
        assert torch.equal(c1.reshape(1, -1), ck[:1])


def _north_case(cuda, b):
    """(b, 32768) frames at hop 800, 48 kHz, 512 rows: R = 20, 20,992
    cells (the north star's shape)."""
    hop, n = 800, 32768
    x = torch.from_numpy(_tone_noise((b - 1) * hop + n, 17)).to(cuda)
    kw = dict(n=n, hop=hop, sr=48000.0, rows=512, reach=20)
    return frame_signal(x, n, hop), _scalars(cuda, 512, 48000.0), kw


def _b6_case(cuda, n, b, signal):
    """B1's case, or a steady 1 kHz tone in 1e-4 noise (hot cells: its
    bins near the tone all land on one cell of the relative histogram);
    n = "north": the north star's shape."""
    if n == "north":
        fr, sc, kw = _north_case(cuda, b)
        if signal == "chirp":
            return fr, sc, kw
        n = 32768
        samples = (b - 1) * kw["hop"] + n
        rng = np.random.default_rng(n % 89)
        x = (np.sin(2 * np.pi * 1000.0 * np.arange(samples) / kw["sr"])
             + 1e-4 * rng.standard_normal(samples)).astype(np.float32)
        return frame_signal(torch.from_numpy(x).to(cuda), n, kw["hop"]), sc, kw
    fr, sc, kw = _b1_case(cuda, n, b)
    if signal == "tone":
        rng = np.random.default_rng(n % 89)
        samples = (b - 1) * kw["hop"] + n
        x = (np.sin(2 * np.pi * 1000.0 * np.arange(samples) / kw["sr"])
             + 1e-4 * rng.standard_normal(samples)).astype(np.float32)
        fr = frame_signal(torch.from_numpy(x).to(cuda), n, kw["hop"])
    return fr, sc, kw


def _b6_counts():
    return (deposits_hist.launches, dict(deposits_hist.route_launches),
            fft4_steps123.launches)


def _assert_b6_composed(got, fr, sc, kw, min_id):
    """B6 against B1 → B2 on the same frames: 1e-5 relative per nonzero
    bin, exact zeros (below min_id too)."""
    S = (2 * kw["reach"] + 1) * kw["rows"]
    ids, contrib = deposits_ids(fr, *sc, **kw)
    want = histogram(torch.where(ids >= min_id, ids, -1), contrib, S)
    _assert_hist_close(got, want)
    if min_id > 0:
        assert float(got[..., :min_id].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 16384, 32768, 65536, 131072, 262144,
                               "north"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("signal", ["chirp", "tone"])
def test_cuda_deposits_hist_matches_composed(cuda, n, masked, signal):
    """B6 on its route against B1 → B2 on the same frames: 1e-5 relative
    per nonzero bin, exact zeros below min_id; one launch of its route
    (route cluster_large at 65536–262144 and at the north star's 32768 ×
    20,992 cells)."""
    fr, sc, kw = _b6_case(cuda, n, 3, signal)
    P = 2 * kw["reach"] + 1
    S = P * kw["rows"]
    min_id = 2 * kw["rows"] if masked else -2**30
    route = hist_route_of_b6(kw["n"], S)
    assert (route == "cluster_large") == (kw["n"] > 32768 or n == "north")
    before = _b6_counts()
    got = deposits_hist(fr, *sc, min_id, **kw)
    after = _b6_counts()
    assert after[0] == before[0] + 1 and got.shape == (3, S)
    assert after[1][route] == before[1][route] + 1
    assert sum(after[1].values()) == sum(before[1].values()) + 1
    _assert_b6_composed(got, fr, sc, kw, min_id)
    plain = deposits_hist_plain(fr, *sc, min_id, **kw)
    cmp = compare_grids(plain.reshape(3, P, -1).cpu(),
                        got.reshape(3, P, -1).cpu())
    assert cmp.ok, cmp


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 131072, 262144, "north"])
@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bands", [None, False, True],
                         ids=["by_shape", "copies", "bands"])
def test_cuda_deposits_hist_cluster_large_route(cuda, n, b, masked, bands):
    """Route cluster_large is one launch (no pack, B4 or finish), within
    1e-5 relative per nonzero bin of the three-launch route forced, with
    exact zeros below min_id; b = 1 is frame 0 of the batch within 1e-5
    (the same zero cells), at two batch sizes; in the design its shape
    takes and in each design forced."""
    fr, sc, kw = _b6_case(cuda, n, b, "chirp")
    S = (2 * kw["reach"] + 1) * kw["rows"]
    min_id = 2 * kw["rows"] if masked else -2**30
    assert hist_route_of_b6(kw["n"], S) == "cluster_large"
    before = _b6_counts()
    got = deposits_hist(fr, *sc, min_id, **kw, bands=bands)
    after = _b6_counts()
    assert after[0] == before[0] + 1 and after[2] == before[2]
    assert after[1]["cluster_large"] == before[1]["cluster_large"] + 1
    assert after[1]["large"] == before[1]["large"]
    assert got.shape == (b, S)
    _assert_hist_close(got, deposits_hist(fr, *sc, min_id, **kw,
                                          route="large"))
    if masked:
        assert float(got[..., :min_id].abs().max()) == 0.0
    for one in (fr[:1], fr[0]):
        _assert_hist_close(deposits_hist(one, *sc, min_id, **kw,
                                         bands=bands).reshape(1, -1), got[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("signal", ["chirp", "tone"])
def test_cuda_deposits_hist_cluster_route(cuda, b, masked, signal):
    """At 32768 the cluster route is one launch (no pack, B4 or finish),
    held to the three-launch large route and to B1 → B2 composed."""
    fr, sc, kw = _b6_case(cuda, 32768, b, signal)
    S = 5 * kw["rows"]
    min_id = 2 * kw["rows"] if masked else -2**30
    assert hist_route_of_b6(32768, S) == "cluster"
    before = _b6_counts()
    got = deposits_hist(fr, *sc, min_id, **kw)
    after = _b6_counts()
    assert after[0] == before[0] + 1 and after[2] == before[2]
    assert after[1]["cluster"] == before[1]["cluster"] + 1
    assert after[1]["large"] == before[1]["large"]
    assert got.shape == (b, S)
    _assert_hist_close(got, deposits_hist(fr, *sc, min_id, **kw,
                                          route="large"))
    _assert_b6_composed(got, fr, sc, kw, min_id)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 32768])
def test_cuda_deposits_hist_single_frame_is_frame_zero(cuda, n):
    """Routes by shape only: b = 1 takes the batch's route and gives
    frame 0 of a batch of 5, within 1e-5 relative per nonzero cell with
    the same zero cells.  Not bit for bit: the shared float atomics add a
    cell's deposits in the order the warps reach them, which changes from
    run to run (two runs of one batch differ in the last bit as well)."""
    fr, sc, kw = _b6_case(cuda, n, 5, "tone")
    route = hist_route_of_b6(n, 5 * kw["rows"])
    batch = deposits_hist(fr, *sc, -2**30, **kw)
    for one in (fr[:1], fr[0]):
        before = deposits_hist.route_launches[route]
        got = deposits_hist(one, *sc, -2**30, **kw)
        assert deposits_hist.route_launches[route] == before + 1
        _assert_hist_close(got.reshape(1, -1), batch[:1])


# (rows, m, cells) of the probe on each of B2's routes: the probe's
# stress shape (row) and a few rows of it (global)
PROBE_SHAPES = {"row": (688, 16512, 2560), "global": (37, 16512, 2560)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(PROBE_SHAPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_probe_variants(cuda, variant, route):
    """Each variant on B2's route for the shape against its own plain
    version; ``full`` and ``no_merge`` against B2; no_zero only where
    the route is the row route."""
    rows, m, cells = PROBE_SHAPES[route]
    assert hist_route_of(rows, m, cells) == route
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cells, (rows, m)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.5] = -1
    ids = torch.from_numpy(ids).to(cuda)
    vals = torch.from_numpy(rng.random((rows, m)).astype(np.float32)).to(cuda)
    if variant == "no_zero" and route == "global":
        with pytest.raises(ValueError, match="row-route"):
            hist_variant(ids, vals, cells, variant)
        return
    before = hist_variant.launches
    got = hist_variant(ids, vals, cells, variant)
    assert hist_variant.launches == before + 1
    want = hist_variant_plain(ids, vals, cells, variant)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    if variant in ("full", "no_merge"):
        _assert_hist_close(got, histogram(ids, vals, cells))


def _hist_case(dev, kind, rows, m, cells, seed):
    """ids with NaN/Inf behind every dropped id: random, or hot cells
    (runs of 32 equal ids, row 0 all in one cell)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        ids = rng.integers(-3, cells + 3, (rows, m))
    else:
        ids = np.repeat(rng.integers(0, cells, (rows, -(-m // 32))), 32,
                        axis=1)[:, :m]
        ids[0] = cells // 3
        ids[:, 5::11] = -1
    vals = rng.uniform(0, 1, (rows, m)).astype(np.float32)
    bad = (ids < 0) | (ids >= cells)
    vals[bad] = np.where(rng.random(int(bad.sum())) < 0.5, np.nan, np.inf)
    return (torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(vals).to(dev))


def _assert_hist_close(got, want):
    """1e-5 relative per nonzero bin, exact zeros elsewhere, all finite."""
    nz = want != 0
    assert bool(torch.isfinite(got).all())
    assert bool((got[~nz] == 0).all())
    assert float(((got - want).abs()[nz] / want[nz].abs()).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind", ["random", "hot"])
@pytest.mark.parametrize("rows,m,cells", [
    (372, 4097, 2560), (16, 16385, 2560), (1, 16385, 20992), (3, 517, 300),
    (2, 5, 64), (5, 20000, SMEM_BINS)])
def test_cuda_histogram_routes_match_plain(cuda, route, kind, rows, m, cells):
    ids, vals = _hist_case(cuda, kind, rows, m, cells, seed=rows + m)
    before = histogram.route_launches[route]
    got = histogram(ids, vals, cells, route=route)
    assert histogram.route_launches[route] == before + 1
    _assert_hist_close(got, histogram_plain(ids, vals, cells))


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [66048, 83968])
@pytest.mark.parametrize("rows,m", [(1, 4097), (40, 4097), (3, 16385)])
def test_cuda_histogram_above_shared_memory(cuda, cells, rows, m):
    ids, vals = _hist_case(cuda, "hot", rows, m, cells, seed=cells % 97)
    assert hist_route_of(rows, m, cells) == "global"
    _assert_hist_close(histogram(ids, vals, cells),
                       histogram_plain(ids, vals, cells))
    with pytest.raises(ValueError, match=str(SMEM_BINS)):
        histogram(ids, vals, cells, route="row")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("ids_off,vals_off", [(1, 1), (3, 3), (1, 2)])
def test_cuda_histogram_misaligned_views(cuda, route, ids_off, vals_off):
    """Views that start off a 16-byte boundary: the same offset (16-byte
    loads after the head) and offsets apart (4-byte loads)."""
    rows, m, cells = 7, 1031, 700
    ids, _ = _hist_case(cuda, "hot", 1, rows * m + 4, cells, seed=3)
    vals = torch.rand(rows * m + 4, device=cuda)
    i = ids.reshape(-1)[ids_off:ids_off + rows * m].reshape(rows, m)
    v = vals[vals_off:vals_off + rows * m].reshape(rows, m)
    v[(i < 0) | (i >= cells)] = float("nan")       # behind the dropped ids
    assert i.is_contiguous() and i.data_ptr() % 16 != 0
    _assert_hist_close(histogram(i, v, cells, route=route),
                       histogram_plain(i, v, cells))


@pytest.mark.cuda
@pytest.mark.parametrize("kw,cells", [
    (dict(fft_size=8192, hop=64), 66048),
    (dict(fft_size=32768, hop=800, raster_height=2048), 83968),
])
def test_cuda_pipeline_above_shared_memory_matches_cpu(cuda, kw, cells):
    """Settings whose relative space passes a block's shared memory run
    on the card through B2's global route (``scatter="auto"``,
    ``exact_sums=False``) in the batch and in the stream, match the CPU
    path, and stream as they batch; by default (the ordered sums) the
    stream is the batch bit for bit."""
    s = Settings(mode="enhanced", multires=False, **kw)
    gpu, cpu = Pipeline(s, cuda), Pipeline(s, "cpu")
    assert (2 * gpu.reach + 1) * gpu.rows == cells and gpu.use_relative_scatter
    x = _tone_noise(s.fft_size + 40 * gpu.hop, 12)
    before = dict(histogram.route_launches)
    vis_g, _, _ = gpu.process(x, exact_sums=False)
    assert histogram.route_launches["global"] > before["global"]
    assert histogram.route_launches["row"] == before["row"]
    t = gpu.num_columns(x.shape[-1])
    cmp = compare_grids(cpu._enhanced_power(cpu.to_device(x), t, cpu.params()),
                        gpu._enhanced_power(gpu.to_device(x), t,
                                            gpu.params()).cpu())
    assert cmp.ok, cmp
    ok, worst, share = compare_vis(cpu.process(x)[0], vis_g.cpu())
    assert ok, (worst, share)
    before = dict(histogram.route_launches)
    vis_s, _ = stream_signal(x, s, cuda, chunk=3000, exact_sums=False)
    assert histogram.route_launches["global"] > before["global"]
    assert histogram.route_launches[SORTED_RING] == before[SORTED_RING]
    assert float(np.abs(vis_s - vis_g.cpu().numpy()).max()) <= 1e-5
    vis_d, _ = stream_signal(x, s, cuda, chunk=3000)
    assert np.array_equal(vis_d, gpu.process(x)[0].cpu().numpy())


# the live settings of chip_smoke.py at a small depth (hops beyond R)
LIVE_SETTINGS = {
    "live": Settings(mode="enhanced", multires=False, fft_size=8192),
    "natural_live": Settings(mode="natural", fft_impl="fourstep"),
    "direct_live": Settings(mode="enhanced", multires=False, fft_size=8192,
                            fft_method="direct", fft_impl="fourstep"),
    "stress_live": Settings(mode="enhanced", multires=False, fft_size=32768,
                            sample_rate=96000, channels=16),
    "north_live": Settings(mode="enhanced", multires=False, fft_size=32768,
                           hop=800),
    "wide_live": Settings(mode="enhanced", multires=False, fft_size=8192,
                          hop=64),
    "multires_live": Settings(),
}
GRAPH_VIS_ATOL = 1.2e-7


def _live_signal(s: Settings, hops: int, seed: int) -> np.ndarray:
    """Audio for ``hops`` full frames, ``s.channels`` channels."""
    x = _tone_noise(max(s.active_fft_sizes) + (hops - 1) * s.hop_samples,
                    seed)
    return x if s.channels == 1 else np.stack(
        [np.roll(x, 37 * c) for c in range(s.channels)])


def _eager_columns(st: Stream, x: np.ndarray, params=None, swap_at=None):
    """The same hops as ``st`` staged them, through the eager step on a
    carry of its own (``swap_at``: hop from which ``params`` apply) →
    (vis, rgba) of every emitted hop, flush included."""
    pipe = st.pipe
    n, hop, R = pipe.n_max, pipe.hop, pipe.reach
    lead = x.shape[:-1]
    window, inner = pipe.init_roll_carry(lead)
    window[..., hop:] = torch.from_numpy(np.ascontiguousarray(
        x[..., :n - hop])).to(window.device)
    p = pipe.params(st.settings)
    frames = (x.shape[-1] - n) // hop + 1
    blocks = [x[..., f * hop + n - hop:f * hop + n] for f in range(frames)]
    blocks += [np.zeros(lead + (hop,), np.float32)] * R
    carry, vis, rgba = (window, inner), [], []
    for f, block in enumerate(blocks):
        if f == frames:
            carry[0].zero_()                      # the flush's window
        if swap_at is not None and f == swap_at:
            p = params
        carry, (v, c, _) = pipe._stream_step_rolling(
            carry, torch.from_numpy(np.ascontiguousarray(block)).to(
                window.device), p)
        if f >= R:
            vis.append(v.clone())
            rgba.append(c.clone())
    return torch.stack(vis), torch.stack(rgba)


def _assert_graph_matches_eager(cols, vis_e, rgba_e):
    vis_g = torch.stack([c.vis for c in cols])
    rgba_g = torch.stack([c.rgba for c in cols])
    assert vis_g.shape == vis_e.shape and rgba_g.shape == rgba_e.shape
    assert float((vis_g - vis_e).abs().max()) <= GRAPH_VIS_ATOL
    same = (vis_g == vis_e)
    assert torch.equal(rgba_g[same], rgba_e[same])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIVE_SETTINGS))
def test_cuda_graph_replay_matches_eager_step(cuda, name):
    """Each live setting: the stream's one-graph-a-hop replay (a capture
    at construction) emits what the eager step emits, hop for hop."""
    s = LIVE_SETTINGS[name]
    st = Stream(s, cuda)
    assert st.captures == 1
    x = _live_signal(s, st.reach + 5, seed=21)
    cols = st.push(x) + st.flush()
    assert [c.index for c in cols] == list(range(len(cols)))
    _assert_graph_matches_eager(cols, *_eager_columns(st, x))
    assert st.captures == 1


@pytest.mark.cuda
def test_cuda_params_setter_does_not_recapture(cuda):
    """A slider move, a colormap change and a zoom copy into the captured
    tensors: no second capture, and the hops after it are the eager
    step's with the new params."""
    s = LIVE_SETTINGS["natural_live"].replace(raster_height=256)
    st = Stream(s, cuda)
    x = _live_signal(s, 40, seed=22)
    hop, n = st.pipe.hop, st.pipe.n_max
    held = st.params.lut
    cols = st.push(x[..., :n + 19 * hop])
    new = st.pipe.params(s.replace(gain=5.0, colormap="viridis",
                                   freq_scale=1.4, smoothing=0.2))
    st.params = new
    cols += st.push(x[..., n + 19 * hop:]) + st.flush()
    assert st.captures == 1 and st.params.lut is held
    assert torch.equal(held, new.lut)
    _assert_graph_matches_eager(cols, *_eager_columns(
        st, x, params=new, swap_at=20))


@pytest.mark.cuda
def test_cuda_columns_keep_values_and_counters_rise_on_replay(cuda):
    """A column taken at hop t still holds hop t's values after later
    replays, and every replay adds each kernel of the hop to its launch
    counter (B2 by its route too)."""
    s = LIVE_SETTINGS["wide_live"]
    st = Stream(s, cuda)
    n, hop, R = st.pipe.n_max, st.pipe.hop, st.reach
    x = _live_signal(s, R + 30, seed=23)
    first = st.push(x[..., :n + R * hop])
    assert len(first) == 1
    kept = (first[0].vis.clone(), first[0].rgba.clone())
    before = (deposits_ids.launches, histogram.launches,
              dict(histogram.route_launches), lut_values.launches)
    later = st.push(x[..., n + R * hop:])
    assert len(later) == 29
    assert torch.equal(first[0].vis, kept[0])
    assert torch.equal(first[0].rgba, kept[1])
    assert not torch.equal(later[-1].vis, first[0].vis)
    assert deposits_ids.launches == before[0] + 29
    assert histogram.launches == before[1] + 29
    assert histogram.route_launches[SORTED_RING] == \
        before[2][SORTED_RING] + 29
    assert lut_values.launches == before[3] + 29


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_cuda_fused_lut_bit_equal_on_views(cuda, offset):
    """Both forms of B3, on a view ``offset`` elements into its buffer, at
    a column, a batch raster and sizes around the head and tail."""
    rng = np.random.default_rng(24 + offset)
    table = torch.from_numpy(rng.integers(0, 256, (256, 4)).astype(
        np.uint8)).to(cuda)
    probes = np.concatenate([(np.arange(256) + 0.5) / 255, np.arange(256)
                             / 255, [np.nan, np.inf, -np.inf, -0.5, 1.5]])
    for npix in (1, 2, 3, 4, 5, 7, 512, 372 * 512 + 3):
        v = rng.uniform(-0.1, 1.1, npix + 3).astype(np.float32)
        v[:min(npix, probes.size)] = probes[:min(npix, probes.size)]
        vals = torch.from_numpy(v).to(cuda)[offset:offset + npix]
        idx = torch.from_numpy(rng.integers(-3, 259, npix + 3).astype(
            np.int32)).to(cuda)[offset:offset + npix]
        assert torch.equal(lut_values(vals, table),
                           lut_values_plain(vals, table))
        assert torch.equal(lut_lookup(idx, table),
                           lut_lookup_plain(idx.clamp(0, 255), table))


# ------------------------------------------- enhanced multires (Settings())
def _window_case(cuda, n: int, win: str):
    """41 frames of ``n`` points at the display default's hop (128),
    scalars and reach, a window of bins and a band weight of that width
    from a seed (a fifth of it zero)."""
    pipe = Pipeline(Settings(), cuda)
    hop = 128
    m = n // 2
    k_lo, k_hi = (pipe.k_slices[pipe.sizes.index(n)] if win == "band" else
                  {"bin0": (0, 37), "nyquist": (m - 40, m + 1),
                   "edge": (m, m + 1),
                   "ranks": (m // 4 - 20, 3 * m // 4 + 21)}[win])
    rng = np.random.default_rng(n + k_lo)
    band = rng.uniform(0.0, 1.0, k_hi - k_lo).astype(np.float32)
    band[::5] = 0.0
    x = torch.from_numpy(_tone_noise(n + 40 * hop, n % 89)).to(cuda)
    p = pipe.params()
    kw = dict(n=n, hop=hop, sr=48000.0, rows=pipe.rows, reach=pipe.reach,
              k_lo=k_lo, k_hi=k_hi, band=torch.from_numpy(band).to(cuda))
    return (frame_signal(x, n, hop), (p.logmap_a, p.logmap_b, p.power_floor),
            kw)


# 65536 points at hop 128 across the ranks' split: Δt/hop spans ±256
# columns there, and float32 itself cannot place every deposit — float32
# plain disagrees with float64 plain on 247 of its 673,425 deposits
# (0.99963), B1 on 154, and B1 with float32 plain (float64 settling ties)
# on 78 (0.999884; NVIDIA H100 80GB HBM3, 700 W, as this test prints
# them).  Every other case holds 0.9999.
WINDOW_AGREE = {(65536, "ranks"): 0.9998}
WINDOW_CASES = ([(n, w) for n in (512, 2048, 8192)
                 for w in ("band", "bin0", "nyquist", "edge", "ranks")]
                + [(n, w) for n in (32768, 65536)
                   for w in ("bin0", "nyquist", "edge", "ranks")])


@pytest.mark.cuda
@pytest.mark.parametrize("n,win", WINDOW_CASES)
def test_cuda_windowed_deposits_match_plain(cuda, n, win):
    """B1 with a bin window and a band weight against its plain version:
    at the display default's bank sizes on the block route, and at 32768
    (the cluster route) and 65536 (the cluster_large route); the bank's own band
    support, a window holding bin 0, one holding N/2 up to the
    spectrum's edge, the single bin N/2, and one across the cluster
    ranks' split at N/8 and 3N/8.  The B1 criteria over the display
    default's relative space (bins 0 and N/2 exact where inside), one
    launch of the route (the block route's counted as the windowed
    form), b = 1 bit-equal to frame 0, the ids and unweighted contrib the
    whole spectrum's slice bit for bit, and the weighted contrib within
    2.4e-7 of the unweighted times the band.  B1 disagrees with float64
    plain on no more deposits than float32 plain does, and moves none
    further in time than float32 plain moves one from float64 plain (Δt
    of a weak bin at 65536 points carries float32 errors of columns at
    hop 128)."""
    fr, sc, kw = _window_case(cuda, n, win)
    k_lo, k_hi, rows, R = kw["k_lo"], kw["k_hi"], kw["rows"], kw["reach"]
    before = _counts() + (deposits_ids.form_launches["window"],
                          deposits_ids_cluster_large.launches)
    ik, ck = deposits_ids(fr, *sc, **kw)
    step = {"block": (1, 0, 0), "cluster": (0, 1, 0), "large": (0, 0, 1),
            "cluster_large": (0, 0, 0)}[route_of(n)]
    assert _counts()[:3] == tuple(b + s for b, s in zip(before, step))
    assert deposits_ids.form_launches["window"] == before[4] + step[0]
    assert deposits_ids_cluster_large.launches == before[5] + (
        route_of(n) == "cluster_large")
    assert ik.shape == ck.shape == (fr.shape[0], k_hi - k_lo)
    ip, cp = deposits_ids_plain(fr, *sc, **kw)
    i64, c64 = deposits_ids_plain(fr.double(), *sc, **kw)
    ip0, vp0 = ip, cp > 0
    settled = (ik != ip) & (ik == i64) & ((ck > 0) == (c64 > 0))
    ip = torch.where(settled, i64, ip)
    cp = torch.where(settled, c64.float(), cp)
    S = (2 * R + 1) * rows
    cmp = compare_grids(histogram_plain(ip, cp, S).cpu(),
                        histogram_plain(ik, ck, S).cpu())
    assert cmp.ok, cmp
    vk, vp = ck > 0, cp > 0
    both = vk & vp
    agree = (both & (ik == ip)) | (~vk & ~vp)
    share = float(agree.float().mean())
    k64 = int(((vk != (c64 > 0)) | (vk & (ik != i64))).sum())
    p64 = int(((vp0 != (c64 > 0)) | (vp0 & (ip0 != i64))).sum())
    # float32 plain's own largest column move from float64 plain, at
    # least one: B1 may move a deposit as far
    own = (ip0 // rows - i64 // rows).abs()[vp0 & (c64 > 0)]
    cols = max(1, int(own.max()) if own.numel() else 0)
    print(f"B1 window n={n} hop={kw['hop']} {win} [{k_lo}, {k_hi}): "
          f"{agree.numel()} deposits, {int((~agree).sum())} disagree with "
          f"plain (agreement {share:.6f}); against float64 plain B1 {k64}, "
          f"float32 plain {p64}; float32 plain moves a deposit up to "
          f"{cols} column(s) from float64 plain")
    assert k64 <= p64
    assert share >= WINDOW_AGREE.get((n, win), 0.9999)
    moved = both & (ik != ip)
    d_col = (ik // rows - ip // rows)[moved].abs()
    d_row = (ik % rows - ip % rows)[moved].abs()
    assert bool(((d_col <= cols) & (d_row <= 1)).all())
    edges = [k - k_lo for k in (0, n // 2) if k_lo <= k < k_hi]
    assert bool(agree[..., edges].all())
    # the peak is the frame's whole spectrum's, as in the other B1 tests:
    # float32 FFT rounding scales with the frame's energy, not the window's
    peak = float(deposits_ids_plain(fr, *sc, **dict(
        kw, k_lo=0, k_hi=None, band=None))[1].max())
    if both.any():
        assert float((ck - cp)[both].abs().max()) <= 1e-5 * peak
    i1, c1 = deposits_ids(fr[0], *sc, **kw)
    assert torch.equal(i1, ik[0]) and torch.equal(c1, ck[0])
    whole = deposits_ids(fr, *sc, **dict(kw, k_lo=0, k_hi=None, band=None))
    iu, cu = deposits_ids(fr, *sc, **dict(kw, band=None))
    assert torch.equal(iu, whole[0][..., k_lo:k_hi]) and torch.equal(ik, iu)
    assert torch.equal(cu, whole[1][..., k_lo:k_hi])
    torch.testing.assert_close(ck, cu * kw["band"], rtol=2.4e-7, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scatter", ["auto", "pallas", "segment_sum"])
def test_cuda_enhanced_multires_matches_cpu(cuda, scatter):
    """``Pipeline(Settings())`` on the card against the CPU path — the
    grid by ``compare_grids``, ``vis`` by ``compare_vis`` — through B1's
    windowed form (three launches, one a bank) and B2 in every scatter
    (``"segment_sum"`` too, batch and live; live, each hop three
    windowed B1 launches and one B2); ``Stream`` matches the batch
    within 1e-5 in ``vis``."""
    s = Settings(scatter=scatter)
    gpu, cpu = Pipeline(s, cuda), Pipeline(s, "cpu")
    x = _tone_noise(8192 + 150 * 128, 33)
    before = (deposits_ids.form_launches["window"], histogram.launches)
    vis_g, _, _ = gpu.process(x)
    assert deposits_ids.form_launches["window"] == before[0] + 3
    assert histogram.launches > before[1]
    t = gpu.num_columns(x.shape[-1])
    cmp = compare_grids(cpu._enhanced_power(cpu.to_device(x), t, cpu.params()),
                        gpu._enhanced_power(gpu.to_device(x), t,
                                            gpu.params()).cpu())
    assert cmp.ok, cmp
    ok, worst, share = compare_vis(cpu.process(x)[0], vis_g.cpu())
    assert ok, (worst, share)
    before = (histogram.launches, deposits_ids.form_launches["window"])
    vis_s, _ = stream_signal(x, s, cuda, chunk=1024)
    hops = histogram.launches - before[0]         # one B2 a hop
    assert hops >= t
    assert deposits_ids.form_launches["window"] == before[1] + 3 * hops
    assert float(np.abs(vis_s - vis_g.cpu().numpy()).max()) <= 1e-5


# ------------------------------------------------------------ EMA scan
def _ema_case(dev, t, c, seed):
    rng = np.random.default_rng(seed)
    xs = torch.from_numpy(rng.uniform(0, 1, (t, c)).astype(np.float32)).to(dev)
    y0 = torch.from_numpy(rng.uniform(0, 1, c).astype(np.float32)).to(dev)
    return xs, y0


EMA_SHAPES = [(t, c) for t in (0, 1, 127, 300) for c in (1, 16, 512, 8192)
              ] + [(5937, 1), (5937, 16), (5937, 512), (372, 8192),
                   (1437, 512), (372, 16), (17, 512), (49, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", EMA_SHAPES)
def test_cuda_ema_scan_bit_equal_to_plain(cuda, t, c):
    """Every t around the chunks (one chunk, L ± 1, many), every shape of
    ``chip_smoke.py``'s ``EMA_CASES``, α the display default's 0 and 0.6
    as device tensors and the AGC's 0.99 as a float."""
    xs, y0 = _ema_case(cuda, t, c, seed=t + c)
    for alpha in (torch.tensor(np.float32(0.0), device=cuda),
                  torch.tensor(np.float32(0.6), device=cuda), 0.99):
        b = (1.0 - alpha) * xs
        before = ema_scan.launches
        ys, fin = ema_scan(y0, alpha, b)
        assert ema_scan.launches == before + (1 if t else 0)
        ps, pfin = ema_scan_plain(y0, alpha, b)
        assert torch.equal(ys, ps) and torch.equal(fin, pfin)
        assert ys.shape == (t, c) and fin.shape == (c,)


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", [(300, 512), (5937, 1), (372, 16),
                                 (1437, 512)])
def test_cuda_ema_scan_forced_repair(cuda, t, c):
    """W forced to 0 at α = 0.99: every boundary fails, every chunk after
    the first is repaired (the card's count says so), and the result is
    the plain loop's bit for bit, the same on a second run."""
    xs, y0 = _ema_case(cuda, t, c, seed=t)
    b = (1.0 - 0.99) * xs
    counter = ema.repair_counter(cuda)
    counter.zero_()
    ys, fin = ema_scan(y0, 0.99, b, window=0)
    chunks = -(-t // ema.chunk_len(t, c))
    assert int(counter.item()) == (chunks - 1) * c
    ps, pfin = ema_scan_plain(y0, 0.99, b)
    assert torch.equal(ys, ps) and torch.equal(fin, pfin)
    again, afin = ema_scan(y0, 0.99, b, window=0)
    assert torch.equal(again, ys) and torch.equal(afin, fin)


@pytest.mark.cuda
def test_cuda_ema_scan_non_finite_as_the_loop(cuda):
    """NaN and ±inf in b, at chunk boundaries and inside chunks, with and
    without forced repair: the plain loop's bits."""
    xs, y0 = _ema_case(cuda, 400, 64, seed=4)
    xs[15, 0] = float("nan")
    xs[16, 1] = float("inf")
    xs[35, 2] = float("-inf")
    xs[80, 3], xs[81, 3] = float("inf"), float("-inf")
    xs[300:, 4] = float("nan")
    for alpha in (torch.tensor(np.float32(0.0), device=cuda),
                  torch.tensor(np.float32(0.6), device=cuda), 0.99):
        want = ema_scan_plain(y0, alpha, xs)
        for window in (None, 0):
            got = ema_scan(y0, alpha, xs, window=window)
            for g, w in zip(got, want):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_cuda_ema_scan_reads_alpha_on_the_device(cuda):
    """The slider's α is read by the kernel from device memory: a value
    copied into the same tensor changes the result, with no host read."""
    xs, y0 = _ema_case(cuda, 200, 512, seed=3)
    alpha = torch.tensor(np.float32(0.2), device=cuda)
    b = xs * 0.5
    first, _ = ema_scan(y0, alpha, b)
    alpha.copy_(torch.tensor(np.float32(0.7)))
    second, _ = ema_scan(y0, alpha, b)
    want, _ = ema_scan_plain(y0, torch.tensor(np.float32(0.7), device=cuda), b)
    assert not torch.equal(first, second) and torch.equal(second, want)


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", [(372, 8192), (1437, 512), (5937, 1)])
def test_cuda_associative_form_within_tolerance(cuda, t, c):
    xs, y0 = _ema_case(cuda, t, c, seed=t)
    for alpha in (torch.tensor(np.float32(0.6), device=cuda), 0.99):
        seq, _ = ema_chain._ema_scan(y0, alpha, xs, False)
        assoc, fin = ema_chain._ema_scan(y0, alpha, xs, True)
        bound = 4 * math.ceil(math.log2(t)) * 1.1920929e-07 * float(
            seq.abs().max())
        assert float((assoc - seq).abs().max()) <= bound
        assert torch.equal(fin, assoc[-1])


def _post_case(cuda, t, lead, rows, smoothing, seed):
    freqs = np.geomspace(20.0, 24000.0, rows)
    p = ema_chain.PostParams.from_settings(
        Settings().replace(smoothing=smoothing), freqs, cuda)
    rng = np.random.default_rng(seed)
    power = torch.from_numpy((10.0 ** rng.uniform(-12, 0, (t,) + lead + (
        rows,))).astype(np.float32)).to(cuda)
    return p, power


@pytest.mark.cuda
@pytest.mark.parametrize("t,smoothing", [(300, 0.5), (1000, 0.5),
                                         (5937, 0.5), (5937, 0.0)])
def test_cuda_post_chain_batch_is_column_by_column(cuda, t, smoothing):
    """On the card the batch chain (``post_head``, ``ema_scan`` over the
    AGC series, ``post_tail``) equals the live step's column-by-column
    chain bit for bit: one chunk's worth of columns, t above a chunk, the
    multires length, the display default's smoothing 0."""
    rows = 512
    p, power = _post_case(cuda, t, (), rows, smoothing, seed=8)
    st0 = ema_chain.PostState.init((rows,), cuda)
    before = (post_head.launches, ema_scan.launches, post_tail.launches)
    batch, bst = ema_chain.postprocess_batch(power, st0, p)
    assert (post_head.launches, ema_scan.launches, post_tail.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    st, cols = st0, []
    for i in range(power.shape[0]):
        out, st = ema_chain.postprocess_column(power[i], st, p)
        cols.append(out)
    assert torch.equal(batch, torch.stack(cols))
    assert torch.equal(bst.smooth, st.smooth)
    assert torch.equal(bst.agc_ref, st.agc_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("smoothing", [0.5, 0.51, 0.6, 0.75, 0.9, 0.99])
def test_cuda_post_tail_over_silence_in_both_forms(cuda, smoothing):
    """``post_tail`` over gated silence (power 0: b exactly 0) after
    content, from step 0 with y0 0 and > 0, a stretch across chunk
    boundaries, NaN and +inf power beside a stretch, y0 +inf: bit-equal
    to its plain version in the form the kernel takes (pipelined above
    one half, with nothing repaired) and with W forced to 0 (every form
    chunk-parallel), the same on a second run."""
    t, rows = 1500, 64
    p, power = _post_case(cuda, t, (2,), rows, smoothing, seed=12)
    power[300:1100, 0] = 0.0                  # after content
    power[:700, 1, :32] = 0.0                 # from step 0
    power[777:1013, :, 32:] = 0.0             # across chunk boundaries
    power[299, 0, 6] = float("inf")           # lead 0's AGC series +inf on
    power[1101, 0, 5] = float("nan")          # then NaN
    refs, _ = ema_scan(ema_chain.PostState.init((2, rows), cuda).agc_ref,
                       ema_chain.AGC_DECAY, post_head(
                           power, p.low_end_ramp, p.gain, 0.01))
    y0 = torch.zeros((2, rows), device=cuda)
    y0[1, :16] = 0.5
    y0[1, 16] = float("inf")
    want = post_tail_plain(power, refs, y0, p)
    counter = ema.repair_counter(cuda)
    for window in (None, 0):
        counter.zero_()
        got = post_tail(power, refs, y0, p, window=window)
        torch.cuda.synchronize()
        if window is None and smoothing > 0.5:
            assert int(counter.item()) == 0
        again = post_tail(power, refs, y0, p, window=window)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
            assert torch.equal(a.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,agc_global", [((3,), False), ((3,), True),
                                             ((2, 2), True)])
def test_cuda_post_chain_channels_column_by_column(cuda, lead, agc_global):
    """Channels, with and without the global AGC's torch coupling: batch
    ≡ column by column bit for bit."""
    p, power = _post_case(cuda, 200, lead, 512, 0.5, seed=9)
    st0 = ema_chain.PostState.init(lead + (512,), cuda)
    batch, bst = ema_chain.postprocess_batch(power, st0, p, agc_global)
    st, cols = st0, []
    for i in range(power.shape[0]):
        out, st = ema_chain.postprocess_column(power[i], st, p, agc_global)
        cols.append(out)
    assert torch.equal(batch, torch.stack(cols))
    assert torch.equal(bst.smooth, st.smooth)
    assert torch.equal(bst.agc_ref, st.agc_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("t,lead,rows", [(372, (), 512), (5937, (), 512),
                                         (372, (16,), 512), (50, (3,), 47),
                                         (7, (2, 2), 4098)])
def test_cuda_post_head_bit_equal_to_boost_db_peak(cuda, t, lead, rows):
    """``post_head`` against ``_boost_db_peak``'s peak (torch's stages 1–3
    and ``amax``) bit for bit, in both load forms (rows % 4) and scaled;
    zeros, NaN and ±inf in the power propagate as ``amax`` does."""
    p, power = _post_case(cuda, t, lead, rows, 0.0, seed=t + rows)
    power.reshape(-1)[::97] = 0.0
    power.reshape(-1)[5] = float("inf")
    power.reshape(-1)[rows + 3] = float("nan")
    _, want = ema_chain._boost_db_peak(power, p, False, ())
    got = post_head(power, p.low_end_ramp, p.gain)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    scaled = post_head(power, p.low_end_ramp, p.gain, scale=0.5)
    assert torch.equal(scaled.view(torch.int32),
                       (0.5 * want).view(torch.int32))
    assert torch.equal(post_head(power, p.low_end_ramp, p.gain).view(
        torch.int32), got.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("smoothing", [0.0, 0.6, 0.99])
@pytest.mark.parametrize("window", [None, 0])
def test_cuda_post_tail_bit_equal_to_plain(cuda, smoothing, window):
    """``post_tail`` against its plain version bit for bit at the multires
    shape, forced repair included, the same on a second run."""
    p, power = _post_case(cuda, 5937, (), 512, smoothing, seed=10)
    refs = post_head(power, p.low_end_ramp, p.gain)
    y0 = torch.rand(512, device=cuda)
    want, wfin = post_tail_plain(power, refs, y0, p)
    got, fin = post_tail(power, refs, y0, p, window=window)
    assert torch.equal(got, want) and torch.equal(fin, wfin)
    again, afin = post_tail(power, refs, y0, p, window=window)
    assert torch.equal(again, got) and torch.equal(afin, fin)


# ------------------------------------------------------------ raster
@pytest.mark.cuda
@pytest.mark.parametrize("rows,m,cells", [(1, 400_000, 300_000), (3, 5000, 700),
                                          (16, 16385, 2560), (2, 5, 64)])
def test_cuda_histogram_sorted_route_bit_equal_to_cpu_plain(cuda, rows, m,
                                                            cells):
    ids, vals = _hist_case(cuda, "hot", rows, m, cells, seed=rows * 7 + m)
    vals[(ids < 0) | (ids >= cells)] = float("nan")
    before = histogram.route_launches[SORTED]
    got = histogram(ids, vals, cells, route=SORTED)
    assert histogram.route_launches[SORTED] == before + 1
    want = histogram_plain(ids.cpu(), vals.cpu(), cells)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(histogram(ids, vals, cells, route=SORTED), got)
    base = torch.rand(rows, cells, device=cuda)
    added = histogram(ids, vals, cells, route=SORTED, out=base.clone())
    assert torch.equal(added.cpu(), histogram_plain(ids.cpu(), vals.cpu(),
                                                    cells, out=base.cpu()))


def _raster_ids(cuda, n, hop, seconds, rows=1):
    """The single-bank raster's ids t_bin·K + f_bin (−1 where dropped) and
    powers, as ``dsp.reassign`` makes them on the card, ``rows`` signals."""
    from emspec_torch.dsp.reassign import (
        reassigned_bins, reassignment_corrections)
    from emspec_torch.dsp.stft import stft_triple
    x = torch.from_numpy(np.stack([_tone_noise(int(48000 * seconds), 5 + r)
                                   for r in range(rows)])).to(cuda)
    X = stft_triple(x, n, hop, "direct")
    t = X[0].shape[-2]
    t_bin, f_bin, p = reassigned_bins(*reassignment_corrections(*X), n, hop,
                                      t)
    ids = torch.where(p != 0, t_bin * (n // 2 + 1) + f_bin, -1)
    return (ids.reshape(rows, -1).contiguous(),
            p.reshape(rows, -1).contiguous(), t, n // 2 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hop,rows", [
    (8192, 2048, 1), (8192, 2048, 3), (2048, 1024, 1), (1024, 64, 2),
    (32768, 8192, 1)])
def test_cuda_histogram_sorted_tiles_bit_equal_to_cpu_plain(
        cuda, n, hop, rows):
    """The sorted route's tiles form at the raster's ids (8192 at hop 2048
    on 16 s is the raster's 372 × 4097 deposits, R = 2; R = 1 and 8, and
    32768's column of 16,385 cells, one column a tile, beside it):
    one launch of the tiles form, bit-equal to the CPU plain sum, added
    into an output too, and the same on a second run."""
    ids, vals, t, k = _raster_ids(cuda, n, hop, 16.0 if n == 8192 else 6.0,
                                  rows)
    cells, reach = t * k, -(-n // (2 * hop))
    bound = dict(reach=reach, frame_len=k)
    before = (histogram.route_launches[SORTED_TILES],
              histogram.route_launches[SORTED])
    got = histogram(ids, vals, cells, route=SORTED, **bound)
    assert (histogram.route_launches[SORTED_TILES],
            histogram.route_launches[SORTED]) == (before[0] + 1, before[1])
    want = histogram_plain(ids.cpu(), vals.cpu(), cells)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(histogram(ids, vals, cells, route=SORTED, **bound),
                       got)
    base = torch.rand(rows, cells, device=cuda)
    added = histogram(ids, vals, cells, route=SORTED, out=base.clone(),
                      **bound)
    assert torch.equal(added.cpu(), histogram_plain(
        ids.cpu(), vals.cpu(), cells, out=base.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,hop,channels,bands,shift", [
    (8192, 2048, 1, None, None), (8192, 2048, 3, None, None),
    (8192, 2048, 1, 4, 0), (32768, 800, 1, None, None),
    (8192, 64, 1, None, None), (8192, 2048, 2, 16, 1)])
def test_cuda_histogram_sorted_batch_bit_equal_to_cpu_plain(
        cuda, n, hop, channels, bands, shift):
    """The sorted route's batch form at the enhanced batch's own ids (the
    absolute (t, rows) grid: 8192 mono and 3 lanes, the north star's
    32768 at hop 800, hop 64's R = 64; the plan's bands and row blocks and
    others forced): one launch of the batch form and none of the global
    sort, bit-equal to the CPU plain sum, added into an output too, and
    the same on a second run; ``process`` takes it by default."""
    from emspec_torch.dsp.kernels import scatter

    s = Settings(mode="enhanced", multires=False, fft_size=n, hop=hop,
                 channels=channels)
    pipe = Pipeline(s, cuda)
    x = np.stack([_tone_noise(48000 * 3, 60 + c) for c in range(channels)])
    xg = torch.from_numpy(x if channels > 1 else x[0]).to(cuda)
    t = pipe.num_columns(xg.shape[-1])
    p = pipe.params()
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xg, t), p)
    ids = pipe._absolute_ids(ids_rel, t, pipe.reach)
    lead, k = ids.shape[:-2], ids.shape[-1]
    fi = ids.reshape(lead + (-1,)).contiguous()
    fc = contrib.reshape(lead + (-1,)).contiguous()
    cells = t * pipe.rows
    bound = dict(route=SORTED, reach=pipe.reach, frame_len=k,
                 column_len=pipe.rows, form="batch")
    real = scatter.batch_plan
    if bands is not None:
        scatter.batch_plan = lambda *a, **kw: real(*a, bands=bands,
                                                   row_shift=shift)
    try:
        before = (histogram.route_launches[SORTED_BATCH],
                  histogram.route_launches[SORTED])
        got = histogram(fi, fc, cells, **bound)
        assert (histogram.route_launches[SORTED_BATCH],
                histogram.route_launches[SORTED]) == (before[0] + 1,
                                                      before[1])
        want = histogram_plain(fi.cpu(), fc.cpu(), cells)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(histogram(fi, fc, cells, **bound), got)
        base = torch.rand(lead + (cells,), device=cuda)
        added = histogram(fi, fc, cells, out=base.clone(), **bound)
        assert torch.equal(added.cpu(), histogram_plain(
            fi.cpu(), fc.cpu(), cells, out=base.cpu()))
    finally:
        scatter.batch_plan = real
    assert batch_plan(t, k, pipe.reach, pipe.rows, max(1, channels))["fits"]
    before = dict(histogram.route_launches)
    grid = pipe._enhanced_power(xg, t, p)
    rises = {r: histogram.route_launches[r] - before[r] for r in before}
    assert rises == {r: int(r == SORTED_BATCH) for r in rises}
    assert torch.equal(grid.reshape(want.shape).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n", [("enhanced", 8192), ("natural", 2048),
                                    ("enhanced", 1024)])
def test_cuda_raster_matches_cpu_and_repeats(cuda, mode, n):
    s = Settings(mode=mode, multires=False, fft_size=n)
    x = _tone_noise(48000 * 4, 21)
    before = (windowed_frames.launches,
              histogram.route_launches[SORTED_TILES], post_head.launches,
              ema_scan.launches, post_tail.launches)
    vis = raster.render_vis(x, s, cuda)
    if mode == "enhanced":
        assert windowed_frames.launches == before[0] + 1
        assert histogram.route_launches[SORTED_TILES] == before[1] + 1
    assert (post_head.launches, ema_scan.launches, post_tail.launches) == (
        before[2] + 1, before[3] + 1, before[4] + 1)
    assert np.array_equal(raster.render_vis(x, s, cuda), vis)
    ok, worst, share = compare_vis(
        torch.from_numpy(raster.render_vis(x, s, "cpu").T.copy()),
        torch.from_numpy(vis.T.copy()))
    assert ok, (worst, share)
    if mode == "enhanced":
        g = compare_grids(raster.analyze(torch.from_numpy(x), s),
                          raster.analyze(torch.from_numpy(x).to(cuda),
                                         s).cpu())
        assert g.ok, g


# ------------------------------------------------------------ the live app
def _app_signal(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 48000)) / 48000
    x = (0.5 * np.sin(2 * np.pi * (200 * t + 0.5 * 5800 / seconds * t * t))
         + sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440, 880, 1320))
         + 0.01 * rng.standard_normal(t.size))
    return x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"mode": "natural"},
                                {"multires": False, "fft_size": 2048}],
                         ids=["default", "natural", "enhanced-2048"])
def test_cuda_app_image_matches_cpu_app(cuda, tmp_path, kw):
    """``EmSpecApp`` on the card (a graph replay a hop, B1–B3) against the
    same app on the CPU after the same pushes and one continuous change:
    at most 1e-3 of the pixels differ."""
    from emspec_torch.app import EmSpecApp
    s = Settings(raster_width=256, **kw)
    x = _app_signal(1.5, 31)
    gpu = EmSpecApp(s, user_dir=tmp_path / "g", device=cuda)
    cpu = EmSpecApp(s, user_dir=tmp_path / "c", device="cpu")
    assert gpu.stream.captures == 1
    for i in range(0, x.size, 1024):
        assert gpu.push_audio(x[i:i + 1024]) == cpu.push_audio(x[i:i + 1024])
        if i == 24 * 1024:
            assert gpu.set(gain=6.0, smoothing=0.4) == cpu.set(
                gain=6.0, smoothing=0.4) == "continuous"
    assert gpu.stream.captures == 1            # the slider re-captured nothing
    a, b = gpu.image(), cpu.image()
    assert a.shape == b.shape == (512, 256, 4)
    assert float((a != b).any(-1).mean()) <= 1e-3


@pytest.mark.cuda
def test_cuda_swaps_under_a_running_prewarm(cuda, tmp_path):
    """Ten structural swaps while a background prewarm of the whole
    dropdown runs: nothing raises, every new stream captured once, a
    continuous change captures nothing, and reserved memory after swap 10
    is within one stream's memory of after swap 2."""
    from emspec_torch.app import EmSpecApp
    from emspec_torch.pipeline import _cached_pipeline, prewarm

    base = Settings()
    cycle = [base.replace(multires=False, fft_size=4096),
             base.replace(mode="natural"),
             base.replace(multires=False, fft_size=8192), base,
             base.replace(multires=False, fft_size=2048),
             base.replace(mode="natural"),
             base.replace(multires=False, fft_size=16384), base,
             base.replace(multires=False, fft_size=1024),
             base.replace(mode="natural")]
    pool = 0
    for v in {c: None for c in cycle}:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        st = Stream(v, cuda)
        pool = max(pool, torch.cuda.memory_reserved() - r0)
        st.close()
    app = EmSpecApp(base, user_dir=tmp_path, device=cuda)
    _cached_pipeline.cache_clear()
    warms = [prewarm(base, (512, 1024, 2048, 4096, 8192, 16384, 32768),
                     device=cuda) for _ in range(4)]
    x = _app_signal(0.5, 32)
    reserved, during = [], 0
    for v in cycle:
        during += not all(w.done() for w in warms)
        old = app.stream
        assert app.apply_settings(v) == "structural"
        assert app.stream is not old and app.stream.captures == 1
        app.push_audio(x)
        st = app.stream
        assert app.set(gain=app.settings.gain + 1.0) == "continuous"
        assert app.stream is st and st.captures == 1
        app.push_audio(x)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    for w in warms:
        w.result(timeout=300)
    assert during >= 1
    assert reserved[9] - reserved[1] <= pool, (reserved, pool)


@pytest.mark.cuda
def test_cuda_validate_kernels_full(cuda):
    from emspec_torch.dsp.kernels.validate import validate_kernels
    report = validate_kernels(quick=False)
    assert report["kernels_validated"] and not report["quick"]
    forms = [c.split(" · ")[1] for c in report["checked"]]
    for form in ("sorted batch", "sorted tiles", "ring local",
                 "ring cluster", "row", "global", "windowed"):
        assert form in forms, (form, report["checked"])
    batch = [c for c in report["checked"] if " sorted batch " in c]
    assert any("north:" in c and c.endswith("packed entries") for c in batch)
    assert any("ext262144:" in c and "16 row bands" in c for c in batch)
    assert any("batch16: 16 × " in c for c in batch)
    assert forms.count("windowed") == 3


# ------------------------------------------------ checkpoints and sharding
@pytest.mark.cuda
def test_cuda_graphed_stream_checkpoint_round_trip(cuda, tmp_path):
    """A graphed Stream saved mid-run resumes in a fresh graphed Stream
    (copied into its captured tensors: no second capture) within live ≡
    batch's 1e-5 of the uninterrupted stream."""
    from emspec_torch.utils.checkpoint import load_stream, save_stream

    s = Settings(mode="enhanced", multires=False, fft_size=2048)
    x = _tone_noise(48000 * 2, seed=21)
    cut = 30 * s.hop_samples + 2048
    ref = Stream(s, cuda)
    want = ref.push(x) + ref.flush()
    a = Stream(s, cuda)
    cols = a.push(x[:cut])
    save_stream(tmp_path / "s", a)
    b = Stream(s, cuda)
    load_stream(tmp_path / "s", b)
    cols += b.push(x[cut:]) + b.flush()
    assert b.captures == 1 and a._t == 31
    assert [c.index for c in cols] == [c.index for c in want]
    diff = (torch.stack([c.vis for c in cols])
            - torch.stack([c.vis for c in want])).abs().max()
    assert float(diff) <= 1e-5


@pytest.fixture
def nccl_world_1(cuda):
    """A world-size-1 NCCL group for the test, gone after it."""
    import torch.distributed as dist

    from emspec_torch import parallel

    created = parallel.init_group(cuda)
    assert dist.get_backend() == "nccl"
    yield cuda
    if created:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("kw,channels", [
    ({}, 1),                                  # the display default
    ({"mode": "natural", "multires": False, "fft_size": 2048}, 1),
    ({"multires": False, "fft_size": 8192, "agc_global": True}, 4),
])
def test_cuda_time_parallel_matches_unsharded(nccl_world_1, kw, channels):
    """TimeParallelRenderer at world 1 against Pipeline.process on the
    card: vis 1e-5, the final state within the JAX package's bounds; the
    chunk scans of the re-base run on the scan kernel."""
    from emspec_torch import parallel

    dev = nccl_world_1
    s = Settings(channels=channels, smoothing=0.4, **kw)
    x = np.stack([_tone_noise(48000 * 2, seed=30 + c)
                  for c in range(channels)])
    x = x[0] if channels == 1 else x
    mesh = (parallel.ch_time_mesh(1, device=dev) if channels > 1
            else parallel.channel_mesh(axis="t", device=dev))
    r = parallel.TimeParallelRenderer(s, mesh)
    before = ema_scan.launches
    parallel.COLLECTIVES.clear()
    vis, rgba, st = r.render(x)
    assert ema_scan.launches - before == 2
    want = {"all_gather": 2, "broadcast": 1}
    if channels > 1:
        want["all_reduce_max"] = 1
    assert dict(parallel.COLLECTIVES) == want
    vis1, rgba1, st1 = Pipeline(s, dev).process(x)
    assert vis.shape == vis1.shape and rgba.dtype == torch.uint8
    assert float((vis - vis1).abs().max()) <= 1e-5
    assert float((st.smooth - st1.smooth).abs().max()) <= 1e-5
    assert float((st.agc_ref - st1.agc_ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("agc", [False, True])
def test_cuda_sharded_stream_and_pipeline_match_unsharded(nccl_world_1, agc):
    """ShardedStream (through stream_signal_sharded) and ShardedPipeline
    at world 1 against the unsharded batch on the card, vis 1e-5; one
    max a hop with the global AGC, none without."""
    from emspec_torch import parallel

    dev = nccl_world_1
    s = Settings(mode="enhanced", multires=False, fft_size=4096,
                 channels=2, agc_global=agc)
    x = np.stack([_tone_noise(48000, seed=40), _tone_noise(48000, seed=41)])
    mesh = parallel.channel_mesh(device=dev)
    vis_b, _, _ = Pipeline(s, dev).process(x)
    parallel.COLLECTIVES.clear()
    vis_s, _ = parallel.stream_signal_sharded(x, s, mesh)
    hops = vis_s.shape[0] + Pipeline(s, dev).reach
    assert parallel.COLLECTIVES["all_reduce_max"] == (hops if agc else 0)
    assert float(np.abs(vis_s - vis_b.cpu().numpy()).max()) <= 1e-5
    vis_p, _, _ = parallel.ShardedPipeline(s, mesh).process(x)
    assert float((vis_p - vis_b).abs().max()) <= 1e-5


def _colormap_steps(a: np.ndarray, b: np.ndarray) -> tuple:
    """Two RGBA images → (the largest difference of their inferno
    indices where they differ, the share of pixels that differ); a
    differing pixel must be a colormap entry in both."""
    from emspec_torch.tables import lut

    index = {tuple(c): i for i, c in enumerate(lut("inferno"))}
    a, b = a.reshape(-1, 4), b.reshape(-1, 4)
    moved = (a != b).any(-1)
    steps = [abs(index[tuple(p)] - index[tuple(q)])
             for p, q in zip(a[moved], b[moved])]
    return max(steps, default=0), float(moved.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("channels,sr,seconds,extra", [
    (1, 48000, 16.0, ["--multires"]),
    (2, 48000, 16.0, ["--channel", "all"]),      # a 2 × (cards/2) mesh
    (16, 96000, 4.0, ["--channel", "all"]),      # channels over the cards
])
def test_cuda_time_parallel_render_across_cards(cuda, tmp_path, channels,
                                                sr, seconds, extra):
    """``render --time-parallel`` under torchrun, one rank a card on every
    card of the machine, renders what one process renders, within one
    colormap step a pixel; skips with fewer than two cards."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from emspec_torch.io.wav import write_wav
    from emspec_torch.render.png import read_png

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards or more")
    root = Path(__file__).resolve().parents[1]
    x = np.stack([_tone_noise(int(seconds * sr), seed=50 + c)
                  for c in range(channels)])
    write_wav(tmp_path / "in.wav", x[0] if channels == 1 else x, sr)
    env = dict(os.environ, PYTHONPATH=str(root))
    runs = {"one": [], "cards": ["-m", "torch.distributed.run",
                                 "--standalone", f"--nproc-per-node={cards}"]}
    for name, launcher in runs.items():
        args = ["render", str(tmp_path / "in.wav"),
                str(tmp_path / f"{name}.png"), *extra]
        if name == "cards":
            args.append("--time-parallel")
        r = subprocess.run([sys.executable, *launcher, "-m", "emspec_torch",
                            *args], env=env, capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-3000:]
    one, many = (read_png(tmp_path / f"{k}.png") for k in ("one", "cards"))
    steps, share = _colormap_steps(many, one)
    print(f"{cards} cards, {channels} ch {extra}: {one.shape}, colormap "
          f"steps {steps}, share {share:.3e}")
    assert many.shape == one.shape and steps <= 1


@pytest.mark.cuda
def test_cuda_bench_timers_and_peaks(cuda):
    """The bench's device timer on the card: a call that waits on the card
    is refused, never timed as a guess; a queue of small launches gives a
    positive time.  The peaks: the data sheet for an H100's name, and the
    measured copy and float32 matmul rates below 105% of it."""
    from emspec_torch.bench.measure import chain_marginal_ms, device_ms
    from emspec_torch.bench.roofline import peaks

    x = torch.ones(1024, device=cuda)
    with pytest.raises(RuntimeError, match="device_ms"):
        device_ms(lambda: x.sum().item(), calls=3)
    assert device_ms(lambda: x.add_(1.0), calls=20) > 0
    assert chain_marginal_ms(lambda c: c * 0.5, lambda: x.clone(),
                             reps=3) > 0
    pk = peaks(cuda)
    print(pk)
    assert pk["name"] == torch.cuda.get_device_name(cuda)
    assert pk["measured_hbm_bytes_s"] > 0 and pk["measured_f32_flops_s"] > 0
    if "H100" in pk["name"] and pk["data_sheet"] is not None:
        assert pk["source"] == "data sheet"
        assert pk["measured_hbm_bytes_s"] <= 1.05 * pk["hbm_bytes_s"]
        assert pk["measured_f32_flops_s"] <= 1.05 * pk["f32_flops_s"]


# ------------------------------------------- equal runs for the file renders
def _cli(tmp_path, *args):
    """``python -m emspec_torch`` in its own process on the card."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-m", "emspec_torch", *args],
                       cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(root)),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.cuda
def test_cuda_file_renders_repeat_and_export_matches_render(cuda, tmp_path):
    """Two processes of ``render`` with the CLI's defaults, and two of
    ``render --multires``, give byte-equal PNGs; ``export --multires``'s
    vis through the colormap is ``render --multires``'s PNG pixel for
    pixel (the sums take B2's sorted route: the same on every run)."""
    from emspec_torch.io.wav import write_wav
    from emspec_torch.post.colormap import apply_lut
    from emspec_torch.render.png import read_png
    from emspec_torch.tables import lut

    write_wav(tmp_path / "in.wav", _tone_noise(48000 * 8, 33), 48000)
    for out, extra in (("d1.png", []), ("d2.png", []),
                       ("m1.png", ["--multires"]), ("m2.png", ["--multires"])):
        _cli(tmp_path, "render", "in.wav", out, *extra)
    _cli(tmp_path, "export", "in.wav", "e.npz", "--multires")
    assert (tmp_path / "d1.png").read_bytes() == \
        (tmp_path / "d2.png").read_bytes()
    assert (tmp_path / "m1.png").read_bytes() == \
        (tmp_path / "m2.png").read_bytes()
    vis = np.load(tmp_path / "e.npz", allow_pickle=False)["vis"]
    rgba = apply_lut(torch.from_numpy(vis.T.copy()),
                     torch.from_numpy(lut("inferno").copy())).numpy()
    assert np.array_equal(rgba.transpose(1, 0, 2)[::-1],
                          read_png(tmp_path / "m1.png"))


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2])
def test_cuda_multires_render_grid_is_the_cpu_sum(cuda, channels):
    """``render_image_multires``'s grid before the post chain (the display
    default, ``exact_sums``): bit-equal on two calls and to the CPU plain
    sum of the same deposits (each cell in (frame, bin) order); one launch
    of B2's sorted tiles a call, none of its global route."""
    from emspec_torch.pipeline import render_image_multires

    pipe = Pipeline(Settings(), cuda)
    p = pipe.params()
    x = np.stack([_tone_noise(48000 * 6, 40 + c) for c in range(channels)])
    xg = torch.from_numpy(x if channels > 1 else x[0]).to(cuda)
    t = pipe.num_columns(xg.shape[-1])
    before = dict(histogram.route_launches)
    g1 = pipe._enhanced_power(xg, t, p, exact_sums=True)
    rises = {k: histogram.route_launches[k] - before[k] for k in before}
    assert rises == {k: int(k == SORTED_TILES) for k in rises}
    assert torch.equal(pipe._enhanced_power(xg, t, p, exact_sums=True), g1)
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xg, t), p)
    ids = pipe._absolute_ids(ids_rel, t, pipe.reach)
    lead = ids.shape[:-2]
    want = histogram_plain(ids.reshape(lead + (-1,)).cpu(),
                           contrib.reshape(lead + (-1,)).cpu(),
                           t * pipe.rows)
    assert torch.equal(g1.reshape(lead + (-1,)).cpu(), want)
    if channels == 1:
        img = render_image_multires(x[0], Settings(), cuda)
        assert np.array_equal(render_image_multires(x[0], Settings(), cuda),
                              img)


LIVE_CELLS = {       # the live phases' settings whose hops B2 sums
    "live": dict(mode="enhanced", multires=False, fft_size=8192),
    "live_2ch": dict(mode="enhanced", multires=False, fft_size=8192,
                     channels=2),
    "direct_live": dict(mode="enhanced", multires=False, fft_size=8192,
                        fft_method="direct", fft_impl="fourstep"),
    "multires_live": {},
    "north_live": dict(mode="enhanced", multires=False, fft_size=32768,
                       hop=800),
    "stress_live": dict(mode="enhanced", multires=False, fft_size=32768,
                        sample_rate=96000, channels=16),
    "wide_live": dict(mode="enhanced", multires=False, fft_size=8192, hop=64),
}


def _live_hop_ids(dev, s: Settings, t: int, seed: int):
    """Hop ``t``'s relative ids and contrib on the card, as the live step
    makes them, and the pipeline."""
    pipe = Pipeline(s, dev)
    x = np.stack([_tone_noise(pipe.n_max + (t + 1) * pipe.hop, seed + c)
                  for c in range(s.channels)])
    x = x[..., t * pipe.hop:t * pipe.hop + pipe.n_max]
    xw = torch.from_numpy(x if s.channels > 1 else x[0]).to(dev)
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_windows(xw),
                                             pipe.params())
    return ids_rel.contiguous(), contrib.contiguous(), pipe


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LIVE_CELLS))
def test_cuda_ring_form_bit_equal_to_cpu_plain(cuda, name):
    """B2's ring form at a live cell's hop (1, 2 or 16 lanes; a tenth of
    the relative ids dropped or out of range, NaN/Inf behind them) into a
    ring of random values, at t from 0 (columns below 0 dropped) past the
    slot wrap: one launch of the ring form, bit-equal to the CPU plain sum
    of ``ring_ids``, finite, the same on a second run, at the plan and at
    every CTA count that fits in each form (a cluster the card holds, and
    the local form)."""
    s = Settings(**LIVE_CELLS[name])
    rel, vals, pipe = _live_hop_ids(cuda, s, 40 if name != "wide_live"
                                    else 140, seed=len(name))
    P, C, k = 2 * pipe.reach + 1, pipe.rows, rel.shape[-1]
    lanes = rel[..., 0].numel()
    rng = np.random.default_rng(len(name))
    pick = torch.from_numpy(rng.random(tuple(rel.shape)) < 0.1).to(cuda)
    far = torch.from_numpy(rng.integers(P * C, 2 * P * C, tuple(rel.shape))
                           .astype(np.int32)).to(cuda)
    rel = torch.where(pick, torch.where(far % 2 == 0, -1, far), rel)
    vals = torch.where(pick, torch.where(far % 3 == 0, float("inf"),
                                         float("nan")), vals)
    base = torch.rand((P,) + rel.shape[:-1] + (C,), device=cuda)
    sizes = [(None, None)] + [
        (c, local) for local in (False, True) for c in (1, 2, 4, 8, 16)
        if ring_plan(k, P, C, c, lanes, local=local)["fits"]
        and (local or ring_occupancy(k, P, C, c, lanes) > 0)]
    for t in sorted({0, 1, pipe.reach, P - 1, P, P + 1, 977}):
        want = histogram_ring_plain(ring_ids(rel.cpu(), t, P, C),
                                    vals.cpu(), base.cpu().clone())
        t_dev = torch.tensor(t, dtype=torch.int32, device=cuda)
        for cluster, local in sizes:
            before = dict(histogram.route_launches)
            got = histogram_ring(rel, vals, base.clone(), t_dev,
                                 cluster=cluster, local=local)
            rises = {k: histogram.route_launches[k] - before[k]
                     for k in before}
            assert rises == {k: int(k == SORTED_RING) for k in rises}
            assert torch.equal(got.cpu(), want), (t, cluster, local)
            assert torch.isfinite(got).all()
            assert torch.equal(histogram_ring(rel, vals, base.clone(), t_dev,
                                              cluster=cluster, local=local),
                               got)


SPLIT_CELLS = {      # live past one CTA: the ring form in windows or bands
    "65536": dict(mode="enhanced", multires=False, fft_size=65536,
                  sample_rate=96000),
    "65536_16ch": dict(mode="enhanced", multires=False, fft_size=65536,
                       sample_rate=96000, channels=16),
    "131072": dict(mode="enhanced", multires=False, fft_size=131072,
                   sample_rate=96000),
    "262144": dict(mode="enhanced", multires=False, fft_size=262144,
                   sample_rate=96000),
    "wide_hop16": dict(mode="enhanced", multires=False, fft_size=8192,
                       hop=16, raster_height=2048),
    "north_hop64": dict(mode="enhanced", multires=False, fft_size=32768,
                        hop=64, raster_height=2048),
    "16384_hop16": dict(mode="enhanced", multires=False, fft_size=16384,
                        hop=16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPLIT_CELLS))
def test_cuda_ring_form_in_windows_and_bands_bit_equal_to_cpu_plain(cuda,
                                                                   name):
    """B2's ring form where a hop's entries or a lane's ring outgrow one
    CTA (above 32768 points: windows; a short hop or a tall raster: bands)
    at a live hop's ids (a tenth dropped or out of range, NaN/Inf behind
    them) into a ring of random values, t from 0 past the slot wrap: one
    launch of the ring form in windows or bands, bit-equal to the CPU
    plain sum of ``ring_ids``, finite, the same on a second run; at the
    plan, at portable clusters of 8 and 4, and with a third of the plan's
    window and three times its bands (launched at that plan through the
    wrapper's private ``_ring_launch``)."""
    from emspec_torch.dsp.kernels.scatter import _ring_launch

    s = Settings(**SPLIT_CELLS[name])
    rel, vals, pipe = _live_hop_ids(cuda, s, 3, seed=len(name))
    P, C, k = 2 * pipe.reach + 1, pipe.rows, rel.shape[-1]
    lanes = rel[..., 0].numel()
    plan = ring_plan_on(cuda, k, P, C, lanes)
    assert plan["fits"] and ring_form(plan) in ("windows", "bands"), plan
    rng = np.random.default_rng(len(name))
    pick = torch.from_numpy(rng.random(tuple(rel.shape)) < 0.1).to(cuda)
    far = torch.from_numpy(rng.integers(P * C, 2 * P * C, tuple(rel.shape))
                           .astype(np.int32)).to(cuda)
    rel = torch.where(pick, torch.where(far % 2 == 0, -1, far), rel)
    vals = torch.where(pick, torch.where(far % 3 == 0, float("inf"),
                                         float("nan")), vals)
    base = torch.rand((P,) + rel.shape[:-1] + (C,), device=cuda)
    forced = [{}, dict(cluster=8), dict(cluster=4),
              dict(cluster=plan["cluster"], local=plan["local"],
                   window=max(1, plan["window"] // 3)),
              dict(cluster=plan["cluster"], local=plan["local"],
                   bands=min(3 * plan["bands"], P))]
    for t in sorted({0, 1, pipe.reach, P - 1, P, P + 1, 977}):
        want = histogram_ring_plain(ring_ids(rel.cpu(), t, P, C),
                                    vals.cpu(), base.cpu().clone())
        t_dev = torch.tensor(t, dtype=torch.int32, device=cuda)
        for kw in forced:
            at = (ring_plan(k, P, C, lanes=lanes, **kw) if "window" in kw
                  or "bands" in kw else ring_plan_on(cuda, k, P, C, lanes,
                                                     **kw))
            assert at["fits"] and ring_form(at) in ("windows", "bands"), kw

            def run(ring):          # a window or bands forced: its plan
                if "window" in kw or "bands" in kw:
                    return _ring_launch(rel, vals, ring, t_dev, at)
                return histogram_ring(rel, vals, ring, t_dev, **kw)
            before = dict(histogram.route_launches)
            forms = dict(histogram.ring_form_launches)
            got = run(base.clone())
            rises = {k: histogram.route_launches[k] - before[k]
                     for k in before}
            assert rises == {k: int(k == SORTED_RING) for k in rises}
            assert {f: histogram.ring_form_launches[f] - n
                    for f, n in forms.items()} == {
                        f: int(f == ring_form(at)) for f in forms}
            assert torch.equal(got.cpu(), want), (t, kw)
            assert torch.isfinite(got).all()
            assert torch.equal(run(base.clone()), got)


@pytest.mark.cuda
@pytest.mark.parametrize("name,seconds", [("65536", 3.0),
                                          ("wide_hop16", 0.3)])
def test_cuda_graphed_stream_in_windows_or_bands_is_process(cuda, name,
                                                            seconds):
    """A graphed default ``Stream`` at 65536 (a hop of 32,769 deposits: the
    ring form in windows) and at 8192, hop 16, 2,048 rows (a ring of 513 ×
    2,048 cells: in bands), fed in 777-sample pushes: one capture, the
    ring form in windows or bands once a hop, its columns the default
    ``process``'s bit for bit in vis and rgba."""
    s = Settings(**SPLIT_CELLS[name])
    x = _tone_noise(int(seconds * s.sample_rate), 57)
    st = Stream(s, cuda, ring_seconds=seconds + 1.0)
    assert st.captures == 1
    forms = dict(histogram.ring_form_launches)
    cols = []
    for i in range(0, x.shape[-1], 777):
        cols += st.push(x[i:i + 777])
    cols += st.flush()
    assert st.captures == 1
    split = sum(histogram.ring_form_launches[f] - forms[f]
                for f in ("windows", "bands"))
    assert split == len(cols) + st.reach        # the flush steps R more
    vis_b, rgba_b, _ = Pipeline(s, cuda).process(x)
    assert torch.equal(torch.stack([c.vis for c in cols]), vis_b)
    assert torch.equal(torch.stack([c.rgba for c in cols]), rgba_b)


def _stream_columns(s, x, dev, chunk=1024):
    st = Stream(s, dev, ring_seconds=x.shape[-1] / s.sample_rate + 1.0)
    assert st.captures == 1
    before = dict(histogram.route_launches)
    cols = []
    for i in range(0, x.shape[-1], chunk):
        cols += st.push(x[..., i:i + chunk])
    cols += st.flush()
    rises = {k: histogram.route_launches[k] - before[k] for k in before}
    assert st.captures == 1
    assert rises == {k: (len(cols) + st.reach) * (k == SORTED_RING)
                     for k in rises}
    return torch.stack([c.vis for c in cols]), \
        torch.stack([c.rgba for c in cols])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, LIVE_CELLS["live"]],
                         ids=["display", "8192"])
def test_cuda_exact_streams_repeat_and_give_the_exact_batch(cuda, kw):
    """Two graphed default ``Stream``s on the same audio give the same
    columns bit for bit, one ring-form launch a hop and no other B2 route,
    and those columns are the default ``process``'s bit for bit (the JAX
    package's streaming ≡ batch)."""
    s = Settings(**kw)
    x = _tone_noise(48000 * 4, 51)
    vis1, rgba1 = _stream_columns(s, x, cuda)
    vis2, rgba2 = _stream_columns(s, x, cuda)
    assert torch.equal(vis1, vis2) and torch.equal(rgba1, rgba2)
    vis_b, rgba_b, _ = Pipeline(s, cuda).process(x)
    assert torch.equal(vis1, vis_b) and torch.equal(rgba1, rgba_b)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, LIVE_CELLS["live"]],
                         ids=["display", "8192"])
def test_cuda_default_stream_repeats_and_ignores_chunking(cuda, kw):
    """The default ``Stream`` on 16 s of audio: two runs bit-equal, and one
    push of the whole signal bit-equal to 777-sample pushes (``atol=0``,
    the JAX package's ``tests/test_stream.py``)."""
    s = Settings(**kw)
    x = _tone_noise(48000 * 16, 53)
    runs = [_stream_columns(s, x, cuda, chunk) for chunk in
            (1024, 1024, x.shape[-1], 777)]
    for vis, rgba in runs[1:]:
        assert torch.equal(vis, runs[0][0]) and torch.equal(rgba, runs[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, LIVE_CELLS["live"]],
                         ids=["display", "8192"])
def test_cuda_default_stream_signal_is_the_default_batch(cuda, kw):
    """``stream_signal`` and ``Pipeline.process`` with no extra argument
    on 16 s of audio: ``vis`` and ``rgba`` equal bit for bit
    (``assert_array_equal``, as the JAX package's ``tests/test_stream.py``
    pins), and two ``process`` calls bit-equal."""
    s = Settings(**kw)
    x = _tone_noise(48000 * 16, 54)
    vis_s, rgba_s = stream_signal(x, s, cuda)
    pipe = Pipeline(s, cuda)
    vis_b, rgba_b, _ = pipe.process(x)
    np.testing.assert_array_equal(vis_s, vis_b.cpu().numpy())
    np.testing.assert_array_equal(rgba_s, rgba_b.cpu().numpy())
    assert torch.equal(pipe.process(x)[0], vis_b)


@pytest.mark.cuda
def test_cuda_time_parallel_render_repeats(nccl_world_1, monkeypatch):
    """``TimeParallelRenderer.render`` at world 1 on the display default:
    its grid before the post chain bit-equal on two calls (B2's sorted
    tiles, one launch a call), and so its columns."""
    from emspec_torch import parallel

    dev = nccl_world_1
    r = parallel.TimeParallelRenderer(
        Settings(), parallel.channel_mesh(axis="t", device=dev))
    grids = []
    power = r.pipe._enhanced_power

    def keep(*args, **kw):
        grids.append(power(*args, **kw))
        return grids[-1]
    monkeypatch.setattr(r.pipe, "_enhanced_power", keep)
    x = _tone_noise(48000 * 4, 52)
    before = histogram.route_launches[SORTED_TILES]
    v1 = r.render(x)[0]
    assert histogram.route_launches[SORTED_TILES] == before + 1
    v2 = r.render(x)[0]
    assert torch.equal(grids[0], grids[1]) and torch.equal(v1, v2)


@pytest.mark.cuda
def test_cuda_north_star_37_minutes_process_is_the_graphed_stream(cuda):
    """The north star (32768, hop 800) on 37 minutes of 48 kHz audio:
    133,160 frames of 16,385 deposits, more than 2^31 a lane.  The batch
    sums through B2's batch form in one launch (its launcher refused the
    lane before), and a graphed default ``Stream`` of the same audio in
    one-second pushes ≡ ``process`` bit for bit in vis and rgba."""
    s = Settings(mode="enhanced", multires=False, fft_size=32768, hop=800)
    x = _tone_noise(37 * 60 * 48000, 60)
    pipe = Pipeline(s, cuda)
    t = pipe.num_columns(x.size)
    assert t * (pipe.n_max // 2 + 1) >= 2**31
    before = dict(histogram.route_launches)
    vis_b, rgba_b, _ = pipe.process(x)
    assert {k: histogram.route_launches[k] - before[k] for k in before} \
        == {k: int(k == SORTED_BATCH) for k in before}
    st = Stream(s, cuda)
    cols = []
    for i in range(0, x.size, 48000):
        cols += st.push(x[i:i + 48000])
    cols += st.flush()
    assert st.captures == 1 and st.dropped_frames == 0
    assert [c.index for c in cols] == list(range(t))
    assert torch.equal(torch.stack([c.vis for c in cols]), vis_b)
    assert torch.equal(torch.stack([c.rgba for c in cols]), rgba_b)


# ------------------------------------------------------------ real FFT
RFFT_SIZES = [1 << b for b in range(8, 19)]          # 256 … 262144


def _rfft_tol(n: int) -> float:
    """DESIGN.md §9's spectrum bound: 2e-5·√(N/512) of the peak."""
    return 2e-5 * math.sqrt(n / 512)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RFFT_SIZES)
def test_cuda_rfft_matches_plain(cuda, n):
    """The real FFT kernel against ``torch.fft.rfft`` (its plain version
    on the card) on 5 frames: the spectrum with no window and with Hann
    within 2e-5·√(N/512)·max|X|, the power form within the same share of
    the peak power, one NaN, +Inf and −Inf frame each scrubbed to 0."""
    from emspec_torch.dsp.kernels.rfft import rfft_frames, rfft_frames_plain
    from emspec_torch.dsp.stft import hann_window

    rng = np.random.default_rng(n)
    fr = torch.from_numpy(rng.standard_normal((5, n)).astype(
        np.float32)).to(cuda)
    hann = hann_window(n, cuda)
    for window in (None, hann):
        got, want = rfft_frames(fr, window), rfft_frames_plain(fr, window)
        assert got.shape == want.shape == (5, n // 2 + 1)
        assert got.dtype == torch.complex64
        assert float((got - want).abs().max()) \
            <= _rfft_tol(n) * float(want.abs().max())
    bad = fr.clone()
    for row, v in ((1, float("nan")), (2, float("inf")), (3, -float("inf"))):
        bad[row, n // 3] = v
    got = rfft_frames(bad, hann, power=True)
    want = rfft_frames_plain(bad, hann, power=True)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1:4], torch.zeros_like(got[1:4]))
    assert float((got - want).abs().max()) <= _rfft_tol(n) * float(want.max())


@pytest.mark.cuda
@pytest.mark.parametrize("n", RFFT_SIZES)
def test_cuda_rfft_frame_bits_do_not_depend_on_the_batch(cuda, n):
    """Frame k of a strided ``unfold`` view of 1,024 frames, of contiguous
    batches of 1, 2, 7 and 100 at several offsets, and transformed alone
    (1-D): bit-equal, as spectrum and as power."""
    from emspec_torch.dsp.kernels.rfft import rfft_frames
    from emspec_torch.dsp.stft import hann_window

    hop = n // 4
    x = torch.from_numpy(np.random.default_rng(n + 1).standard_normal(
        1023 * hop + n).astype(np.float32)).to(cuda)
    fr = frame_signal(x, n, hop)                        # (1024, n) view
    hann = hann_window(n, cuda)
    for power in (False, True):
        ref = rfft_frames(fr, hann, power=power)
        for b in (1, 2, 7, 100):
            for k0 in (0, 5, 1024 - b):
                got = rfft_frames(fr[k0:k0 + b].contiguous(), hann,
                                  power=power)
                assert torch.equal(got, ref[k0:k0 + b]), (b, k0)
        for k in (0, 1, 511, 1023):
            assert torch.equal(rfft_frames(fr[k], hann, power=power), ref[k])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["natural", "direct"])
@pytest.mark.parametrize("n", [4096, 32768, 65536])
def test_cuda_default_engine_stream_is_process(cuda, mode, n):
    """Natural mode and the direct method on the default engine, one bank
    at the sizes where cuFFT's bits moved with the batch (4096, 32768,
    65536): a graphed ``Stream`` ≡ ``process`` bit for bit in ``vis`` and
    ``rgba``, through the real FFT kernel and never cuFFT."""
    from emspec_torch.dsp.kernels.rfft import rfft_frames

    kw = (dict(mode="natural") if mode == "natural"
          else dict(mode="enhanced", fft_method="direct"))
    s = Settings(multires=False, fft_size=n, sample_rate=96000, **kw)
    pipe = Pipeline(s, cuda)
    x = _tone_noise(n + 60 * pipe.hop, 70)
    before = rfft_frames.launches
    vis_b, rgba_b, _ = pipe.process(x)
    assert rfft_frames.launches > before
    vis_s, rgba_s = stream_signal(x, s, cuda, chunk=777)
    np.testing.assert_array_equal(vis_s, vis_b.cpu().numpy())
    np.testing.assert_array_equal(rgba_s, rgba_b.cpu().numpy())


# the real FFT's route "cluster" (csrc/rfft_cluster.cu) against the route
# it replaced at each size: "large" (pack → B4 → unpack) at 65536–262144,
# "block" at 16384 and 32768
RFFT_CLUSTER_SIZES = [16384, 32768, 65536, 131072, 262144]


@pytest.mark.cuda
@pytest.mark.parametrize("n", RFFT_CLUSTER_SIZES)
def test_cuda_rfft_cluster_is_the_parent_route_bit_for_bit(cuda, n):
    """Route "cluster" bit-equal to the parent route at the same N, as a
    spectrum and as Hann power: a strided view of 1,024 frames, its
    contiguous batches of 1, 2, 7 and 100 at three offsets, a frame
    alone, the spectrum without a window; a NaN, +Inf and −Inf frame each
    stored as power 0."""
    from emspec_torch.dsp.kernels.rfft import rfft_frames, route_of
    from emspec_torch.dsp.stft import hann_window

    parent = "large" if n >= 65536 else "block"
    hop = n // 4
    x = torch.from_numpy(np.random.default_rng(n + 2).standard_normal(
        1023 * hop + n).astype(np.float32)).to(cuda)
    fr = frame_signal(x, n, hop)                        # (1024, n) view
    hann = hann_window(n, cuda)
    for window, power in ((None, False), (hann, False), (hann, True)):
        ref = rfft_frames(fr, window, power=power, route=parent)
        got = rfft_frames(fr, window, power=power, route="cluster")
        assert torch.equal(got, ref), (window is None, power)
        if route_of(n) == "cluster":
            assert torch.equal(rfft_frames(fr, window, power=power), ref)
        for b in (1, 2, 7, 100):
            for k0 in (0, 5, 1024 - b):
                part = fr[k0:k0 + b].contiguous()
                assert torch.equal(rfft_frames(part, window, power=power,
                                               route="cluster"),
                                   ref[k0:k0 + b]), (b, k0, power)
        assert torch.equal(rfft_frames(fr[511], window, power=power,
                                       route="cluster"), ref[511])
    bad = fr[:5].clone()
    for row, v in ((1, float("nan")), (2, float("inf")), (3, -float("inf"))):
        bad[row, n // 3] = v
    got = rfft_frames(bad, hann, power=True, route="cluster")
    assert torch.isfinite(got).all()
    assert torch.equal(got[1:4], torch.zeros_like(got[1:4]))
    assert torch.equal(got, rfft_frames(bad, hann, power=True, route=parent))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [512, 8192, 32768, 65536, 262144])
def test_cuda_rfft_narrow_loads_give_the_same_bits(cuda, n, offset):
    """Frames whose start lies off 16 bytes (4- and 8-byte sample loads
    in place of 16-byte ones) and a window off 16 bytes: bit-equal to the
    same frames copied to an aligned tensor, on the default route."""
    from emspec_torch.dsp.kernels.rfft import rfft_frames
    from emspec_torch.dsp.stft import hann_window

    x = torch.from_numpy(np.random.default_rng(n + offset).standard_normal(
        offset + 6 * n).astype(np.float32)).to(cuda)
    fr = frame_signal(x[offset:], n, n // 2)            # 11 frames, off 16 B
    hann = hann_window(n, cuda)
    win = torch.empty(n + offset, device=cuda)[offset:].copy_(hann)
    for window in (None, hann, win):
        for power in (False, True):
            if power and window is None:
                continue
            got = rfft_frames(fr, window, power=power)
            want = rfft_frames(fr.contiguous(), hann if window is not None
                               else None, power=power)
            assert torch.equal(got, want), (window is win, power)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 131072, 262144])
def test_cuda_rfft_default_is_one_launch_of_its_own(cuda, n):
    """At 65536–262144 a default call is one launch of the port's own
    cluster kernel: no pack, no B4, no unpack (counters and the trace)."""
    from torch.profiler import ProfilerActivity, profile

    from emspec_torch.dsp.kernels.rfft import rfft_frames

    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        7 * (n // 4) + n).astype(np.float32)).to(cuda)
    fr = frame_signal(x, n, n // 4)
    rfft_frames(fr)
    torch.cuda.synchronize()
    b4, own = fft4_steps123.launches, dict(rfft_frames.route_launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rfft_frames(fr)
        torch.cuda.synchronize()
    assert fft4_steps123.launches == b4
    assert rfft_frames.route_launches["cluster"] == own["cluster"] + 1
    assert rfft_frames.route_launches["large"] == own["large"]
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.count > 0]
    assert len(names) == 1 and "real_dft_cluster_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("n", RFFT_CLUSTER_SIZES)
def test_cuda_rfft_cluster_occupancy(cuda, n):
    """The card holds at least one cluster of route "cluster"'s plan at
    each size (16 CTAs are non-portable: asked, not assumed)."""
    from emspec_torch.dsp.kernels.rfft import cluster_occupancy

    assert cluster_occupancy(n, cuda) >= 1
