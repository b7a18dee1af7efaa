"""The port's CUDA kernels against their plain PyTorch versions, on a card
only (marker ``cuda``; each test skips without one).

This file imports nothing of JAX or the JAX package, so it runs on the
machine with the card, which has no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the rest of the
suite).  Tolerances: quantized grids through ``compare_grids``; B1 (each
route) also ≥ 99.99% equal ids, other valid deposits moved one cell,
bins 0 and N/2 exact, contrib within 1e-5·peak, and b = 1 (a live hop)
bit-equal to frame 0 of a batch; B2, B6 (against
B1 → B2 composed) and the probe's ``full`` 1e-5 relative per nonzero bin;
the other probe variants against their own plain versions, 1e-5; B3 and
B5 bit-equal; B4 2e-5·max|X| (the JAX package's four-step bound); B2's
two routes, each forced, also exact zeros, and a path above a block's shared
memory against the port's CPU path at PERF.md §2's tolerances, its
stream ≡ its batch within 1e-5 in ``vis``."""

import numpy as np
import pytest
import torch

from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import (
    cluster_occupancy, deposits_hist, deposits_hist_plain, deposits_ids,
    deposits_ids_cluster, deposits_ids_large, deposits_ids_plain, route_of)
from emspec_torch.dsp.kernels.fourstep import (
    SMALL_MAX, fft4_steps123, fft4_steps123_plain)
from emspec_torch.dsp.kernels.lut import lut_lookup, lut_lookup_plain
from emspec_torch import Settings
from emspec_torch.dsp.kernels.scatter import (
    ROUTES, SMEM_BINS, histogram, histogram_plain)
from emspec_torch.dsp.kernels.scatter import route_of as hist_route_of
from emspec_torch.dsp.kernels.window import (
    windowed_frames, windowed_frames_plain)
from emspec_torch.pipeline import Pipeline
from emspec_torch.probes.scatter_ablation import (
    VARIANTS, hist_variant, hist_variant_plain)
from emspec_torch.stream import stream_signal
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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8192, 16384, 32768, 262144])
@pytest.mark.parametrize("masked", [False, True])
def test_cuda_deposits_hist_matches_composed(cuda, n, masked):
    """B6 against B1 → B2 on the same frames: 1e-5 relative per nonzero
    bin, exact zeros below min_id."""
    fr, sc, kw = _b1_case(cuda, n, 3)
    S = 5 * kw["rows"]
    min_id = 2 * kw["rows"] if masked else -2**30
    before = deposits_hist.launches
    got = deposits_hist(fr, *sc, min_id, **kw)
    assert deposits_hist.launches == before + 1 and got.shape == (3, S)
    ids, contrib = deposits_ids(fr, *sc, **kw)
    want = histogram(torch.where(ids >= min_id, ids, -1), contrib, S)
    nz = want > 0
    assert float(((got - want).abs()[nz] / want[nz]).max()) <= 1e-5
    assert bool((got[~nz] == 0).all())
    if masked:
        assert float(got[:, :min_id].abs().max()) == 0.0
    plain = deposits_hist_plain(fr, *sc, min_id, **kw)
    cmp = compare_grids(plain.reshape(3, 5, -1).cpu(),
                        got.reshape(3, 5, -1).cpu())
    assert cmp.ok, cmp


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_cuda_probe_variants(cuda, variant):
    """Each variant against its own plain version; ``full`` against B2."""
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 2560, (37, 16512)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.5] = -1
    ids = torch.from_numpy(ids).to(cuda)
    vals = torch.from_numpy(rng.random((37, 16512)).astype(np.float32)).to(cuda)
    got = hist_variant(ids, vals, 2560, variant)
    want = hist_variant_plain(ids, vals, 2560, variant)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if variant == "full":
        torch.testing.assert_close(got, histogram(ids, vals, 2560),
                                   rtol=1e-5, atol=1e-5)


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
    on the card through B2's global route (``scatter="auto"``), match the
    CPU path, and stream as they batch."""
    s = Settings(mode="enhanced", multires=False, **kw)
    gpu, cpu = Pipeline(s, cuda), Pipeline(s, "cpu")
    assert (2 * gpu.reach + 1) * gpu.rows == cells and gpu.use_relative_scatter
    x = _tone_noise(s.fft_size + 40 * gpu.hop, 12)
    before = dict(histogram.route_launches)
    vis_g, _, _ = gpu.process(x)
    assert histogram.route_launches["global"] > before["global"]
    assert histogram.route_launches["row"] == before["row"]
    t = gpu.num_columns(x.shape[-1])
    cmp = compare_grids(cpu._enhanced_power(cpu.to_device(x), t, cpu.params()),
                        gpu._enhanced_power(gpu.to_device(x), t,
                                            gpu.params()).cpu())
    assert cmp.ok, cmp
    ok, worst, share = compare_vis(cpu.process(x)[0], vis_g.cpu())
    assert ok, (worst, share)
    vis_s, _ = stream_signal(x, s, cuda, chunk=3000)
    assert float(np.abs(vis_s - vis_g.cpu().numpy()).max()) <= 1e-5
