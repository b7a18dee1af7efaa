"""The port's CUDA kernels against their plain PyTorch versions, on a card
only (marker ``cuda``; each test skips without one).

This file imports nothing of JAX or the JAX package, so it runs on the
machine with the card, which has no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the rest of the
suite).  Tolerances: quantized grids through ``compare_grids``; B1's
large-frame route also ≥ 99.99% equal ids, other valid deposits moved one
cell, bins 0 and N/2 exact, contrib within 1e-5·peak; B2, B6 (against
B1 → B2 composed) and the probe's ``full`` 1e-5 relative per nonzero bin;
the other probe variants against their own plain versions, 1e-5; B3 and
B5 bit-equal; B4 2e-5·max|X| (the JAX package's four-step bound)."""

import numpy as np
import pytest
import torch

from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import (
    deposits_hist, deposits_hist_plain, deposits_ids, deposits_ids_large,
    deposits_ids_plain)
from emspec_torch.dsp.kernels.fourstep import (
    SMALL_MAX, fft4_steps123, fft4_steps123_plain)
from emspec_torch.dsp.kernels.lut import lut_lookup, lut_lookup_plain
from emspec_torch.dsp.kernels.scatter import histogram, histogram_plain
from emspec_torch.dsp.kernels.window import (
    windowed_frames, windowed_frames_plain)
from emspec_torch.probes.scatter_ablation import (
    VARIANTS, hist_variant, hist_variant_plain)
from emspec_torch.validate import compare_grids


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


def _scalars(cuda, rows, sr):
    return [torch.tensor(np.float32(v), device=cuda)
            for v in (np.log2(20.0),
                      (rows - 1) / (np.log2(sr / 2.0) - np.log2(20.0)), 1e-12)]


def _b1_case(cuda, n, b, rows=512, sr=96000.0):
    hop = n // 4
    x = torch.from_numpy(_tone_noise((b - 1) * hop + n, n % 101)).to(cuda)
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=2)
    return frame_signal(x, n, hop), _scalars(cuda, rows, sr), kw


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 65536, 131072, 262144])
@pytest.mark.parametrize("b", [1, 3])
def test_cuda_deposits_large_route_matches_plain(cuda, n, b):
    fr, sc, kw = _b1_case(cuda, n, b)
    before = (deposits_ids.launches, deposits_ids_large.launches)
    ik, ck = deposits_ids(fr, *sc, **kw)
    assert (deposits_ids.launches, deposits_ids_large.launches) == (
        before[0], before[1] + 1)
    ip, cp = deposits_ids_plain(fr, *sc, **kw)
    rows, S = kw["rows"], 5 * kw["rows"]
    cmp = compare_grids(histogram_plain(ip, cp, S).cpu(),
                        histogram_plain(ik, ck, S).cpu())
    assert cmp.ok, cmp
    vk, vp = ck > 0, cp > 0
    both = vk & vp
    agree = (both & (ik == ip)) | (~vk & ~vp)
    assert float(agree.float().mean()) >= 0.9999
    moved = (ik - ip).abs()[both & (ik != ip)]
    assert bool(torch.isin(moved, torch.tensor(
        [1, rows - 1, rows, rows + 1], device=cuda)).all())
    assert bool(agree[:, [0, n // 2]].all())
    assert bool((ik[~vk] == -1).all())
    assert float((ck - cp)[both].abs().max()) <= 1e-5 * float(cp.max())


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
