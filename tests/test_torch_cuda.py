"""The port's CUDA kernels against their plain PyTorch versions, on a card
only (marker ``cuda``; each test skips without one).

This file imports nothing of JAX or the JAX package, so it runs on the
machine with the card, which has no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the rest of the
suite).  Tolerances: quantized grids through ``compare_grids``; B2 1e-5
relative; B3 and B5 bit-equal; B4 2e-5·max|X| (the JAX package's four-step
bound)."""

import numpy as np
import pytest
import torch

from emspec_torch.dsp import fourstep
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import deposits_ids, deposits_ids_plain
from emspec_torch.dsp.kernels.fourstep import (
    fft4_steps123, fft4_steps123_plain)
from emspec_torch.dsp.kernels.lut import lut_lookup, lut_lookup_plain
from emspec_torch.dsp.kernels.scatter import histogram, histogram_plain
from emspec_torch.dsp.kernels.window import (
    windowed_frames, windowed_frames_plain)
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
@pytest.mark.parametrize("shape", [(7, 512), (2, 5, 512), (372, 8192), (512,)])
def test_cuda_window_kernel_bit_equal(cuda, shape):
    frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32)).to(cuda)
    assert torch.equal(windowed_frames(frames), windowed_frames_plain(frames))
    fr = frame_signal(frames.reshape(-1), 256, 64)
    assert torch.equal(windowed_frames(fr), windowed_frames_plain(fr))
