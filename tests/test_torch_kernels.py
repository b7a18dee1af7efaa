"""The port's kernel modules: plain versions against the JAX package on
the CPU, device routing of the wrappers, and (on a card only, marker
``cuda``) each CUDA kernel against its plain version.

Quantized deposits are compared as histograms (DESIGN.md §9): total
energy ≤ 1e-4 relative and 3×3 max-filters within 1e-3·peak on all but
1e-4 of the cells — a half-ulp difference in Δt/hop or log2 f̂ between
XLA's and torch's float32 math moves a whole deposit one cell."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from emspec.config import Settings
from emspec.dsp.frame import frame_signal as jax_frame_signal
from emspec.dsp.pallas.fft4 import fft4_deposits
from emspec.dsp.pallas.scatter import histogram_matmul, histogram_reference
from emspec.io import synth
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch import kernels_build
from emspec_torch.dsp.frame import frame_signal, num_frames
from emspec_torch.dsp.kernels.deposits import (
    deposits_ids, deposits_ids_plain, supported)
from emspec_torch.dsp.kernels.lut import lut_lookup, lut_lookup_plain
from emspec_torch.dsp.kernels.scatter import histogram, histogram_plain
from emspec_torch.validate import compare_grids


# ------------------------------------------------------------ B2 histogram
@pytest.mark.parametrize("b,m,s", [(1, 1000, 300), (3, 517, 257), (4, 64, 2560)])
def test_histogram_plain_matches_reference_and_pallas(b, m, s):
    """Plain B2 vs segment_sum (float32, same add order: ≤1e-6 rel) and
    vs interpret-mode histogram_matmul(passes=3) (f32-exact split)."""
    rng = np.random.default_rng(b * 7 + s)
    ids = rng.integers(-3, s + 3, (b, m)).astype(np.int32)
    vals = rng.uniform(0, 1, (b, m)).astype(np.float32)
    bad = ids < 0
    vals[bad] = np.where(rng.uniform(size=bad.sum()) < 0.5, np.nan, np.inf)
    want = np.asarray(histogram_reference(jnp.asarray(ids), jnp.asarray(vals), s))
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(histogram_matmul(jnp.asarray(ids), jnp.asarray(vals),
                                          s, m_chunk=256, passes=3))
    got = histogram(torch.from_numpy(ids), torch.from_numpy(vals), s).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pal, rtol=1e-6, atol=1e-6)


def test_histogram_dropped_ids_survive_nonfinite_vals():
    ids = torch.tensor([0, -1, 2, -1, 4], dtype=torch.int32)
    vals = torch.tensor([1.0, np.inf, 2.0, np.nan, np.nan])
    got = histogram(ids, vals, 4)
    np.testing.assert_array_equal(got.numpy(), [1.0, 0.0, 2.0, 0.0])


# ------------------------------------------------------------- B1 deposits
def _frames(n, hop, t, seed):
    rng = np.random.default_rng(seed)
    sec = ((t - 1) * hop + n) / 48000.0
    x = (synth.chirp(150.0, 9000.0, sec) + synth.multitone([440.0, 1250.0], sec,
                                                          amplitude=0.3)
         + 0.05 * rng.standard_normal(int(round(sec * 48000)))).astype(np.float32)
    return x


def _jax_pipeline(n, hop, rows):
    jp = JaxPipeline(Settings(mode="enhanced", multires=False, fft_size=n,
                              hop=hop, raster_height=rows))
    return jp, jp.params()


def _jax_deposit_hist(n, hop, rows, x):
    """JAX unfused chain (Pipeline._deposits) + id packing, histogrammed
    (jitted: one compile instead of eager per-op dispatch)."""
    jp, p = _jax_pipeline(n, hop, rows)
    R = jp.reach
    P = 2 * R + 1

    def hist(x, p):
        row, delta, contrib = jp._deposits([jax_frame_signal(x, n, hop)], p)
        return histogram_reference((delta + R) * rows + row, contrib, P * rows)

    h = np.array(jax.jit(hist)(jnp.asarray(x), p))
    return p, R, h.reshape(-1, P, rows)


@pytest.mark.parametrize("n,hop,rows,t", [(1024, 256, 128, 24),
                                          (8192, 2048, 512, 6)])
def test_deposits_plain_matches_jax_unfused(n, hop, rows, t):
    x = _frames(n, hop, t, seed=n)
    p, R, want = _jax_deposit_hist(n, hop, rows, x)
    fr = frame_signal(torch.from_numpy(x), n, hop)
    ids, contrib = deposits_ids(
        fr, torch.tensor(np.asarray(p.logmap_a)),
        torch.tensor(np.asarray(p.logmap_b)),
        torch.tensor(np.asarray(p.power_floor)),
        n=n, hop=hop, sr=48000.0, rows=rows, reach=R)
    assert ids.shape == contrib.shape == (t, n // 2 + 1)
    assert ids.dtype == torch.int32
    got = histogram(ids, contrib, (2 * R + 1) * rows).reshape(want.shape)
    cmp = compare_grids(torch.from_numpy(want), got)
    assert cmp.ok, cmp


def test_deposits_plain_matches_pallas_interpret():
    """Plain B1 vs the TPU kernel itself (interpret mode), n = 1024."""
    n, hop, rows, t = 1024, 256, 128, 8
    x = _frames(n, hop, t, seed=3)
    jp, p = _jax_pipeline(n, hop, rows)
    R = jp.reach
    fr_np = np.asarray(jax_frame_signal(jnp.asarray(x), n, hop))
    with pltpu.force_tpu_interpret_mode():
        ids_j, c_j = fft4_deposits(jnp.asarray(fr_np), p.logmap_a, p.logmap_b,
                                   p.power_floor, n=n, hop=hop, sr=48000.0,
                                   rows=rows, reach=R)
    P = 2 * R + 1
    want = np.array(histogram_reference(ids_j, c_j, P * rows))
    ids, contrib = deposits_ids_plain(
        torch.from_numpy(fr_np), float(p.logmap_a), float(p.logmap_b),
        float(p.power_floor), n=n, hop=hop, sr=48000.0, rows=rows, reach=R)
    got = histogram_plain(ids, contrib, P * rows)
    cmp = compare_grids(torch.from_numpy(want).reshape(t, P, rows),
                        got.reshape(t, P, rows))
    assert cmp.ok, cmp


# ------------------------------------------------------------ routing
def test_wrappers_route_cpu_to_plain_without_launching():
    before = (deposits_ids.launches, histogram.launches, lut_lookup.launches)
    x = torch.from_numpy(_frames(512, 128, 4, seed=1))
    fr = frame_signal(x, 512, 128)
    s = torch.tensor(np.float32(1.0))
    deposits_ids(fr, s, s, s, n=512, hop=128, sr=48000.0, rows=64, reach=2)
    histogram(torch.zeros(3, 5, dtype=torch.int32), torch.ones(3, 5), 7)
    lut_lookup(torch.zeros(4, dtype=torch.int32),
               torch.zeros(256, 4, dtype=torch.uint8))
    assert (deposits_ids.launches, histogram.launches,
            lut_lookup.launches) == before


def test_wrappers_raise_on_other_devices():
    """Neither CPU nor CUDA: no silent fallback, a clear error."""
    meta = torch.empty(4, 512, device="meta")
    s = torch.empty((), device="meta")
    with pytest.raises(ValueError, match="deposits_ids"):
        deposits_ids(meta, s, s, s, n=512, hop=128, sr=48000.0, rows=64,
                     reach=2)
    with pytest.raises(ValueError, match="histogram"):
        histogram(torch.empty(2, 3, dtype=torch.int32, device="meta"),
                  torch.empty(2, 3, device="meta"), 4)
    with pytest.raises(ValueError, match="lut_lookup"):
        lut_lookup(torch.empty(3, dtype=torch.int32, device="meta"),
                   torch.empty(256, 4, dtype=torch.uint8, device="meta"))


def test_supported_sizes():
    assert [n for n in (256, 512, 1000, 8192, 16384, 32768) if supported(n)] \
        == [512, 8192, 16384]


def test_frame_signal_view_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 5000)).astype(np.float32)
    got = frame_signal(torch.from_numpy(x), 1024, 300)
    want = np.asarray(jax_frame_signal(jnp.asarray(x), 1024, 300))
    assert got.shape == want.shape == (2, num_frames(5000, 1024, 300), 1024)
    np.testing.assert_array_equal(got.numpy(), want)
    assert frame_signal(torch.zeros(100), 1024, 256).shape == (0, 1024)


def test_library_path_keyed_by_sources(tmp_path, monkeypatch):
    for src in kernels_build._sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels_build, "SRC_DIR", tmp_path)
    before = kernels_build.library_path()
    (tmp_path / "lut.cu").write_text((tmp_path / "lut.cu").read_text() + "\n")
    assert kernels_build.library_path() != before
    assert before.parent == kernels_build.BUILD_DIR
    assert "--use_fast_math" not in kernels_build.NVCC_FLAGS


# ------------------------------------------------- on the card (marker cuda)
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_deposits_kernel_matches_plain(cuda):
    n, hop, rows, R = 8192, 2048, 512, 2
    x = torch.from_numpy(_frames(n, hop, 40, seed=9)).to(cuda)
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
