"""Kernel B6's on-chip routes (``emspec_torch/csrc/deposits.cu``: the block
route for N ≤ 16384 and the two-CTA cluster route at 32768) on the CPU,
extending the mirror of B1 in ``tests/test_torch_deposits_onchip.py``,
whose index maps are imported here: its tiles, its radix steps, its
epilogue and the cluster's split of the bins between its ranks.

* ``hist_route_of`` routes by ``(n, num_bins)`` alone; its 6,912-cell
  limit is 232,448 − ``kClusterSmem``, both read from the ``.cu``
  sources; a forced route is refused above its limit.
* The cluster's store: rank 0 stores cells [0, S/2), rank 1 [S/2, S),
  each its own cell plus the other rank's, every cell once.
* The hot-cell merge: every lane of every warp step (lanes without a bin
  of their own and deposits that miss the histogram offer the dropped key
  ~lane) goes through ``_warp_add`` of ``tests/test_torch_histogram.py``
  (B2's ``warp_add``, merging every step, as B6 calls it), into one
  histogram a block or one a rank, then the cluster's store.  Held to ``histogram_plain`` of the
  mirror's own deposits within 1e-5 relative per nonzero cell with exact
  zeros (the card criterion of B6 against B1 → B2, float32 adds in
  another order), and to plain B6 by ``compare_grids``; on a steady tone
  (hot cells: the merge runs) and on the chirp, at 8192 and 32768, with
  and without ``min_id``.
* At 1024 the mirror's histogram against the JAX package's ``fft4_hist``
  in interpret mode, by ``compare_grids``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_deposits_onchip import (
    THREADS, _case, _epilogue_lanes, _mirror, _route_parts)
from test_torch_histogram import _warp_add

from emspec.config import Settings as JaxSettings
from emspec.dsp.frame import frame_signal as jax_frame_signal
from emspec.dsp.pallas.fft4 import fft4_hist
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.config import Settings
from emspec_torch.dsp.fourstep import _FACTORS
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import (
    CLUSTER_HIST_CELLS, CLUSTER_N, CLUSTER_SMEM, SMEM_BYTES, block_smem,
    deposits_hist, deposits_hist_plain, hist_route_of)
from emspec_torch.dsp.kernels.scatter import histogram_plain
from emspec_torch.pipeline import Pipeline
from emspec_torch.validate import compare_grids

CSRC = Path(__file__).resolve().parents[1] / "emspec_torch" / "csrc"


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("n,num_bins,route", [
    (512, 640, "block"), (8192, 2560, "block"), (16384, 2560, "block"),
    (32768, 2560, "cluster"), (32768, 6912, "cluster"),
    (32768, 6913, "cluster_large"), (32768, 20992, "cluster_large"),
    (65536, 2560, "cluster_large"), (262144, 640, "cluster_large")])
def test_hist_route_of_by_shape_only(n, num_bins, route):
    assert hist_route_of(n, num_bins) == route


def test_cluster_cell_limit_matches_the_sources():
    """6,912 float cells fit beside the cluster route's table, tile and
    staged columns: (kMaxSmem − kClusterSmem) / 4, read from the .cu."""
    src = (CSRC / "deposits.cu").read_text()
    radix = (CSRC / "radix_common.cuh").read_text()

    def const(text, name):
        return re.search(rf"constexpr int {name} =\s*([^;]+);", text,
                         re.S).group(1)

    table = 1 << int(const(radix, "kLog2Table"))
    assert const(radix, "kTable").strip() == "1 << kLog2Table"
    expr = (const(src, "kClusterSmem").split("\n")[-1]
            .replace("(int)sizeof(float2)", "8").replace("kTable", str(table))
            .replace("kStageStride", const(src, "kStageStride")))
    smem = eval(expr, {})                               # integer arithmetic
    assert int(const(src, "kMaxSmem")) == SMEM_BYTES == 232448
    assert smem == CLUSTER_SMEM == 204800
    assert _FACTORS[CLUSTER_N // 2] == (128, 128)      # the tile's 128 × 129
    assert CLUSTER_HIST_CELLS == (232448 - smem) // 4 == 6912
    assert "(kMaxSmem - kClusterSmem) / (int)sizeof(float)" in const(
        src, "kClusterHistCells")
    assert 5 * 512 <= CLUSTER_HIST_CELLS          # the stress configuration


def _meta_call(n, rows, reach, route):
    meta = torch.empty(2, n, device="meta")
    s = torch.empty((), device="meta")
    return deposits_hist(meta, s, s, s, 0, n=n, hop=n // 4, sr=48000.0,
                         rows=rows, reach=reach, route=route)


@pytest.mark.parametrize("n,rows,reach,route,why", [
    (32768, 1383, 2, "cluster", "holds at most 6912"),     # 6,915 cells
    (32768, 512, 2, "block", "does not take"),
    (8192, 512, 2, "cluster", "does not take"),
    (8192, 512, 2, "large", "does not take"),
    (16384, 512, 40, "block", "holds at most"),            # 41,472 cells
    (65536, 512, 60, "large", "holds at most 58112"),      # 61,952 cells
    (32768, 512, 2, "radix2", "not in")])
def test_forced_route_refused_above_its_limit(n, rows, reach, route, why):
    with pytest.raises(ValueError, match=why):
        _meta_call(n, rows, reach, route)


def test_forced_routes_within_their_limits_reach_the_launch():
    """At the limit each route passes its checks and stops only at the
    device check (a meta tensor is neither a CPU nor a CUDA tensor)."""
    assert (232448 - block_smem(8192)) // 4 >= 5 * 512
    for n, rows, reach, route in ((32768, 768, 4, "cluster"),   # 6,912
                                  (32768, 512, 2, "large"),
                                  (8192, 512, 2, "block")):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            _meta_call(n, rows, reach, route)


# ------------------------------------------------------- the cluster's store
def _store_cells(rank, S):
    """The cells rank ``rank`` stores, thread by thread (512 threads)."""
    half = S >> 1
    c0, c1 = (0, half) if rank == 0 else (half, S)
    return [list(range(c0 + t, c1, THREADS)) for t in range(THREADS)]


def _cluster_store(h0, h1):
    """Each rank stores its half: its own cell plus the other's (float32)."""
    S = h0.shape[-1]
    out = np.full(h0.shape, np.nan, np.float32)
    hs = (h0, h1)
    for rank in (0, 1):
        for cells in _store_cells(rank, S):
            out[..., cells] = hs[rank][..., cells] + hs[1 - rank][..., cells]
    return out


@pytest.mark.parametrize("S", [1, 645, 2560, 5 * 1383 - 3, 6912])
def test_cluster_store_writes_every_cell_once(S):
    written = [c for rank in (0, 1) for cells in _store_cells(rank, S)
               for c in cells]
    assert sorted(written) == list(range(S))            # once each
    rng = np.random.default_rng(S)
    h0, h1 = (rng.random((2, S)).astype(np.float32) for _ in range(2))
    out = _cluster_store(h0, h1)
    assert np.array_equal(out, h0 + h1)                 # a + b == b + a


# ------------------------------------------------------ the hot-cell merge
def _tone_case(n, b):
    """(b, n) frames of a steady 1 kHz tone in 1e-4 noise, at the
    settings of ``_case``: its bins near the tone all land on one cell."""
    sr = 96000
    pipe = Pipeline(Settings(mode="enhanced", multires=False, fft_size=n,
                             sample_rate=sr, raster_height=128,
                             smoothing=0.3), "cpu")
    samples = (b - 1) * pipe.hop + n
    rng = np.random.default_rng(n % 71)
    x = (np.sin(2 * np.pi * 1000.0 * np.arange(samples) / sr)
         + 1e-4 * rng.standard_normal(samples)).astype(np.float32)
    p = pipe.params()
    kw = dict(n=n, hop=pipe.hop, sr=float(sr), rows=pipe.rows,
              reach=pipe.reach)
    return (frame_signal(torch.from_numpy(x), n, pipe.hop),
            (p.logmap_a, p.logmap_b, p.power_floor), kw)


def _b6_mirror(frames, scal, min_id, *, n, rows, reach, **kw):
    """B6 on its route at n: every warp step's 32 lanes through
    ``_warp_add`` (every step merged) into a histogram a block (block) or
    a rank (cluster), then the cluster's store → (hist (b, S), warp steps
    whose live lanes shared a cell)."""
    S = (2 * reach + 1) * rows
    parts, (l1, l2) = _route_parts(frames, n=n)
    b = frames.shape[0]
    hs = {}
    merged = 0
    for rank, zx, zy, k0, k1, warps in parts:
        K, own, ids, contrib = _epilogue_lanes(
            zx, zy, k0, k1, warps, scal, n=n, l1=l1, l2=l2, rows=rows,
            reach=reach, **kw)
        ids, contrib = ids.numpy(), contrib.numpy()
        lands = ((ids >= min_id) & (ids >= 0) & (ids < S)
                 & own.numpy()[None])
        h = hs.setdefault(rank, np.zeros((b, S), np.float32))
        for f in range(b):
            for r in range(K.shape[0]):
                oks = [bool(o) for o in lands[f, r]]
                keys = [int(ids[f, r, lane]) if oks[lane] else ("drop", lane)
                        for lane in range(32)]
                live = [k for k, o in zip(keys, oks) if o]
                merged += len(set(live)) < len(live)
                _warp_add(h[f], keys, oks, list(contrib[f, r]),
                          hot_only=False)
    if len(hs) == 1:
        return hs[0], merged
    return _cluster_store(hs[0], hs[1]), merged


_SIGNALS = {"tone": _tone_case, "chirp": lambda n, b: _case(n, b, seed=7)}


@pytest.mark.parametrize("n,b", [(8192, 2), (32768, 1)])
@pytest.mark.parametrize("signal", sorted(_SIGNALS))
@pytest.mark.parametrize("masked", [False, True], ids=["all", "min_id"])
def test_hot_cell_merge_matches_composed(n, b, signal, masked):
    fr, scal, kw = _SIGNALS[signal](n, b)
    rows, reach = kw["rows"], kw["reach"]
    S = (2 * reach + 1) * rows
    assert hist_route_of(n, S) == ("block" if n == 8192 else "cluster")
    min_id = 2 * rows if masked else -2**30
    got, merged = _b6_mirror(fr, scal, min_id, **kw)
    if signal == "tone":
        assert merged > 0                  # lanes of a step shared a cell
    ids, contrib = _mirror(fr, scal, **kw)            # B1's own deposits
    want = histogram_plain(torch.where(ids >= min_id, ids, -1), contrib,
                           S).numpy()
    nz = want != 0
    assert np.isfinite(got).all() and (got[~nz] == 0).all()
    assert np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])) <= 1e-5
    if masked:
        assert (got[:, :min_id] == 0).all()
    plain = deposits_hist_plain(fr, *scal, min_id, **kw)
    cmp = compare_grids(plain.reshape(b, 2 * reach + 1, rows),
                        torch.from_numpy(got).reshape(b, 2 * reach + 1, rows))
    assert cmp.ok, cmp


@pytest.mark.parametrize("min_id", [-2**30, 2 * 128])
def test_mirror_hist_matches_pallas_interpret(min_id):
    """The block route's B6 mirror against the TPU kernel itself
    (interpret mode), n = 1024, as histograms."""
    n, hop, rows, t, sr = 1024, 256, 128, 3, 48000.0
    jp = JaxPipeline(JaxSettings(mode="enhanced", multires=False, fft_size=n,
                                 hop=hop, raster_height=rows))
    p, R = jp.params(), jp.reach
    rng = np.random.default_rng(21)
    tt = np.arange((t - 1) * hop + n) / 48000.0
    x = (np.sin(2 * np.pi * (300.0 * tt + 4000.0 * tt * tt))
         + 0.3 * np.sin(2 * np.pi * 880.0 * tt)
         + 0.01 * rng.standard_normal(tt.size)).astype(np.float32)
    fr = np.asarray(jax_frame_signal(jnp.asarray(x), n, hop))
    with pltpu.force_tpu_interpret_mode():
        want = np.array(fft4_hist(jnp.asarray(fr), p.logmap_a, p.logmap_b,
                                    p.power_floor, min_id, n=n, hop=hop,
                                    sr=sr, rows=rows, reach=R))
    scal = tuple(torch.tensor(np.float32(v)) for v in
                 (p.logmap_a, p.logmap_b, p.power_floor))
    got, _ = _b6_mirror(torch.from_numpy(np.array(fr)), scal, min_id, n=n,
                        hop=hop, sr=sr, rows=rows, reach=R)
    P = 2 * R + 1
    assert got.shape == want.shape == (t, P * rows)
    cmp = compare_grids(torch.from_numpy(want).reshape(t, P, rows),
                        torch.from_numpy(got).reshape(t, P, rows))
    assert cmp.ok, cmp
    if min_id > 0:
        assert (got[:, :min_id] == 0).all()
