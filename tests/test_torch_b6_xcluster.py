"""Kernel B6's route cluster_large (``emspec_torch/csrc/xcluster.cuh``
``xcluster_kernel<kCopies>`` and ``<kBands>``, built in
``deposits_hist_copies.cu`` and ``deposits_hist_bands.cu``: B1's route
cluster_large with a histogram epilogue, one launch, a frame a cluster of
4, 8, 16 and 16 CTAs at 32768, 65536, 131072 and 262144, its cells a
private copy in each CTA or a band in each) on the CPU, on the mirror of
B1's route in ``tests/test_torch_cluster_large.py``, whose index maps are
imported here.

* ``hist_route_of`` routes by ``(n, num_bins)`` alone: the route takes
  65536–262144 at every cell count it holds and 32768 above the cluster
  route's 6,912 cells (the boundary 6,912 / 6,913 and the north star's
  20,992: 32768 at hop 800, R = 20); the three-launch route takes the
  shapes beyond the copies' cells.  B1 at 32768 stays on its cluster.
* The 32768 plan (four CTAs of 8192 points, (n1, n2) = (128, 128)): the
  plan's rules (rows·W' = cols·Q) and a CTA's shared memory with the
  histogram within 232,448 bytes, against the ``.cu``'s ``xplan``.
* The cells and the syncs: each rank adds the deposits of its own bins
  (every bin once, over the ranks) into its own copy; rank r stores cells
  [r·S/C, (r + 1)·S/C), each the C copies summed in rank order.  The
  kernel's order, read from the ``.cu`` source: the copies zeroed before
  the first cluster sync, added into between the fourth and the fifth,
  read by the peers between the fifth and the sixth, the last; the mirror
  checks that every cell is stored once, after every add that could
  reach it.
* The mirror's histogram (every warp step's lanes through B2's
  ``warp_add`` mirror, ``tests/test_torch_histogram.py``, bins j then
  m − j) within 1e-5 relative per nonzero cell of ``histogram_plain`` of
  the mirror's own deposits, with exact zeros (the card criterion of B6
  against B1 → B2: float32 adds in another order), and within the grid
  rule (``compare_grids``) of plain B6, masked and unmasked, at 32768
  (b = 2, the north star's 20,992 cells), 65536 and 131072 (b = 1).
* Plain B6 against the JAX package's ``fft4_hist`` in interpret mode at
  65536 and b = 2: 3e-5 of the peak cell (as ``tests/test_torch_large.py``
  holds it at 1024).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_cluster_large import _geometry, _mirror, _pairs
from test_torch_deposits_onchip import _case, _signal
from test_torch_histogram import _warp_add

from emspec.config import Settings as JaxSettings
from emspec.dsp.frame import frame_signal as jax_frame_signal
from emspec.dsp.pallas.fft4 import fft4_hist
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.config import Settings
from emspec_torch.dsp.fourstep import _FACTORS
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import (
    CLUSTER_HIST_CELLS, CLUSTER_LARGE_HIST_N, HIST_ROUTES, SMEM_BYTES,
    TWO_CTA_SMEM, cluster_large_bands, cluster_large_hist_cells,
    cluster_large_plan, deposits_hist, deposits_hist_plain, hist_route_of,
    route_of)
from emspec_torch.dsp.kernels.scatter import histogram_plain
from emspec_torch.pipeline import Pipeline
from emspec_torch.validate import compare_grids

CSRC = Path(__file__).resolve().parents[1] / "emspec_torch" / "csrc"
NORTH_CELLS = 41 * 512          # 32768 at hop 800: R = round(32768/1600)


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("n,num_bins,route,bands", [
    (16384, 2560, "block", None),
    (32768, 2560, "cluster", None), (32768, 6912, "cluster", None),
    (32768, 6913, "cluster_large", False),
    (32768, 11008, "cluster_large", False),        # two CTAs an SM
    (32768, 11009, "cluster_large", True),         # ... one: bands
    (32768, NORTH_CELLS, "cluster_large", True),
    (32768, 58112, "cluster_large", True), (32768, 160768, "cluster_large",
                                             True),
    (65536, 1, "cluster_large", False), (65536, 2560, "cluster_large", False),
    (65536, 10496, "cluster_large", False),
    (65536, 10497, "cluster_large", True),
    (131072, 2560, "cluster_large", False),
    (131072, 317440, "cluster_large", True),
    (262144, 640, "cluster_large", False),
    (262144, 2560, "cluster_large", False),
    (262144, 22272, "cluster_large", False),       # one CTA an SM either way
    (262144, 22273, "cluster_large", True),        # copies no longer fit
    (262144, 356352, "cluster_large", True)])
def test_hist_route_of_at_every_size_and_cell_count(n, num_bins, route,
                                                    bands):
    assert hist_route_of(n, num_bins) == route
    if bands is not None:
        assert cluster_large_bands(n, num_bins) == bands
        assert num_bins <= cluster_large_hist_cells(n, bands)


def test_north_star_shape_and_b1_routes():
    pipe = Pipeline(Settings(mode="enhanced", multires=False, fft_size=32768,
                             hop=800), "cpu")
    cells = (2 * pipe.reach + 1) * pipe.rows
    assert (pipe.reach, cells) == (20, NORTH_CELLS)
    assert CLUSTER_HIST_CELLS == 6912 < cells
    assert hist_route_of(32768, cells) == "cluster_large"
    assert route_of(32768) == "cluster"               # B1 keeps its cluster
    assert HIST_ROUTES == ("block", "cluster", "cluster_large", "large")
    assert CLUSTER_LARGE_HIST_N == (32768, 65536, 131072, 262144)


def test_plan_at_32768_and_the_cells_each_size_holds():
    """The 32768 plan: 4 CTAs of 8192 points in 512 threads, (n1, n2) =
    _FACTORS[16384] = (128, 128), W = A = 32, W' = 33, Q = 33; a CTA's
    shared memory with the histogram within 232,448 bytes at every cell
    count the route takes (the north star's 20,992 among them)."""
    g = _geometry(32768)
    assert (g["n1"], g["n2"]) == _FACTORS[16384] == (128, 128)
    assert (g["ctas"], g["threads"], g["points"]) == (4, 512, 8192)
    assert (g["cols"], g["rows"]) == (32, 32)
    assert g["rows"] * g["stride_before"] == g["cols"] * g["stride_after"]
    assert (g["stride_before"], g["stride_after"]) == (33, 33)
    assert g["tile"] == 128 * 33 and g["smem"] == 8 * (512 + 2 * 128 * 33)
    assert 2 * 8 * g["threads"] == g["ctas"] * g["rows"] * g["cols"] * 2
    cells = {n: cluster_large_hist_cells(n, False)
             for n in CLUSTER_LARGE_HIST_N}
    assert cells == {32768: 40192, 65536: 39680, 131072: 39680,
                     262144: 22272}
    for n, c in cells.items():
        plan = cluster_large_plan(n)
        smem = plan["smem"]
        assert smem + 4 * c <= SMEM_BYTES < smem + 4 * (c + 1)
        assert cluster_large_hist_cells(n) == plan["ctas"] * c > 58112
    assert cluster_large_plan(32768)["smem"] + 4 * NORTH_CELLS <= SMEM_BYTES
    # copies at the north star would take one CTA an SM, bands keep two
    assert cluster_large_plan(32768)["smem"] + 4 * NORTH_CELLS > TWO_CTA_SMEM
    assert cluster_large_plan(32768)["smem"] + NORTH_CELLS <= TWO_CTA_SMEM
    assert TWO_CTA_SMEM == 115712
    # the .cu's xplan takes four CTAs and sizes the histogram the same way
    src = (CSRC / "xcluster.cuh").read_text()
    assert "c != 4 && c != 8 && c != 16" in src
    assert "(int)sizeof(float) * cells" in src
    assert "? num_bins : (num_bins + (1 << log2c) - 1) >> log2c" in src
    assert "n < 65536" in (CSRC / "deposits_large.cu").read_text()   # B1
    for design, kind in (("copies", "kCopies"), ("bands", "kBands")):
        b6 = (CSRC / f"deposits_hist_{design}.cu").read_text()
        assert f"xlaunch<{kind}>" in b6 and f"xoccupancy<{kind}>" in b6


def _meta_call(n, rows, reach, route, bands=None):
    meta = torch.empty(2, n, device="meta")
    s = torch.empty((), device="meta")
    return deposits_hist(meta, s, s, s, 0, n=n, hop=n // 4, sr=48000.0,
                         rows=rows, reach=reach, route=route, bands=bands)


@pytest.mark.parametrize("n,rows,reach,route,bands,why", [
    (32768, 512, 40, "cluster_large", False, "holds at most 40192"),
    (262144, 512, 22, "cluster_large", False, "holds at most 22272"),
    (32768, 2048, 40, "cluster_large", None, "holds at most 160768"),
    (16384, 512, 2, "cluster_large", None, "does not take"),
    (65536, 512, 2, "cluster", None, "does not take"),
    (65536, 512, 60, "large", None, "holds at most 58112")])
def test_forced_cluster_large_refused_beyond_its_cells(n, rows, reach,
                                                       route, bands, why):
    with pytest.raises(ValueError, match=why):
        _meta_call(n, rows, reach, route, bands)


def test_route_reaches_the_launch_within_its_cells():
    """Within its cells the route passes every check and stops only at the
    device check (a meta tensor is neither a CPU nor a CUDA tensor), in
    either design; the large route, forced, within its 58,112 cells."""
    for n, rows, reach in ((32768, 512, 20), (65536, 512, 2),
                           (262144, 512, 21), (262144, 2048, 80)):
        for bands in (None, True):
            with pytest.raises(ValueError, match="CPU or CUDA"):
                _meta_call(n, rows, reach, "cluster_large", bands)
    assert hist_route_of(262144, 512 * 161) == "cluster_large"
    with pytest.raises(ValueError, match="CPU or CUDA"):
        _meta_call(262144, 512, 22, "large")


# ------------------------------------------------------ the cells and syncs
def _kernel_body():
    src = (CSRC / "xcluster.cuh").read_text()
    start = src.index("xcluster_kernel(\n    const XArgs a)")
    return src[start:src.index("\nint xlog2(", start)]


def test_kernel_order_of_zeroing_adds_syncs_and_peer_reads():
    """In ``xcluster_kernel``: the cells are zeroed before the first
    cluster sync; the adds (local, or into a peer's band) come after the
    row FFTs' sync (the fourth to run: the exchange's sync runs once for
    each of its two groups) and before the fifth; a band is stored after
    the fifth; the peer copies are read after the fifth and before the
    sixth, the last: no CTA exits while a peer may read its copy."""
    body = _kernel_body()
    syncs = [m.start() for m in re.finditer(r"cluster\.sync\(\);", body)]
    assert len(syncs) == 5                  # the second one runs twice
    loop = body.index("for (int grp = 0; grp < 2; ++grp)")
    assert syncs[0] < loop < syncs[1] < body.index("__syncthreads();", loop)
    zero = body.index("hist[i] = 0.0f")
    adds = [m.start() for m in re.finditer(
        r"hist_add\(in_|atomicAdd\(cell\(id\)|warp_add<", body)]
    peer = body.index("cluster.map_shared_rank(hist + i, p)")
    store = body.index("row[i] = s;")
    band = body.index("row[band_start(S, rank, lc) + i] = hist[i];")
    remote = body.index("cluster.map_shared_rank(hist, owner)")
    assert zero < syncs[0]
    assert len(adds) == 5 and all(syncs[2] < a < syncs[3] for a in adds)
    assert syncs[2] < remote < syncs[3] < band   # bands: adds, sync, store
    assert syncs[3] < peer < store < syncs[4]    # copies: a sixth sync
    assert "hist" not in body[syncs[4]:]


def _slices(S, lc):
    """The cells each rank stores (and, with bands, holds): ``band_start``,
    [r·S/C, (r + 1)·S/C)."""
    return [range((S * r) >> lc, (S * (r + 1)) >> lc) for r in range(1 << lc)]


def _band_of(S, i, lc):
    """``band_of``: ((id + 1)·C − 1) div S."""
    return ((i + 1 << lc) - 1) // S


@pytest.mark.parametrize("S", [1, 15, 2560, 6913, NORTH_CELLS, 22272])
@pytest.mark.parametrize("n", CLUSTER_LARGE_HIST_N)
def test_every_cell_stored_once_by_its_rank(n, S):
    """The slices partition the cells, and ``band_of`` names the rank
    whose band holds each cell (the one that stores it)."""
    g = _geometry(n)
    got = sorted(i for sl in _slices(S, g["lc"]) for i in sl)
    assert got == list(range(S))
    for r, sl in enumerate(_slices(S, g["lc"])):
        assert all(_band_of(S, i, g["lc"]) == r for i in sl)
        assert len(sl) <= -(-S // g["ctas"])


def _b6_mirror(frames, scal, min_id, bands, *, n, rows, reach, **kw):
    """B6 on route cluster_large: B1's mirror gives each bin's deposit;
    each rank's warp steps (32 consecutive pairs, ``_pairs``) add bins j,
    then m − j, through ``_warp_add`` (rank 0 adds the bin m/2 alone) into
    the rank's own copy, or (``bands``) into the band of the rank that
    owns the cell; then each rank stores its slice: the copies summed in
    rank order, or its own band → (hist (b, S), the share of adds that
    crossed the cluster)."""
    g = _geometry(n)
    m, C, lc = g["m"], g["ctas"], g["lc"]
    S = (2 * reach + 1) * rows
    ids, contrib = _mirror(frames, scal, n=n, rows=rows, reach=reach, **kw)
    ids, contrib = ids.numpy(), contrib.numpy()
    b = ids.shape[0]
    copies = np.zeros((C, b, S), np.float32)       # bands: all in copies[0]
    added_by = np.full((b, m + 1), -1)             # the rank that added bin k
    ADD, STORE = 4, 5                              # phases: after sync 4, 5
    add_phase = np.full(S, -1)
    remote = total = 0
    for rank in range(C):
        j = _pairs(g, rank).numpy()
        steps = [j[i:i + 32] for i in range(0, j.size, 32)]
        extra = [np.array([m // 2])] if rank == 0 else []
        for f in range(b):
            for lanes in [k for s in steps for k in (s, m - s)] + extra:
                assert (added_by[f, lanes] == -1).all()
                added_by[f, lanes] = rank
                idv, cv = ids[f, lanes], contrib[f, lanes]
                oks = [bool(idv[i] >= min_id and 0 <= idv[i] < S)
                       for i in range(lanes.size)]
                keys = [int(idv[i]) if oks[i] else ("drop", i)
                        for i in range(lanes.size)]
                for i in range(lanes.size):
                    if oks[i]:
                        add_phase[keys[i]] = ADD
                        total += 1
                        remote += _band_of(S, keys[i], lc) != rank
                dst = copies[0 if bands else rank, f]
                if lanes.size == 32:
                    _warp_add(dst, keys, oks, list(cv), hot_only=False)
                elif oks[0]:                       # bin m/2: one atomicAdd
                    dst[keys[0]] += cv[0]
    assert (added_by >= 0).all()                   # every bin, once
    out = np.zeros((b, S), np.float32)
    store_phase = np.full(S, -1)
    for rank, cells in enumerate(_slices(S, lc)):
        for i in cells:
            s = copies[0, :, i].copy()
            for p in range(1, 1 if bands else C):
                s = (s + copies[p, :, i]).astype(np.float32)
            out[:, i] = s
            assert store_phase[i] == -1
            store_phase[i] = STORE
    assert (store_phase == STORE).all()
    assert (add_phase < store_phase).all()         # stored after every add
    return out, remote / max(total, 1)


def _north_case(b):
    """(b, 32768) frames at hop 800, 48 kHz, 512 rows: 20,992 cells."""
    pipe = Pipeline(Settings(mode="enhanced", multires=False, fft_size=32768,
                             hop=800), "cpu")
    x = _signal((b - 1) * pipe.hop + 32768, 48000, 17)
    p = pipe.params()
    kw = dict(n=32768, hop=pipe.hop, sr=48000.0, rows=pipe.rows,
              reach=pipe.reach)
    return (frame_signal(torch.from_numpy(x), 32768, pipe.hop),
            (p.logmap_a, p.logmap_b, p.power_floor), kw)


_CASES = {"65536": lambda: _case(65536, 1, seed=6),
          "131072": lambda: _case(131072, 1, seed=8),
          "north": lambda: _north_case(2)}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("masked", [False, True], ids=["all", "min_id"])
@pytest.mark.parametrize("bands", [False, True], ids=["copies", "bands"])
def test_mirror_matches_composed_and_plain(case, masked, bands):
    fr, scal, kw = _CASES[case]()
    n, rows, reach = kw["n"], kw["rows"], kw["reach"]
    S = (2 * reach + 1) * rows
    assert hist_route_of(n, S) == "cluster_large"
    assert cluster_large_bands(n, S) == (case == "north")
    min_id = 2 * rows if masked else -2**30
    got, crossed = _b6_mirror(fr, scal, min_id, bands, **kw)
    C = cluster_large_plan(n)["ctas"]
    if bands:                  # a rank's bins reach every band: most cross
        assert crossed > 0.5 * (C - 1) / C
    ids, contrib = _mirror(fr, scal, **kw)            # B1's own deposits
    want = histogram_plain(torch.where(ids >= min_id, ids, -1), contrib,
                           S).numpy()
    nz = want != 0
    assert nz.any() and np.isfinite(got).all() and (got[~nz] == 0).all()
    assert np.max(np.abs(got[nz] - want[nz]) / np.abs(want[nz])) <= 1e-5
    if masked:
        assert (got[:, :min_id] == 0).all()
    plain = deposits_hist_plain(fr, *scal, min_id, **kw)
    b = fr.shape[0]
    cmp = compare_grids(plain.reshape(b, 2 * reach + 1, rows),
                        torch.from_numpy(got).reshape(b, 2 * reach + 1, rows))
    assert cmp.ok, cmp


def test_cpu_tensor_takes_plain_at_every_route():
    fr, scal, kw = _case(65536, 2, seed=2)
    before = (deposits_hist.launches, dict(deposits_hist.route_launches))
    want = deposits_hist_plain(fr, *scal, 256, **kw)
    for route in (None, "cluster_large", "large"):
        assert torch.equal(deposits_hist(fr, *scal, 256, **kw, route=route),
                           want)
    assert (deposits_hist.launches, deposits_hist.route_launches) == before


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("min_id", [-2**30, 2 * 512])
def test_plain_b6_matches_pallas_interpret_at_65536(min_id):
    """Plain B6 vs the TPU kernel ``fft4_hist`` itself (interpret mode) at
    65536 points, b = 2, 512 rows: within 3e-5 of the peak cell."""
    n, hop, rows, t, sr = 65536, 16384, 512, 2, 48000.0
    jp = JaxPipeline(JaxSettings(mode="enhanced", multires=False, fft_size=n,
                                 hop=hop, raster_height=rows))
    p, R = jp.params(), jp.reach
    x = _signal((t - 1) * hop + n, 48000, 23)
    fr = np.asarray(jax_frame_signal(jnp.asarray(x), n, hop))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fft4_hist(jnp.asarray(fr), p.logmap_a, p.logmap_b,
                                    p.power_floor, min_id, n=n, hop=hop,
                                    sr=sr, rows=rows, reach=R))
    got = deposits_hist(torch.from_numpy(np.array(fr)), float(p.logmap_a),
                        float(p.logmap_b), float(p.power_floor), min_id,
                        n=n, hop=hop, sr=sr, rows=rows, reach=R).numpy()
    assert hist_route_of(n, (2 * R + 1) * rows) == "cluster_large"
    assert got.shape == want.shape == (t, (2 * R + 1) * rows)
    scale = max(float(want.max()), 1e-30)
    assert np.abs(got - want).max() / scale < 3e-5
    if min_id > 0:
        assert np.abs(got[:, :min_id]).max() == 0.0
