"""Kernel B2's sorted route, its tiles form (``csrc/histogram.cu``
``tiles_kernel``), mirrored in numpy on the CPU: ``tile_plan``'s grid,
the block's walk over the frames that reach its tile, piece by piece —
whole frames a piece where they fit, else a frame in several (each
piece's keys, values and chunk masks staged) — each warp's band of
cells, and the in-frame collision rule — the lanes of one cell grouped
(the claim word's OR), the group's lowest lane adding the values one
after another in lane order.  Held bit for bit (tolerance 0) against the
plain version (``histogram_plain``: ``index_add_``, each cell in deposit
order) on seeded raster-like ids with ids of −1, hot cells and R = 0, 1,
2 and 8, on the raster's own ids (``reassigned_bins``), adding into an
output, and with a column cut into row tiles; every cell of the grid is
written once.  The form with K deposits a frame into columns of C ≠ K
cells (the display pipeline's file renders) is held the same way in
``tests/test_torch_exact_sums.py``, through this mirror.  The values are chosen so that another order of the adds
gives other bits (checked), so the mirror's equality tests the order."""

import numpy as np
import pytest
import torch

from emspec_torch.dsp.kernels.scatter import (
    PIECE_CHUNKS, SMEM_BINS, SORTED, SORTED_TILES, TILE_CELLS, TILE_WARPS,
    histogram, histogram_plain, tile_plan)
from emspec_torch.dsp.reassign import (
    reassigned_bins, reassignment_corrections, scatter_segment_sum)
from emspec_torch.dsp.stft import stft_triple


def _tiles_mirror(ids, vals, K, R, out=None, tile_cols=None, C=None):
    """``tiles_kernel`` in numpy float32, its loops and index expressions
    verbatim → (out, times each cell was stored): frames of K deposits
    into columns of C cells (K by default)."""
    C = C or K
    lead = ids.shape[:-1]
    M = ids.shape[-1]
    T = M // K
    ids2 = ids.reshape(-1, M).numpy()
    vals2 = vals.reshape(-1, M).numpy().astype(np.float32)
    res = (np.zeros((ids2.shape[0], T * C), np.float32) if out is None
           else out.reshape(-1, T * C).numpy().astype(np.float32).copy())
    stored = np.zeros(res.shape, np.int64)
    plan = tile_plan(T, K, R, tile_cols, column=C)
    TT, FF, pc = plan["cols"], plan["cells"], plan["piece_chunks"]
    fp = plan["frames_per_piece"]
    assert pc <= PIECE_CHUNKS and (fp * K <= 32 * pc if fp else K > 32 * pc)
    ppf = 1 if fp else -(-plan["chunks"] // pc)
    for row in range(ids2.shape[0]):
        rid, rval, rout = ids2[row], vals2[row], res[row]
        for block in range(plan["col_tiles"] * plan["row_tiles"]):
            t0 = (block // plan["row_tiles"]) * TT
            f0 = (block % plan["row_tiles"]) * FF
            tt, ff = min(TT, T - t0), min(FF, C - f0)
            mul = (1 << 20) // ff
            assert TT * FF <= 0xffff
            assert mul >= plan["owner_mul"] and ((ff - 1) * mul) >> 16 < 16
            tile = [np.float32(rout[(t0 + i // ff) * C + f0 + i % ff])
                    if out is not None else np.float32(0.0)
                    for i in range(tt * ff)]

            def tile_key(i):
                if i < 0 or i >= T * C:
                    return -1
                c, f = i // C, i - (i // C) * C
                if c < t0 or c >= t0 + tt or f < f0 or f >= f0 + ff:
                    return -1
                return ((((f - f0) * mul) >> 16) << 16) \
                    | ((c - t0) * ff + f - f0)

            s0, s1 = max(t0 - R, 0), min(t0 + tt - 1 + R, T - 1)
            steps = ((s1 - s0 + fp) // fp if fp
                     else (s1 - s0 + 1) * ppf)
            assert steps <= plan["pieces"]
            for p in range(steps):
                # stage: piece p's keys, values and chunk masks
                if fp:                            # ``piece_range``
                    s = s0 + p * fp
                    at, hi = s * K, min(s + fp, s1 + 1) * K
                else:
                    at = (s0 + p // ppf) * K + (p % ppf) * pc * 32
                    hi = min(at + pc * 32, (s0 + p // ppf + 1) * K)
                keys = [tile_key(int(rid[at + i])) if at + i < hi
                        else -1 for i in range(pc * 32)]
                pv = [np.float32(rval[at + i]) if at + i < hi
                      else np.float32(0.0) for i in range(pc * 32)]
                masks = [0] * pc
                for i, key in enumerate(keys):
                    if key >= 0:
                        masks[i >> 5] |= 1 << (key >> 16)
                # walk: each warp's chunks in bin order
                for warp in range(TILE_WARPS):
                    for ch in range(pc):
                        if not (masks[ch] >> warp) & 1:
                            continue
                        groups = {}
                        for lane in range(32):
                            key = keys[(ch << 5) + lane]
                            if key >= 0 and key >> 16 == warp:
                                groups.setdefault(key & 0xffff, []).append(
                                    pv[(ch << 5) + lane])
                        for cell, vs in groups.items():   # lane order
                            acc = np.float32(tile[cell] + vs[0])
                            for v in vs[1:]:
                                acc = np.float32(acc + v)
                            tile[cell] = acc
            for i in range(tt * ff):
                at = (t0 + i // ff) * C + f0 + i % ff
                rout[at] = tile[i]
                stored[row, at] += 1
    return (torch.from_numpy(res.reshape(lead + (T * C,))),
            stored.reshape(lead + (T * C,)))


def _raster_ids(T, K, R, lead=(), seed=0, hot=True):
    """Seeded ids of the raster's form: frame s's bin k lands in column
    s + δ (|δ| <= R, clipped to the grid) and row k + a small shift (a
    few far), a fifth dropped (−1); with ``hot``, a third of each frame
    piled onto one cell of a steady tone.  Values of 1e-3 … 1e3 (half
    negative), so the order of a cell's adds shows in its bits."""
    rng = np.random.default_rng(seed)
    shape = lead + (T, K)
    s = np.arange(T)[:, None]
    c = np.clip(s + rng.integers(-R, R + 1, shape), 0, T - 1)
    f = np.clip(np.arange(K) + rng.integers(-2, 3, shape), 0, K - 1)
    far = rng.random(shape) < 0.02
    f = np.where(far, rng.integers(0, K, shape), f)
    if hot:
        pile = rng.random(shape) < 0.33
        c = np.where(pile, np.clip(s + rng.integers(-R, R + 1, shape), 0,
                                   T - 1), c)
        f = np.where(pile, K // 3, f)
    ids = (c * K + f).astype(np.int32)
    ids = np.where(rng.random(shape) < 0.2, -1, ids).astype(np.int32)
    vals = (10.0 ** rng.uniform(-3, 3, shape)
            * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    return (torch.from_numpy(ids.reshape(lead + (-1,))),
            torch.from_numpy(vals.reshape(lead + (-1,))))


def _assert_equal_and_stored_once(got, stored, want):
    assert torch.equal(got, want)
    assert (stored == 1).all()


@pytest.mark.parametrize("R", [0, 1, 2, 8])
@pytest.mark.parametrize("T,K", [(19, 67), (6, 33)])
def test_tiles_mirror_bit_equal_to_plain_sum(T, K, R):
    ids, vals = _raster_ids(T, K, R, seed=T * 100 + K + R)
    got, stored = _tiles_mirror(ids, vals, K, R)
    _assert_equal_and_stored_once(got, stored,
                                  histogram_plain(ids, vals, T * K))


@pytest.mark.parametrize("tile_cols", [1, 2, 4])
def test_tiles_mirror_every_tile_width_and_rows(tile_cols):
    """Two leading rows (channels), tiles of 1, 2 and 4 columns."""
    T, K, R = 13, 70, 2
    ids, vals = _raster_ids(T, K, R, lead=(2,), seed=tile_cols)
    got, stored = _tiles_mirror(ids, vals, K, R, tile_cols=tile_cols)
    _assert_equal_and_stored_once(got, stored,
                                  histogram_plain(ids, vals, T * K))


def test_tiles_mirror_adds_into_an_output():
    T, K, R = 11, 45, 1
    ids, vals = _raster_ids(T, K, R, seed=5)
    base = torch.from_numpy(np.random.default_rng(6).standard_normal(
        T * K).astype(np.float32))
    got, stored = _tiles_mirror(ids, vals, K, R, out=base)
    _assert_equal_and_stored_once(
        got, stored, histogram_plain(ids, vals, T * K, out=base.clone()))


def test_tiles_mirror_cuts_a_long_column_into_row_tiles():
    """A column over ``TILE_CELLS`` cells: one column a tile, row tiles."""
    T, K, R = 3, TILE_CELLS + 200, 1
    plan = tile_plan(T, K, R)
    assert (plan["cols"], plan["row_tiles"]) == (1, 2)
    rng = np.random.default_rng(8)
    s = np.repeat(np.arange(T), K)
    k = np.tile(np.arange(K), T)
    c = np.clip(s + rng.integers(-R, R + 1, s.size), 0, T - 1)
    f = np.where(rng.random(s.size) < 0.5, k, TILE_CELLS - 1 + k % 3)
    ids = torch.from_numpy((c * K + f).astype(np.int32))
    vals = torch.from_numpy(rng.uniform(-1e3, 1e3, s.size).astype(
        np.float32))
    got, stored = _tiles_mirror(ids, vals, K, R)
    _assert_equal_and_stored_once(got, stored,
                                  histogram_plain(ids, vals, T * K))


def test_in_frame_collisions_add_in_bin_order():
    """One frame's bins on one cell, within a chunk (lanes 3, 4, 9) and
    across chunks (bins 40, 70): the cell takes them in bin order, which
    here gives other bits than any other order tried."""
    T, K, R = 3, 100, 1
    ids = torch.full((T * K,), -1, dtype=torch.int32)
    vals = torch.zeros(T * K)
    cell = 1 * K + 50
    bins = [3, 4, 9, 40, 70]
    v = [1e8, 1.0, -1e8, 3.0, 1e-3]
    for b, x in zip(bins, v):
        ids[K + b], vals[K + b] = cell, x
    ids[b := 2 * K + 1], vals[b] = cell, 0.5     # a later frame's deposit
    got, stored = _tiles_mirror(ids, vals, K, R)
    want = histogram_plain(ids, vals, T * K)
    _assert_equal_and_stored_once(got, stored, want)
    seq = np.float32(0)
    for x in v + [0.5]:
        seq = np.float32(seq + np.float32(x))
    assert want[cell] == seq
    for order in ([1e8, -1e8, 1.0, 3.0, 1e-3, 0.5],       # lanes 3, 9, 4
                  [1e-3, 3.0, -1e8, 1.0, 1e8, 0.5]):      # bins reversed
        acc = np.float32(0)
        for x in order:
            acc = np.float32(acc + np.float32(x))
        assert acc != seq


def test_tiles_mirror_on_the_raster_ids():
    """The single-bank raster's own ids (``reassigned_bins``), at the
    reach ``scatter_segment_sum`` passes: R = ceil(N / 2·hop) holds every
    deposit of nonzero power, and the mirror gives the plain sum."""
    rng = np.random.default_rng(11)
    n = 256
    t = np.arange(48000 // 4) / 48000
    x = torch.from_numpy((np.sin(2 * np.pi * 3000 * t)
                          + 0.3 * np.sin(2 * np.pi * (200 * t + 4000 * t * t))
                          + 0.01 * rng.standard_normal(t.size)).astype(
                              np.float32))
    for hop, R in ((128, 1), (64, 2), (16, 8)):
        assert R == -(-n // (2 * hop))
        X = stft_triple(x, n, hop, "stencil")
        T = X[0].shape[-2]
        t_bin, f_bin, p = reassigned_bins(*reassignment_corrections(*X), n,
                                          hop, T)
        frame = torch.arange(T)[:, None]
        assert int((t_bin - frame)[p != 0].abs().max()) <= R
        K = n // 2 + 1
        ids = torch.where(p != 0, t_bin * K + f_bin, -1).reshape(-1)
        vals = p.reshape(-1).contiguous()
        got, stored = _tiles_mirror(ids, vals, K, R)
        want = histogram_plain(ids, vals, T * K)
        _assert_equal_and_stored_once(got, stored, want)
        grid = scatter_segment_sum(t_bin, f_bin, p, T, K, reach=R)
        assert torch.equal(grid.reshape(-1), want)


def test_tile_plan_fits_shared_memory_and_covers_the_grid():
    for T, K, R in ((372, 4097, 2), (1487, 1025, 2), (60, 16385, 2),
                    (30, 131073, 8), (5, 257, 0), (1, 5, 3)):
        for cols in (None, 1, 2, 4):
            p = tile_plan(T, K, R, cols)
            assert p["smem"] <= 4 * SMEM_BINS                  # 227 KB
            assert p["cols"] * p["cells"] <= TILE_CELLS
            assert p["col_tiles"] * p["cols"] >= T > (p["col_tiles"] - 1) \
                * p["cols"]
            assert p["row_tiles"] * p["cells"] >= K > (p["row_tiles"] - 1) \
                * p["cells"]
            assert ((p["cells"] - 1) * p["owner_mul"]) >> 16 < TILE_WARPS
            assert p["pieces"] * p["piece_chunks"] >= p["chunks"]
            assert p["piece_chunks"] <= PIECE_CHUNKS
    raster = tile_plan(372, 4097, 2)              # the raster at 8192
    assert (raster["cols"], raster["cells"], raster["col_tiles"],
            raster["walk"], raster["frames_per_piece"],
            raster["piece_chunks"], raster["pieces"]) == (
        3, 4097, 124, 7, 1, 129, 7)
    assert tile_plan(60, 16385, 2)["row_tiles"] == 1   # 32768: one tile
    # every warp owns cells of each column: the bands split the column
    owners = {((f * raster["owner_mul"]) >> 16) for f in range(4097)}
    assert owners == set(range(TILE_WARPS))
    big = tile_plan(60, 16385, 2)                 # a frame in four pieces
    assert (big["frames_per_piece"], big["piece_chunks"],
            big["pieces"]) == (0, 129, 20)


def test_wrapper_checks_the_bound_and_takes_plain_on_the_cpu():
    T, K, R = 7, 33, 1
    ids, vals = _raster_ids(T, K, R, seed=2)
    before = (histogram.launches, dict(histogram.route_launches))
    got = histogram(ids, vals, T * K, route=SORTED, reach=R, frame_len=K)
    assert torch.equal(got, histogram_plain(ids, vals, T * K))
    assert (histogram.launches, histogram.route_launches) == before
    assert SORTED_TILES in histogram.route_launches
    for bad in (dict(reach=R, frame_len=K),                  # no route
                dict(route=SORTED, reach=R),                 # no frame_len
                dict(route=SORTED, reach=-1, frame_len=K),
                dict(route=SORTED, reach=R, frame_len=K + 1)):
        with pytest.raises(ValueError, match="reach and frame_len"):
            histogram(ids, vals, T * K, **bad)
    meta = torch.empty(T * K, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="histogram"):
        histogram(meta, torch.empty(T * K, device="meta"), T * K,
                  route=SORTED, reach=R, frame_len=K)
