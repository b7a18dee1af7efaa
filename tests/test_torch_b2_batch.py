"""Kernel B2's sorted route, its batch form (``csrc/histogram_batch.cu``
``batch_kernel``), mirrored in numpy on the CPU.

``_batch_mirror`` follows the kernel step by step: ``batch_plan``'s grid
(a CTA a lane's tile of TT columns in one of B row bands), the owner of
cell (c, f) — row block f >> row_shift in band (f >> row_shift) mod B,
local row ((f >> row_shift) div B) << row_shift | f mod 2^row_shift, warp
(f >> row_shift) div B mod 16 — the read of the frames t0 − R … t0 + TT −
1 + R in rounds of kQ chunks a warp, each raw chunk's kept deposits one
chunk of entries (each cell one run, the cells in order of their first
deposit: ``group_offset``; the rest empty) with its warp mask — or, where
the plan packs them (a CTA reading many deposits for each it keeps), the
kept deposits packed in deposit order — pieces of at most ``cap``
entries; each warp's walk over its chunks in order, each run's first
lane adding its values in lane order — lane 0 alone where one run is the
whole chunk, else by shuffles (both paths taken, counted; no cell with
two runs in a chunk of one raw chunk, checked; packed, runs whose cells
share 8 hash bits in turns, taken); every cell stored once.  Held
bit for bit (tolerance 0) to ``histogram_plain`` (``index_add_``, each
cell in deposit order) on seeded crowded log-row ids (K = 4097 and 16,385
deposits a frame into C = 512 log rows, a 131,073-like case of 8,193 into
32), with hot cells, ids of −1 and past the grid carrying NaN/Inf, R = 0,
1, 2, 20 and 64, lanes 1, 2, 3 and 16, 1 … 16 row bands, row blocks of 1
and 4 rows, entry arrays of one round and more, and adding into an
output; the values are chosen so that another add order gives other bits
(checked).  Also against the JAX package's ``histogram_matmul`` in
interpret mode, within 1e-6; ``batch_plan`` against the ``.cu``'s limits;
``sorted_form`` at the batch cells, by shape.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from emspec.dsp.pallas.scatter import histogram_matmul
from emspec_torch import kernels_build
from emspec_torch.dsp.kernels.scatter import (
    BATCH_BANDS, BATCH_CELLS, BATCH_MAX_SHIFT, BATCH_ROUND, SMEM_BYTES, SMS,
    SORTED, SORTED_BATCH, TILE_WARPS, batch_plan, histogram,
    histogram_plain, sorted_form)

CSRC = Path(kernels_build.__file__).parent / "csrc" / "histogram_batch.cu"
K_Q = 8                     # histogram_batch.cu kQ: chunks a warp a round
ROUND = K_Q * 32 * 16       # histogram_batch.cu kRound
NONE = 0xffffffff


def _cu_constant(name):
    m = re.search(rf"constexpr \w+ {name} = (\w+);", CSRC.read_text())
    return int(m.group(1), 0)


STEPS = {"whole": 0, "runs": 0, "turns": 0}   # the mirror's walk steps


def _walk_step(e32, tile, warp, packed):
    """``walk_step``: the chunk's 32 entries (word, value) onto ``tile``:
    the runs of equal words this warp owns, each from its first lane;
    ``packed``: runs whose cells share 8 hash bits (runs of one cell among
    them) in turns, else no cell has two runs (checked)."""
    f32 = np.float32
    words = [w for w, _ in e32]
    starts = [lane == 0 or words[lane - 1] != words[lane]
              for lane in range(32)]
    leaders = [lane for lane in range(32) if starts[lane]
               and words[lane] != NONE and words[lane] >> 16 == warp]
    if leaders == [0] and sum(starts) == 1:     # one run: the whole chunk
        STEPS["whole"] += 1
        acc = f32(tile[words[0] & 0xffff])
        for _, v in e32:
            acc = f32(acc + v)
        tile[words[0] & 0xffff] = acc
        return
    STEPS["runs"] += 1

    def h(w):                                   # the cell's 8 hash bits
        return (w ^ (w >> 8)) & 0xff
    if packed:
        turn = {lane: sum(h(words[o]) == h(words[lane]) for o in leaders
                          if o < lane) for lane in leaders}
    else:
        cells = [words[lane] & 0xffff for lane in leaders]
        assert len(set(cells)) == len(cells)    # a cell is one run
        turn = dict.fromkeys(leaders, 0)
    for t in range(max(turn.values(), default=0) + 1):
        STEPS["turns"] += t > 0
        for lane in leaders:
            if turn[lane] != t:
                continue
            end = next((o for o in range(lane + 1, 32) if starts[o]), 32)
            cell = words[lane] & 0xffff
            acc = f32(tile[cell] + e32[lane][1])
            for i in range(lane + 1, end):
                acc = f32(acc + e32[i][1])
            tile[cell] = acc


def _batch_mirror(ids, vals, K, R, C, bands=None, tile_cols=None,
                  row_shift=None, out=None, lanes=None, cap=None,
                  packed=None):
    """``batch_kernel`` in numpy float32, its loops and index expressions
    verbatim → (out, times each cell was stored).  ``cap`` (a multiple of
    32, at least a round) stands in for the plan's entry array, so that
    small cases walk many pieces."""
    lead = ids.shape[:-1]
    M = ids.shape[-1]
    T = M // K
    ids2 = ids.reshape(-1, M).numpy()
    vals2 = vals.reshape(-1, M).numpy().astype(np.float32)
    rows = ids2.shape[0]
    res = (np.zeros((rows, T * C), np.float32) if out is None
           else out.reshape(-1, T * C).numpy().astype(np.float32).copy())
    stored = np.zeros(res.shape, np.int64)
    plan = batch_plan(T, K, R, C, lanes or rows, bands=bands,
                      tile_cols=tile_cols, row_shift=row_shift,
                      packed=packed)
    packed = plan["packed"]
    assert plan["fits"], plan
    B, TT, shift, rb = (plan["bands"], plan["cols"], plan["row_shift"],
                        plan["rb"])
    cap = cap or plan["cap"]
    assert cap % 32 == 0 and cap >= ROUND
    log_b, smask = B.bit_length() - 1, (1 << shift) - 1

    def cell_row(band, j):
        f = ((j >> shift) << (shift + log_b)) | band << shift | (j & smask)
        return f if f < C else -1

    for row in range(rows):
        rid, rval, rout = ids2[row], vals2[row], res[row]
        for group in range(plan["col_tiles"]):
            t0 = group * TT
            tt = min(TT, T - t0)
            s0, s1 = max(t0 - R, 0), min(t0 + tt - 1 + R, T - 1)
            lo, hi = s0 * K, (s1 + 1) * K
            cells = tt * rb
            assert cells <= 0xffff
            for band in range(B):
                tile = [np.float32(rout[(t0 + i // rb) * C + f])
                        if out is not None and f >= 0 else np.float32(0.0)
                        for i in range(cells)
                        for f in [cell_row(band, i % rb)]]
                raw = lo
                while raw < hi:                          # a piece
                    kv, fill = [], 0
                    while raw < hi and (fill + ROUND <= cap if packed
                                        else fill + ROUND // 32 <= cap // 32):
                        for warp in range(TILE_WARPS):
                            for q in range(K_Q):
                                kept = []          # the raw chunk's own
                                for lane in range(32):
                                    k = raw + ((warp * K_Q + q) << 5) + lane
                                    i = int(rid[k]) if k < hi else -1
                                    if not 0 <= i < T * C:
                                        continue
                                    c = int(i * (1.0 / C))
                                    c -= c * C > i
                                    c += (c + 1) * C <= i
                                    assert c == i // C
                                    f = i - c * C
                                    blk = f >> shift
                                    if (t0 <= c < t0 + tt
                                            and blk & (B - 1) == band):
                                        j = blk >> log_b
                                        word = (((c - t0) * rb + (j << shift)
                                                 + (f & smask))
                                                | (j & 15) << 16)
                                        kept.append((word, rval[k]))
                                if not kept:
                                    continue
                                if packed:            # in deposit order
                                    kv += kept
                                    continue
                                # one chunk of entries: ``group_offset``,
                                # each cell one run, the cells in order of
                                # their first deposit, the rest empty
                                for w in dict.fromkeys(x for x, _ in kept):
                                    kv += [e for e in kept if e[0] == w]
                                kv += [(NONE, np.float32(0))] * (
                                    32 - len(kept))
                        raw += ROUND
                        fill = len(kv) if packed else len(kv) // 32
                    kv += [(NONE, np.float32(0))] * (-len(kv) % 32)
                    masks = [0] * (len(kv) // 32)
                    for x, (word, _) in enumerate(kv):
                        if word != NONE:
                            masks[x >> 5] |= 1 << (word >> 16)
                    for warp in range(TILE_WARPS):           # the walk
                        for ch, m in enumerate(masks):
                            if (m >> warp) & 1:
                                _walk_step(kv[ch << 5:(ch + 1) << 5], tile,
                                           warp, packed)
                for i in range(cells):
                    c = t0 + i // rb
                    f = cell_row(band, i % rb)
                    if f >= 0:
                        rout[c * C + f] = tile[i]
                        stored[row, c * C + f] += 1
    return (torch.from_numpy(res.reshape(lead + (T * C,))),
            stored.reshape(lead + (T * C,)))


def _log_rows(K, C, f_lo=20.0):
    """Row of each of K bins on C log-spaced rows from ``f_lo`` to the
    top (``Pipeline.row_of_frequency``'s form): the top rows crowd."""
    f = np.arange(K) * (24000.0 / (K - 1))
    r = np.log(np.maximum(f, f_lo) / f_lo) / np.log(24000.0 / f_lo) * C
    return np.clip(r.astype(np.int64), 0, C - 1)


def _crowded_ids(T, K, C, R, lead=(), seed=0, hot=0.17, drop=0.1,
                 moved=0.3, jitter=1):
    """Seeded ids of the enhanced batch grid on log rows: frame s's bin k
    lands in column s + δ (|δ| <= R, most at 0) and its log row or the
    next, a sixth piled onto one hot cell, a tenth dropped (−1) and a
    hundredth past the grid, both carrying NaN or Inf (``moved``,
    ``jitter``, ``hot`` and ``drop`` set the shares off column s, the row
    shift, the piled and the dropped); values of 1e-3 …
    1e3, half negative, so the order of a cell's adds shows in its bits."""
    rng = np.random.default_rng(seed)
    shape = lead + (T, K)
    s = np.arange(T)[:, None]
    d = np.where(rng.random(shape) < 1 - moved, 0,
                 rng.integers(-R, R + 1, shape))
    c = s + d
    f = np.clip(_log_rows(K, C) + rng.integers(0, jitter + 1, shape), 0,
                C - 1)
    f = np.where(rng.random(shape) < hot, C - 3, f)
    ids = np.where((c < 0) | (c >= T), -1, c * C + f)
    ids = np.where(rng.random(shape) < drop, -1, ids)
    ids = np.where(rng.random(shape) < 0.01, T * C + 5, ids)
    vals = (10.0 ** rng.uniform(-3, 3, shape)
            * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    bad = (ids < 0) | (ids >= T * C)
    vals[bad] = np.where(rng.random(int(bad.sum())) < 0.5, np.nan, np.inf)
    return (torch.from_numpy(ids.astype(np.int32).reshape(lead + (-1,))),
            torch.from_numpy(vals.reshape(lead + (-1,))))


def _assert_plain(ids, vals, K, R, C, **kw):
    T = ids.shape[-1] // K
    got, stored = _batch_mirror(ids, vals, K, R, C, **kw)
    want = histogram_plain(ids, vals, T * C)
    assert torch.equal(got, want)
    assert (stored == 1).all()
    assert torch.isfinite(got).all()
    return got


@pytest.mark.parametrize("bands", [1, 2, 4, 16])
@pytest.mark.parametrize("R", [0, 2])
def test_mirror_crowded_8192_rows_every_band_count(bands, R):
    """K = 4097 bins into 512 log rows (the batch cells at 8192), two
    tiles a lane, at 1 … 16 row bands and both row blocks."""
    T, K, C = 5, 4097, 512
    ids, vals = _crowded_ids(T, K, C, R, seed=bands * 10 + R)
    for shift, packed in ((0, True), (2, False)):
        _assert_plain(ids, vals, K, R, C, bands=bands, tile_cols=3,
                      row_shift=shift, packed=packed)


@pytest.mark.parametrize("R,T,cols", [(20, 6, 2), (64, 4, 1)])
def test_mirror_crowded_32768_rows_far_reach(R, T, cols):
    """16,385 bins into 512 rows (stress, north) at the north star's R =
    20 and wide's R = 64 (every tile reads every frame)."""
    K, C = 16385, 512
    ids, vals = _crowded_ids(T, K, C, R, seed=R)
    STEPS.update(whole=0, runs=0, turns=0)
    assert batch_plan(T, K, R, C, tile_cols=cols)["packed"]
    _assert_plain(ids, vals, K, R, C, tile_cols=cols)
    assert STEPS["turns"] > 0


def test_mirror_a_262144_like_column():
    """A column of 32 rows fed 8,193 bins a frame (256 a row, as 131,073
    into 512) in 16 bands: every chunk of the top rows one run of 32; the
    walk takes both of its paths."""
    T, K, C, R = 4, 8193, 32, 2
    ids, vals = _crowded_ids(T, K, C, R, seed=9, hot=0.0, drop=0.0,
                             moved=0.02, jitter=0)
    STEPS.update(whole=0, runs=0, turns=0)
    _assert_plain(ids, vals, K, R, C, bands=16, tile_cols=1)
    assert STEPS["whole"] > 100 and STEPS["runs"] > 10


@pytest.mark.parametrize("lanes", [1, 3, 16])
def test_mirror_lanes_and_the_default_plan(lanes):
    """Lanes of a batch (channels), at the plan's own choice of bands and
    tiles for that many lanes."""
    T, K, C, R = 6, 1025, 128, 2
    ids, vals = _crowded_ids(T, K, C, R, lead=(lanes,), seed=lanes)
    _assert_plain(ids, vals, K, R, C)


def test_mirror_adds_into_an_output():
    T, K, C, R = 4, 4097, 512, 2
    ids, vals = _crowded_ids(T, K, C, R, lead=(2,), seed=4)
    base = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, T * C)).astype(np.float32))
    got, stored = _batch_mirror(ids, vals, K, R, C, bands=2, out=base)
    assert torch.equal(got, histogram_plain(ids, vals, T * C,
                                            out=base.clone()))
    assert (stored == 1).all()


@pytest.mark.parametrize("cap", [ROUND, 2 * ROUND + 32])
def test_mirror_pieces_turn_over(cap):
    """Entry arrays of one and two rounds: many pieces a tile, each
    filled and walked in turn, pieces ending inside a frame and (packed)
    inside a chunk of entries, in both layouts."""
    T, K, C, R = 5, 3000, 64, 1
    ids, vals = _crowded_ids(T, K, C, R, seed=6)
    for packed in (False, True):
        _assert_plain(ids, vals, K, R, C, tile_cols=T, cap=cap,
                      packed=packed)


def test_the_order_of_a_cells_adds_shows_in_its_bits():
    """One cell fed within a chunk (lanes 3, 4, 9: a short group), across
    chunks, and by a long group (12 lanes), then a later frame: the
    mirror gives the plain sum, which differs from other orders."""
    T, K, C, R = 3, 100, 8, 1
    ids = torch.full((T * K,), -1, dtype=torch.int32)
    vals = torch.zeros(T * K)
    cell = 1 * C + 5
    bins = [3, 4, 9, 40, 70] + list(range(80, 92))
    v = [1e8, 1.0, -1e8, 3.0, 1e-3] + [0.37 * (n + 1) for n in range(12)]
    for b, x in zip(bins, v):
        ids[K + b], vals[K + b] = cell, x
    ids[2 * K + 1], vals[2 * K + 1] = cell, 0.5
    for bands in (1, 2):
        got = _assert_plain(ids, vals, K, R, C, bands=bands)
    seq = np.float32(0)
    for x in v + [0.5]:
        seq = np.float32(seq + np.float32(x))
    assert got[cell] == seq
    for order in ([1e8, -1e8, 1.0] + v[3:] + [0.5],
                  [0.5] + v[::-1]):
        acc = np.float32(0)
        for x in order:
            acc = np.float32(acc + np.float32(x))
        assert acc != seq


def test_mirror_on_random_orders_differs_from_another_order():
    """The crowded ids' sum in another order (each cell's deposits
    reversed) gives other bits in many cells: the equality above tests
    the order."""
    T, K, C, R = 4, 4097, 512, 2
    ids, vals = _crowded_ids(T, K, C, R, seed=3)
    want = histogram_plain(ids, vals, T * C)
    rev = histogram_plain(ids.flip(-1), vals.flip(-1), T * C)
    assert int((rev != want).sum()) > 50


def test_mirror_against_the_jax_interpret_kernel():
    """The mirror against the JAX package's ``histogram_matmul`` in
    interpret mode (bf16 terms, passes=3: float32-exact split; another
    order), within 1e-6."""
    T, K, C, R = 3, 257, 64, 1
    ids, vals = _crowded_ids(T, K, C, R, lead=(2,), seed=12)
    ids_np, vals_np = ids.numpy(), vals.numpy().copy()
    vals_np[(ids_np < 0) | (ids_np >= T * C)] = 0.5     # finite for the MXU
    got, _ = _batch_mirror(ids, torch.from_numpy(vals_np), K, R, C,
                           bands=2)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(histogram_matmul(
            jnp.asarray(ids_np), jnp.asarray(vals_np), T * C, m_chunk=256,
            passes=3))
    np.testing.assert_allclose(got.numpy(), pal, rtol=1e-6, atol=1e-6)


# the batch cells of chip_smoke.py: (frames, deposits a frame, reach,
# rows, lanes)
CELLS = {
    "batch": (372, 4097, 2, 512, 1),
    "batch16": (372, 4097, 2, 512, 16),
    "direct": (372, 4097, 2, 512, 1),
    "multires": (5937, 382, 32, 512, 1),
    "time_parallel chunk": (6001, 382, 32, 512, 1),
    "stress": (43, 16385, 2, 512, 16),
    "stress_live_batch": (172, 16385, 2, 512, 16),
    "north": (920, 16385, 20, 512, 1),
    "ext262144": (8, 131073, 2, 512, 1),
    "wide": (1373, 4097, 64, 512, 1),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_batch_plan_at_the_batch_cells(cell):
    """The plan fits the ``.cu``'s limits (227 KB, 16-bit cells, 16
    bands, 16-row blocks, an entry array of at least a round), fills the
    card's SMs where the frames allow, covers every column once and every
    row once over (band, local row), and every warp of a band owns rows."""
    T, K, R, C, lanes = CELLS[cell]
    p = batch_plan(T, K, R, C, lanes)
    B, shift = p["bands"], p["row_shift"]
    assert p["fits"] and p["smem"] <= SMEM_BYTES == 232448
    assert B & (B - 1) == 0 and B <= BATCH_BANDS == _cu_constant("kMaxBands")
    assert 0 <= shift <= BATCH_MAX_SHIFT == _cu_constant("kMaxShift")
    assert p["cells"] <= min(BATCH_CELLS, _cu_constant("kMaxCells"))
    assert p["cap"] % 32 == 0 and p["cap"] >= BATCH_ROUND == ROUND == \
        _cu_constant("kQ") * 32 * TILE_WARPS
    assert p["col_tiles"] * p["cols"] >= T > (p["col_tiles"] - 1) * p["cols"]
    assert min(SMS, lanes * T) // 2 < p["ctas"] <= max(SMS, lanes)
    log_b = B.bit_length() - 1
    owners, warps = set(), set()
    for f in range(C):
        blk = f >> shift
        j = ((blk >> log_b) << shift) + (f & ((1 << shift) - 1))
        assert j < p["rb"]
        owners.add((blk & (B - 1), j))
        warps.add((blk & (B - 1), (blk >> log_b) & 15))
    assert len(owners) == C              # one (band, local row) a row
    assert len(warps) == B * TILE_WARPS  # every warp of every band


def test_batch_plan_spreads_the_top_rows():
    """At 8192 on 512 log rows the top 64 rows (59% of the bins) land on
    every warp, while a chunk of 32 neighbouring bins lands on few owner
    warps (4-row blocks)."""
    rows = _log_rows(4097, 512)
    assert (rows >= 448).mean() > 0.55
    p = batch_plan(372, 4097, 2, 512)
    assert (p["bands"], p["row_shift"]) == (1, 2)
    assert {(f >> 2) & 15 for f in range(448, 512)} == set(range(16))
    owners = [len({(f >> 2) & 15 for f in rows[k:k + 32]})
              for k in range(0, 4097, 32)]
    assert np.mean(owners) < 2.5


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sorted_form_at_the_batch_cells_by_shape(cell):
    """Every crowded batch cell (more deposits a frame than rows) takes the
    batch form, the display default's grid the tiles form: by shape alone,
    the same answer whatever the ids."""
    T, K, R, C, lanes = CELLS[cell]
    want = "tiles" if cell in ("multires", "time_parallel chunk") else "batch"
    assert sorted_form(T, K, R, C, lanes) == want


def test_wrapper_takes_plain_on_the_cpu_and_counts_nothing():
    T, K, C, R = 4, 300, 40, 1
    ids, vals = _crowded_ids(T, K, C, R, seed=8)
    before = (histogram.launches, dict(histogram.route_launches))
    got = histogram(ids, vals, T * C, route=SORTED, reach=R, frame_len=K,
                    column_len=C, form="batch")
    assert torch.equal(got, histogram_plain(ids, vals, T * C))
    assert (histogram.launches, histogram.route_launches) == before
    assert SORTED_BATCH in histogram.route_launches
    for bad in (dict(form="batch"), dict(route=SORTED, form="sort"),
                dict(route=SORTED, reach=R, frame_len=K, column_len=C,
                     form="ring")):
        with pytest.raises(ValueError, match="form"):
            histogram(ids, vals, T * C, **bad)
