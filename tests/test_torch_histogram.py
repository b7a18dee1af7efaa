"""Kernel B2's routes (``emspec_torch/csrc/histogram.cu``: row and
global) on the CPU: the routing by shape, a plain-Python mirror of the
kernel's work split with the ``.cu``'s index expressions, and the
relative-scatter path at a setting above a block's shared memory.

The mirror walks the grid as the kernel does: one block a row (row), the
flat rows·m stream over ``global_blocks`` blocks and its row = index div
m (global), the head peeled to the 16-byte boundary, the vector steps
and the tail, each thread's run merge over its four elements, each warp
step's ``__match_any_sync`` groups summed by ``reduce_peers``' tree in
float32 and the leader's add (on the row route only where the step's
live keys fall in few hash buckets, else each lane's own add), and the
row route's store.  It counts the visits of every element (each exactly
once) and holds its histogram to
``histogram_plain`` and the JAX package's ``histogram_reference`` within
1e-5 relative per nonzero cell, with exact zeros elsewhere — the
kernel's card criterion (float32 adds in another order).  The path test
holds ``Pipeline(fft_size=8192, hop=64)`` (R = 64, 66,048 relative
cells) to the JAX ``Pipeline`` on the CPU at PERF.md §2's tolerances:
grids by ``compare_grids`` (energy ≤ 1e-4 relative, 3×3 max-filters
within 1e-3·peak on all but 1e-4 of the cells), ``vis`` by
``compare_vis`` (2/255 on all but 1e-4 of the cells)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.dsp.pallas.scatter import histogram_reference
from emspec.io import synth
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.config import Settings
from emspec_torch.convert import params_from_jax
from emspec_torch.dsp.kernels.scatter import (
    GLOBAL_BLOCKS, GLOBAL_THREADS, ROUTES, ROW_THREADS, SMEM_BINS,
    global_blocks, histogram, histogram_plain, route_of)
from emspec_torch.pipeline import Pipeline
from emspec_torch.validate import compare_grids, compare_vis

FULL = 0xFFFFFFFF
HOT_BUCKETS = 6                  # kHotBuckets

# (rows, m, num_bins) of every path's B2 call → the route PERF.md §6 names
PATH_SHAPES = {
    "batch": ((372, 4097, 2560), "row"),
    "batch16": ((5952, 4097, 2560), "row"),
    "live": ((1, 4097, 2560), "global"),
    "stress": ((688, 16385, 2560), "row"),
    "stress_live": ((16, 16385, 2560), "global"),
    "north": ((920, 16385, 20992), "global"),
    "north_live": ((1, 16385, 20992), "global"),
    "ext262144": ((8, 131073, 2560), "global"),
    "wide": ((1373, 4097, 66048), "global"),
    "wide_live": ((1, 4097, 66048), "global"),
}


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("path", sorted(PATH_SHAPES))
def test_route_of_path_shapes(path):
    (rows, m, num_bins), route = PATH_SHAPES[path]
    assert route_of(rows, m, num_bins) == route
    if route == "row":              # the rows alone give every SM two blocks
        assert rows >= 2 * 132
    else:                           # one vector a thread, up to a cap
        blocks = global_blocks(rows, m)
        assert blocks == min(-(-rows * m // (4 * GLOBAL_THREADS)),
                             GLOBAL_BLOCKS)
        if rows <= 16:              # the 1-, 8- and 16-row shapes
            assert blocks > rows


def test_route_is_global_above_shared_memory_and_by_shape_only():
    shapes = [(r, m, s) for r in (1, 2, 16, 372, 5952)
              for m in (1, 7, 4097, 16385, 131073)
              for s in (1, 2560, SMEM_BINS, SMEM_BINS + 1, 66048, 83968)]
    for rows, m, s in shapes:
        route = route_of(rows, m, s)
        assert route in ROUTES
        if s > SMEM_BINS:
            assert route == "global", (rows, m, s)
    # the same shape with other data takes the same launch: route_of sees
    # only integers, and histogram() passes it nothing else
    assert route_of(16, 16385, 2560) == route_of(16, 16385, 2560)


def test_forced_shared_route_above_the_cap_raises_on_card_tensors():
    meta = torch.empty(2, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="histogram"):
        histogram(meta, torch.empty(2, 5, device="meta"), SMEM_BINS + 1,
                  route="row")


# ------------------------------------------------------------- the mirror
def _popc(x):
    return bin(x & FULL).count("1")


def _ffs(x):
    x &= FULL
    return (x & -x).bit_length()


def _reduce_peers(peers, v):
    """``reduce_peers`` for one warp: peers, v (32 lanes) → (leader, v)."""
    v = [np.float32(a) for a in v]
    below = [(1 << lane) - 1 for lane in range(32)]
    rank = [_popc(peers[lane] & below[lane]) for lane in range(32)]
    leader = [r == 0 for r in rank]
    above = [peers[lane] & ~below[lane] & ~(1 << lane) & FULL
             for lane in range(32)]
    while any(a != 0 for a in above):
        nxt = [_ffs(a) for a in above]
        t = [v[(n - 1) & 31] for n in nxt]             # all read, then add
        v = [np.float32(v[lane] + t[lane]) if nxt[lane] else v[lane]
             for lane in range(32)]
        done = sum(1 << lane for lane in range(32) if rank[lane] & 1)
        above = [a & ~done & FULL for a in above]
        rank = [r >> 1 for r in rank]
    return leader, v


def _bucket_bit(key):
    """``bucket_bit`` (32-bit keys): the top five bits of key·0x9E3779B1."""
    return 1 << (((key * 0x9E3779B1) & FULL) >> 27)


def _warp_add(dst, keys, oks, vals, hot_only):
    """``warp_add``: one warp step of 32 (key, ok, value); ``hot_only``
    (the row route) merges only steps whose live keys fall in at most
    ``HOT_BUCKETS`` hash buckets."""
    if not any(oks):
        return
    seen = 0
    for lane in range(32):
        if oks[lane]:
            seen |= _bucket_bit(keys[lane])
    if hot_only and _popc(seen) > HOT_BUCKETS:    # each lane its own add
        for lane in range(32):
            if oks[lane]:
                dst[keys[lane]] = np.float32(dst[keys[lane]] + vals[lane])
        return
    peers = [sum(1 << other for other in range(32)
                 if keys[other] == keys[lane]) for lane in range(32)]
    leader, v = _reduce_peers(peers, vals)
    for lane in range(32):
        if leader[lane] and oks[lane]:
            dst[keys[lane]] = np.float32(dst[keys[lane]] + v[lane])


class _Sink:
    """``Sink``: the shared row histogram (keyed by id) or the output
    (keyed by row·num_bins + id)."""

    def __init__(self, dst, m, num_bins, is_global):
        self.dst, self.m, self.num_bins = dst, m, num_bins
        self.is_global = is_global

    def key(self, row, idv, lane):
        ok = 0 <= idv < self.num_bins
        drop = ("drop", lane)                 # ~lane: a key of its own
        if not self.is_global:
            return (idv if ok else drop), ok
        return (row * self.num_bins + idv if ok else drop), ok

    def row_of(self, f):
        return f // self.m if self.is_global and f >= 0 else 0

    def add(self, keys, oks, vals):
        _warp_add(self.dst, keys, oks, vals, not self.is_global)


def _consume(ids, vals, sink, f0, f1, a0, vec, warp_firsts, stride, edge,
             visits):
    """``consume``: the flat elements [f0, f1) into ``sink``.  Each entry
    of ``warp_firsts`` is one warp's ``first − lane``."""
    n = f1 - f0
    if not vec:
        for wbase in warp_firsts:
            base = wbase
            while base < n:
                keys, oks, vs = [], [], []
                for lane in range(32):
                    j = base + lane
                    idv = int(ids[f0 + j]) if j < n else -1
                    key, ok = sink.key(sink.row_of(f0 + j), idv, lane)
                    if j < n:
                        visits[f0 + j] += 1
                    keys.append(key)
                    oks.append(ok)
                    vs.append(vals[f0 + j] if ok else np.float32(0))
                sink.add(keys, oks, vs)
                base += stride
        return
    head = min(n, (4 - ((a0 + f0) & 3)) & 3)
    b0 = f0 + head
    assert (a0 + b0) % 4 == 0 or b0 == f1          # 16-byte aligned
    nv = (f1 - b0) >> 2
    t0 = b0 + 4 * nv
    for wbase in warp_firsts:
        base = wbase
        while base < nv:
            lanes = []
            for lane in range(32):
                j = base + lane
                el = [b0 + 4 * j + k for k in range(4)] if j < nv else None
                idl = [int(ids[f]) for f in el] if el else [-1] * 4
                vl = [vals[f] for f in el] if el else [np.float32(0)] * 4
                if el:
                    for f in el:
                        visits[f] += 1
                row = sink.row_of(b0 + 4 * j)
                q = b0 + 4 * j - row * sink.m if sink.is_global else 0
                key, ok = [None] * 4, [False] * 4
                for k in range(4):
                    if sink.is_global:
                        while q >= sink.m:
                            q -= sink.m
                            row += 1
                    key[k], ok[k] = sink.key(row, idl[k], lane)
                    if not ok[k]:
                        vl[k] = np.float32(0)
                    q += 1
                for k in range(3, 0, -1):
                    if ok[k] and ok[k - 1] and key[k] == key[k - 1]:
                        vl[k - 1] = np.float32(vl[k - 1] + vl[k])
                        ok[k] = False
                        key[k] = ("drop", lane)
                lanes.append((key, ok, vl))
            for k in range(4):
                sink.add([ln[0][k] for ln in lanes],
                         [ln[1][k] for ln in lanes],
                         [ln[2][k] for ln in lanes])
            base += stride
    if edge:
        keys, oks, vs = [], [], []
        for lane in range(32):
            f = (f0 + lane if lane < head
                 else t0 + lane - 4 if 4 <= lane < 4 + (f1 - t0) else -1)
            idv = int(ids[f]) if f >= 0 else -1
            if f >= 0:
                visits[f] += 1
            key, ok = sink.key(sink.row_of(f), idv, lane)
            keys.append(key)
            oks.append(ok)
            vs.append(vals[f] if ok else np.float32(0))
        sink.add(keys, oks, vs)


def _mirror(ids, vals, num_bins, route=None, a0=0, vec=True):
    """The kernel's grid over ids, vals (rows, m) → (out, visits)."""
    rows, m = ids.shape
    route = route or route_of(rows, m, num_bins)
    fi, fv = ids.reshape(-1), vals.reshape(-1).astype(np.float32)
    visits = np.zeros(rows * m, np.int64)
    out = np.zeros(rows * num_bins, np.float32)
    if route == "global":
        blocks = global_blocks(rows, m)
        for block in range(blocks):
            warps = [block * GLOBAL_THREADS + 32 * w
                     for w in range(GLOBAL_THREADS // 32)]
            _consume(fi, fv, _Sink(out, m, num_bins, True), 0, rows * m, a0,
                     vec, warps, blocks * GLOBAL_THREADS, block == 0, visits)
        return out.reshape(rows, num_bins), visits
    for row in range(rows):                   # row_kernel: block = row
        h = np.zeros(num_bins, np.float32)
        _consume(fi, fv, _Sink(h, m, num_bins, False), row * m,
                 (row + 1) * m, a0, vec,
                 [32 * w for w in range(ROW_THREADS // 32)], ROW_THREADS,
                 True, visits)
        out[row * num_bins:(row + 1) * num_bins] = h
    return out.reshape(rows, num_bins), visits


def _case(kind, rows, m, num_bins, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        ids = rng.integers(-3, num_bins + 3, (rows, m))
    elif kind == "runs32":                # runs of 32 equal ids
        ids = np.repeat(rng.integers(0, num_bins, (rows, -(-m // 32))), 32,
                        axis=1)[:, :m]
    elif kind == "one_cell":              # row 0 all in one cell
        ids = rng.integers(0, num_bins, (rows, m))
        ids[0] = num_bins // 3
    elif kind == "clustered":             # few hot cells, dropped ids
        hot = rng.integers(0, num_bins, 5)
        ids = np.where(rng.random((rows, m)) < 0.8,
                       hot[rng.integers(0, 5, (rows, m))],
                       rng.integers(-2, num_bins + 2, (rows, m)))
    vals = rng.uniform(0.0, 1.0, (rows, m)).astype(np.float32)
    bad = (ids < 0) | (ids >= num_bins)
    vals[bad] = np.where(rng.random(int(bad.sum())) < 0.5, np.nan, np.inf)
    return ids.astype(np.int32), vals


def _check(got, ids, vals, num_bins):
    want = histogram_plain(torch.from_numpy(ids), torch.from_numpy(vals),
                           num_bins).numpy()
    ref = np.asarray(histogram_reference(jnp.asarray(ids), jnp.asarray(vals),
                                         num_bins))
    assert np.isfinite(got).all()
    for w in (want, ref):
        nz = w != 0
        assert (got[~nz] == 0).all()
        assert np.max(np.abs(got[nz] - w[nz]) / np.abs(w[nz])) <= 1e-5


@pytest.mark.parametrize("route,rows,m,num_bins", [
    ("row", 3, 1031, 300),
    ("row", 2, 4101, 257),
    ("row", 1, 5, 64),                    # a head and a tail only
    ("global", 3, 1031, 300),
    ("global", 1, 5, 64),
    ("global", 2, 700, 66048),            # above a block's shared memory
])
@pytest.mark.parametrize("kind", ["random", "runs32", "one_cell",
                                  "clustered"])
@pytest.mark.parametrize("buckets", [6, 0, 32])
def test_mirror_matches_plain_and_reference(route, rows, m, num_bins, kind,
                                            buckets, monkeypatch):
    """Also with the row route's hot-step test forced either way: 0
    buckets (every lane adds its own value) and 32 (every step through
    match-any)."""
    monkeypatch.setattr(sys.modules[__name__], "HOT_BUCKETS", buckets)
    ids, vals = _case(kind, rows, m, num_bins, seed=rows * 31 + m)
    got, visits = _mirror(ids, vals, num_bins, route)
    assert (visits == 1).all()
    _check(got, ids, vals, num_bins)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("a0,vec", [(1, True), (2, True), (3, True),
                                    (0, False)])
def test_mirror_alignment_peel(route, a0, vec):
    """Every start alignment (the head up to the 16-byte boundary) and
    the 4-byte path where ids and vals are aligned apart."""
    ids, vals = _case("clustered", 3, 517, 300, seed=a0)
    got, visits = _mirror(ids, vals, 300, route, a0=a0, vec=vec)
    assert (visits == 1).all()
    _check(got, ids, vals, 300)


def test_mirror_at_a_path_shape_by_its_own_route():
    """The north-live hop's shape, one row (cut to 4097 deposits: the
    route of (1, 16385, 20992) is the route of (1, 4097, 20992))."""
    assert route_of(1, 4097, 20992) == route_of(1, 16385, 20992) == "global"
    ids, vals = _case("clustered", 1, 4097, 20992, seed=5)
    got, visits = _mirror(ids, vals, 20992)
    assert (visits == 1).all()
    _check(got, ids, vals, 20992)


# ------------------------------------------------- the path above the cap
def test_relative_scatter_above_shared_memory_matches_jax():
    """fft_size 8192, hop 64: R = 64, (2R+1)·512 = 66,048 relative cells,
    above a block's shared memory.  The port's relative route (plain B2
    on the CPU, then the fold) against the JAX package's CPU path."""
    kw = dict(mode="enhanced", multires=False, fft_size=8192, hop=64,
              raster_height=512, smoothing=0.3)
    jp = JaxPipeline(JaxSettings(**kw))
    tp = Pipeline(Settings(scatter="pallas", **kw), "cpu")
    assert tp.reach == 64 and (2 * tp.reach + 1) * tp.rows == 66048
    frames = 200
    assert tp.use_relative_scatter and route_of(frames, 4097, 66048) == "global"
    sec = ((frames - 1) * 64 + 8192) / 48000.0
    rng = np.random.default_rng(8)
    x = (synth.chirp(150.0, 9000.0, sec)
         + synth.multitone([440.0, 1250.0], sec, amplitude=0.3))
    x = (x + 0.01 * rng.standard_normal(x.size)).astype(np.float32)
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    vis_j, _, _ = jp.process(x, jparams)
    vis_t, _, _ = tp.process(x, p)
    assert vis_t.shape == vis_j.shape == (frames, 512)
    power_j = jp._enhanced_power(jnp.asarray(x), frames, jparams)
    power_t = tp._enhanced_power(tp.to_device(x), frames, p)
    cmp = compare_grids(torch.from_numpy(np.array(power_j)), power_t)
    assert cmp.ok, cmp
    ok, worst, share = compare_vis(torch.from_numpy(np.array(vis_j)), vis_t)
    assert ok, (worst, share)
