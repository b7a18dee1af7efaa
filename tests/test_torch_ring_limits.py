"""B2's ring form past one CTA's shared memory, on the CPU: a live hop of
more deposits than one window of entries holds (every single-bank
enhanced setting above 32768 points), and a ring of more cells than one
cluster's CTAs hold (a short hop, a tall raster).

* ``ring_plan`` fits every live shape ``Settings`` allows up to the
  envelope — k ≤ 131,073 deposits a hop a lane, any odd P ≤ 16,385 slots,
  C ≤ 4,096 rows, 1–16 lanes — at every FFT size, with and without the
  card's 16-CTA clusters; a shape that fits one window and one band keeps
  the plan it had before windows and bands (a frozen copy of that
  ``ring_plan``), and every other takes windows or bands.
* The plan's shared memory is the ``.cu``'s own expression read from the
  source and evaluated, and its cells, staged chunks, windows and bands
  within the ``.cu``'s constants.
* ``_split_mirror`` follows ``ring_kernel`` in
  ``emspec_torch/csrc/histogram_ring.cu`` through windows and bands: each
  lane's ring cut into bands of B slots, a cluster (or S local CTAs) a
  band keeping the deposits that land in its band; the hop staged window
  by window, each rank its share of each window's chunks, every window's
  entries, groups (``__match_any_sync``), masks and walk as in one
  window; the rank's cells and touched flags kept across windows and
  stored once after the last.  With W and the bands forced small (at
  least 3 windows and 3 bands) it is bit for bit (tolerance 0)
  ``histogram_ring_plain`` of ``ring_ids`` at 1 and 3 lanes, t < R and
  t ≥ R, with NaN/±Inf behind dropped and out-of-range ids; walked with
  its windows in reverse it differs (the order is what is held).
* The port's CPU ``Stream`` at enhanced 65536, 96 kHz, mono, in
  777-sample pushes ≡ its batch bit for bit (one intra-op thread), and
  that batch within ``compare_vis`` of the JAX package's; at 8192, hop
  16 and 64, the deposits it and the JAX package place apart are float32
  rounding flips (float64 plain sides with one on ≥ 99%), and settled by
  float64 the batch is within ``compare_vis`` of the JAX package's.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch import kernels_build
from emspec_torch.config import FFT_SIZES, Settings
from emspec_torch.convert import params_from_jax
from emspec_torch.dsp.kernels.scatter import (
    RING_CELLS, RING_LOCAL_CHUNKS, RING_MAX_CLUSTER, RING_PORTABLE,
    RING_STAGE, SMEM_BYTES, SMS, TILE_WARPS, histogram_ring,
    histogram_ring_plain, ring_form, ring_ids, ring_plan)
from emspec_torch.pipeline import Pipeline
from emspec_torch.stream import Stream
from emspec_torch.validate import compare_vis

CU = (Path(kernels_build.__file__).parent / "csrc"
      / "histogram_ring.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


K_THREADS, K_MAX_STAGE = _const("kThreads"), _const("kMaxStage")
K_MAX_SMEM, K_MAX_CLUSTER = _const("kMaxSmem"), _const("kMaxCluster")
K_LONG_GROUP = _const("kLongGroup")
K_WARPS = K_THREADS // 32
CLUSTERS16 = 7          # 16-CTA clusters the H100 holds at these shapes
ENVELOPE = dict(k=131073, slots=16385, column=4096, lanes=16)
HOPS = (16, 64, 800, 0)            # 0: the default, a quarter of the frame
ROWS = (2, 512, 2048, 4096)
# the five shapes past one cluster's cells or shared memory at 8192–32768
# (fft size, hop, raster rows), and the three sizes past one window
CELL_LIMITS = ((8192, 16, 2048), (16384, 16, 512), (16384, 64, 2048),
               (32768, 64, 2048), (32768, 16, 512))
OLD_KEYS = ("cluster", "local", "rb", "cells", "chunks", "stage_chunks",
            "smem", "fits")


def _parent_ring_plan(k, slots, column, cluster=None, lanes=1, clusters16=0,
                      local=None):
    """``ring_plan`` as it was before windows and bands (frozen): one
    window of the whole hop, one band of every slot."""
    chunks = -(-k // 32)
    local = chunks <= RING_LOCAL_CHUNKS if local is None else local

    def plan(s):
        rb = -(-column // (TILE_WARPS * s)) * TILE_WARPS
        cells = slots * rb
        cs = chunks if local else -(-chunks // s)
        smem = 256 * chunks + 5 * ((cells + cells // 32 + 16) & ~15) \
            + 4 * chunks
        return dict(cluster=s, local=local, rb=rb, cells=cells,
                    chunks=chunks, stage_chunks=cs, smem=smem,
                    fits=0 < s <= RING_MAX_CLUSTER and s & (s - 1) == 0
                    and slots % 2 == 1 and cells <= RING_CELLS
                    and cs <= RING_STAGE and smem <= SMEM_BYTES)
    if cluster is not None:
        return plan(cluster)
    s = 1
    while s < RING_MAX_CLUSTER and not plan(s)["fits"]:
        s *= 2
    while (2 * s <= RING_MAX_CLUSTER and lanes * 2 * s <= SMS // 2
           and (2 * s <= RING_PORTABLE or local or clusters16 >= lanes)):
        s *= 2
    return plan(s)


def _live_shape(n: int, hop: int, rows: int) -> tuple:
    """(deposits a hop, slots, rows) of single-bank enhanced ``n`` at
    ``hop`` (0: its default) and ``rows`` raster rows: ``Pipeline.reach``'s
    formula."""
    s = Settings(mode="enhanced", multires=False, fft_size=n, hop=hop,
                 raster_height=rows)
    reach = int(np.round(n / (2.0 * s.hop_samples)))
    return n // 2 + 1, 2 * reach + 1, rows


def _cu_smem(window: int, cells: int) -> int:
    """``ring_args``' shared memory, the ``.cu``'s expression evaluated."""
    expr = re.search(r"const long long bytes = (.*?);", CU, re.S).group(1)
    expr = re.sub(r"(\d+)LL", r"\1", " ".join(expr.split()))
    return eval(expr.replace("a->window", "window"), {},
                dict(window=window, cells=cells))


def _check_plan(plan: dict, k: int, slots: int, column: int, lanes: int):
    """A plan within the ``.cu``'s limits and covering the hop and ring."""
    assert plan["fits"], plan
    s, w, band = plan["cluster"], plan["window"], plan["band_slots"]
    assert 0 < s <= K_MAX_CLUSTER and s & (s - 1) == 0
    assert plan["rb"] == -(-column // (16 * s)) * 16
    assert plan["cells"] == band * plan["rb"] <= 0xffff
    assert plan["smem"] == _cu_smem(w, plan["cells"]) <= K_MAX_SMEM
    assert plan["window_chunks"] == (w if plan["local"] else -(-w // s))
    assert plan["window_chunks"] <= K_MAX_STAGE * K_WARPS
    chunks = -(-k // 32)
    assert plan["chunks"] == chunks and 0 < w <= chunks
    assert (plan["windows"] - 1) * w < chunks <= plan["windows"] * w
    assert (plan["bands"] - 1) * band < slots <= plan["bands"] * band
    assert lanes * plan["bands"] * s < 2**31 and slots * column < 2**31


@pytest.mark.parametrize("n", FFT_SIZES)
def test_ring_plan_fits_every_live_shape_up_to_the_envelope(n):
    """Every hop of ``HOPS`` and raster height of ``ROWS`` at ``n``, 1 and
    16 lanes, without and with the card's 16-CTA clusters: the plan fits
    the kernel; it is the old plan wherever that one fitted, else windows
    or bands."""
    for hop in HOPS:
        for rows in ROWS:
            k, slots, column = _live_shape(n, hop, rows)
            for lanes in (1, 16):
                for c16 in (0, CLUSTERS16):
                    plan = ring_plan(k, slots, column, lanes=lanes,
                                     clusters16=c16)
                    _check_plan(plan, k, slots, column, lanes)
                    old = _parent_ring_plan(k, slots, column, lanes=lanes,
                                            clusters16=c16)
                    if old["fits"]:
                        assert {key: plan[key] for key in OLD_KEYS} == old
                        assert ring_form(plan) in ("local", "cluster")
                    else:
                        assert ring_form(plan) in ("windows", "bands"), plan


@pytest.mark.parametrize("lanes", [1, 2, 16])
@pytest.mark.parametrize("c16", [0, CLUSTERS16])
def test_ring_plan_fits_the_envelope_corners(lanes, c16):
    """k = 131,073 deposits (262144's spectrum), P = 16,385 slots (262144
    at hop 16), C = 4,096 rows, and each of them alone, at 1–16 lanes."""
    e = ENVELOPE
    for k in (1, 382, 4097, e["k"]):
        for slots in (1, 5, 513, e["slots"]):
            for column in (2, 512, e["column"]):
                plan = ring_plan(k, slots, column, lanes=lanes,
                                 clusters16=c16)
                _check_plan(plan, k, slots, column, lanes)
    assert ring_form(ring_plan(e["k"], e["slots"], e["column"],
                               lanes=lanes, clusters16=c16)) == "bands"


@pytest.mark.parametrize("n,hop,rows", CELL_LIMITS
                         + tuple((n, 0, 512) for n in (65536, 131072,
                                                       262144)))
def test_the_shapes_past_one_cta_fit(n, hop, rows):
    """The default hop above 32768 points (a hop of 32,769–131,073
    deposits: windows) and the five shapes past one cluster's cells or
    shared memory (bands), which the kernel refused: each fits, mono and
    16 lanes, and a forced cluster size of each power of two fits too."""
    k, slots, column = _live_shape(n, hop, rows)
    assert not _parent_ring_plan(k, slots, column, clusters16=CLUSTERS16)[
        "fits"]
    for lanes in (1, 16):
        plan = ring_plan(k, slots, column, lanes=lanes, clusters16=CLUSTERS16)
        _check_plan(plan, k, slots, column, lanes)
        assert ring_form(plan) in ("windows", "bands")
        if lanes == 1:
            assert (plan["bands"] > 1) == (n <= 32768), plan
            assert plan["windows"] > 1 or n <= 32768, plan
    for s in (1, 2, 4, 8, 16):
        _check_plan(ring_plan(k, slots, column, s), k, slots, column, 1)


def test_ring_plan_windows_and_bands_by_hand():
    """The split plan's choices: at 65536's default hop (1,025 chunks, 5 ×
    512 cells) two windows of 513 chunks and one band; at 8192, hop 16 and
    2,048 rows (513 × 2,048 cells) one window and two bands of 257 slots;
    windows and bands forced."""
    p = ring_plan(32769, 5, 512, clusters16=CLUSTERS16)
    assert (p["cluster"], p["windows"], p["window"], p["bands"]) == (16, 2,
                                                                     513, 1)
    p = ring_plan(32769, 5, 512)
    assert (p["cluster"], p["windows"]) == (RING_PORTABLE, 2)
    p = ring_plan(4097, 513, 2048, clusters16=CLUSTERS16)
    assert (p["cluster"], p["windows"], p["bands"], p["band_slots"]) == (
        16, 1, 2, 257)
    p = ring_plan(1500, 9, 40, 4, window=8, bands=3)
    assert (p["windows"], p["window"], p["window_chunks"], p["bands"],
            p["band_slots"]) == (6, 8, 2, 3, 3)
    p = ring_plan(1500, 9, 40, 4, local=True, window=8)
    assert p["window_chunks"] == 8 and p["bands"] == 1
    assert not ring_plan(1500, 9, 40, 1, window=RING_STAGE + 1)["fits"]
    assert not ring_plan(1500, 9, 40, 1, window=48)["fits"]    # > chunks


def test_the_cu_takes_the_plan_as_the_wrapper_passes_it():
    """The C entry points take the window and the band's slots, and the
    ``.cu`` checks what ``_check_plan`` holds."""
    for name in ("emspec_histogram_ring", "emspec_histogram_ring_occupancy"):
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', CU).group(1)
        args = [a.split()[-1].lstrip("*") for a in sig.split(",")]
        assert len(args) == len(kernels_build._SIGNATURES[name])
        assert args[-3:-1] == ["window", "band"]
    assert "cells > 0xffff || a->share > kMaxStage * kWarps" in CU
    assert "bytes > kMaxSmem" in CU
    assert "a->share = local ? W : (W + S - 1) / S;" in CU
    assert "a->bands = (P + B - 1) / B;" in CU
    assert "a->rb = (C + 16 * S - 1) / (16 * S) * 16;" in CU
    assert K_MAX_CLUSTER == RING_MAX_CLUSTER and K_MAX_SMEM == SMEM_BYTES
    assert K_MAX_STAGE * K_WARPS == RING_STAGE


# ------------------------------------------------ the schedule, mirrored
def _groups(key):
    """Each chunk's groups of lanes with equal keys (__match_any_sync):
    the lowest lane, the length, the next lane (−1 at the end)."""
    same = key[:, :, None] == key[:, None, :]
    lead = same.argmax(-1)
    above = same & (np.arange(32)[None, None, :]
                    > np.arange(32)[None, :, None])
    return lead, same.sum(-1), np.where(above.any(-1), above.argmax(-1), -1)


def _split_mirror(ids, vals, ring, t, plan, reverse=False):
    """``ring_kernel`` in numpy through its windows and bands (module
    docstring), lane by lane, band by band, rank by rank, window by window
    (in reverse with ``reverse``) → (the ring after the hop, stores a
    cell)."""
    P, C, K = ring.shape[0], ring.shape[-1], ids.shape[-1]
    lanes = ring[0].numel() // C
    S, rb, chunks = plan["cluster"], plan["rb"], plan["chunks"]
    W, share, B = plan["window"], plan["window_chunks"], plan["band_slots"]
    log_s, R, cells = S.bit_length() - 1, P // 2, plan["cells"]
    out = ring.numpy().reshape(-1).copy()
    stores = np.zeros(out.size, np.int64)
    i2 = ids.reshape(lanes, -1).numpy().astype(np.int64)
    v2 = vals.reshape(lanes, -1).numpy().astype(np.float32)
    pad = chunks * 32 - K
    slot_of, j_of = np.divmod(np.arange(cells), rb)
    windows = list(range(0, chunks, W))
    for c0 in windows:          # each rank's share of each window's chunks
        wn = min(W, chunks - c0)
        staged = np.zeros(wn, np.int64)
        for rank in range(1 if plan["local"] else S):
            lo = c0 + (0 if plan["local"] else rank * share)
            hi = c0 + wn if plan["local"] else min(lo + share, c0 + wn)
            if hi > lo:
                assert hi - lo <= share <= K_MAX_STAGE * K_WARPS
                staged[lo - c0:hi - c0] += 1
        assert (staged == 1).all()
    for lane_row in range(lanes):
        rid = np.concatenate([i2[lane_row], np.full(pad, -1)])
        rv = np.concatenate([v2[lane_row], np.zeros(pad, np.float32)])
        ok = (rid >= 0) & (rid < P * C)
        d = np.where(ok, rid, 0) // C
        row = np.where(ok, rid, 0) - d * C
        col = t + d - R
        ok &= col >= 0
        slot = np.where(ok, col, 0) % P
        g = row >> 3
        for b in range(plan["bands"]):
            lo_slot = b * B
            ls = slot - lo_slot
            mine_band = ok & (ls >= 0) & (ls < B)
            owner = np.where(mine_band, g & (S - 1), -1)
            cell = np.where(mine_band, ls * rb + ((g >> log_s) << 3)
                            + (row & 7), 0)
            assert (cell[mine_band] < cells).all() and (cell <= 0xfffe).all()
            key = np.where(mine_band, (owner << 16) | cell, -1).reshape(
                chunks, 32)
            lead, length, nxt = _groups(key)
            for o in range(S):
                rows_o = ((j_of >> 3) << (3 + log_s)) | (o << 3) | (j_of & 7)
                gslot = lo_slot + slot_of
                offs = np.where((rows_o < C) & (gslot < P),
                                (gslot * lanes + lane_row) * C + rows_o, -1)
                tile = np.where(offs >= 0, out[np.maximum(offs, 0)], np.nan
                                ).astype(np.float32)
                touched = np.zeros(cells, bool)
                mine = (owner == o).reshape(chunks, 32)
                for c0 in (windows[::-1] if reverse else windows):
                    for c in range(c0, min(c0 + W, chunks)):
                        for ln in np.flatnonzero(mine[c]
                                                 & (lead[c] == np.arange(32))):
                            base = c * 32
                            cl = cell[base + ln]
                            acc = np.float32(tile[cl] + rv[base + ln])
                            if length[c, ln] - 1 >= K_LONG_GROUP:
                                for jl in range(ln + 1, 32):
                                    if mine[c, jl] and lead[c, jl] == ln:
                                        acc = np.float32(acc + rv[base + jl])
                            else:
                                nx = nxt[c, ln]
                                while nx >= 0:
                                    acc = np.float32(acc + rv[base + nx])
                                    nx = nxt[c, nx]
                            tile[cl] = acc
                            touched[cl] = True
                for i in np.flatnonzero(touched):
                    assert offs[i] >= 0
                    out[offs[i]] = tile[i]
                    stores[offs[i]] += 1
    return (torch.from_numpy(out.reshape(ring.shape)),
            torch.from_numpy(stores.reshape(ring.shape)))


def _hot_hop(lanes, K, P, C, seed):
    """``lanes`` lanes of K relative ids into P × C cells: a third on one
    hot cell, a run of 200 equal ids (groups longer than kLongGroup), the
    rest uniform; values 1e-3 … 1e3 of both signs; a tenth of the ids −1
    or past P·C with NaN, +Inf or −Inf behind them."""
    rng = np.random.default_rng(seed)
    shape = (lanes, K) if lanes > 1 else (K,)
    ids = rng.integers(0, P * C, shape)
    ids = np.where(rng.random(shape) < 0.33, (P // 2) * C + C - 3, ids)
    ids[..., 300:500] = (P // 2 + 1) * C + 2
    vals = 10.0 ** rng.uniform(-3, 3, shape) * rng.choice([-1.0, 1.0], shape)
    pick = rng.random(shape) < 0.1
    far = rng.integers(P * C, P * C + 50, shape)
    ids = np.where(pick, np.where(rng.random(shape) < 0.5, -1, far), ids)
    vals = np.where(pick, rng.choice([np.nan, np.inf, -np.inf], shape),
                    vals)
    base = rng.standard_normal((P,) + shape[:-1] + (C,))
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(base.astype(np.float32)))


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("cluster,local,window,bands", [
    (4, False, 8, 3), (1, False, 5, 4), (16, False, 6, 3), (2, False, 16, 5),
    (4, True, 9, 3), (1, True, 3, 5)])
def test_split_mirror_is_the_plain_sum(lanes, cluster, local, window, bands):
    """1,500 deposits (47 chunks) into 9 × 40 cells a lane, R = 4, in
    windows of a few chunks and bands of a few slots, forced: bit for bit
    the plain sum at t < R and t ≥ R (the slot wrap), every touched cell
    stored once, no NaN or Inf landed; the windows walked in reverse give
    other bits."""
    K, P, C = 1500, 9, 40
    ids, vals, base = _hot_hop(lanes, K, P, C, seed=cluster + 7 * window)
    plan = ring_plan(K, P, C, cluster, lanes, local=local, window=window,
                     bands=bands)
    assert plan["fits"] and plan["windows"] >= 3 and plan["bands"] >= 3
    assert ring_form(plan) == "bands"
    differ = 0
    for t in (2, 4, 11, 40):
        want = histogram_ring_plain(ring_ids(ids, t, P, C), vals,
                                    base.clone())
        got, stores = _split_mirror(ids, vals, base, t, plan)
        assert torch.equal(got, want), t
        assert torch.equal(histogram_ring(ids, vals, base.clone(), t), want)
        assert torch.isfinite(got).all()
        assert (stores <= 1).all() and (stores[got != base] == 1).all()
        rev, _ = _split_mirror(ids, vals, base, t, plan, reverse=True)
        differ += int((rev != want).sum())
    assert differ > 0


def test_split_mirror_at_a_real_hop_of_65536():
    """B1's relative ids of a 65536-point hop at 96 kHz (32,769 deposits),
    the plan the card takes there (two windows of 513 chunks, clusters of
    16), t = 0 and past the wrap: the mirror bit-equal to the plain sum."""
    s = Settings(mode="enhanced", multires=False, fft_size=65536,
                 sample_rate=96000)
    pipe = Pipeline(s, "cpu")
    x = torch.from_numpy(_chirp(pipe.n_max, s.sample_rate, seed=3))
    rel, vals = pipe._deposit_ids_rel(pipe._bank_windows(x), pipe.params())
    P, C = 2 * pipe.reach + 1, pipe.rows
    plan = ring_plan(rel.shape[-1], P, C, clusters16=CLUSTERS16)
    assert (plan["cluster"], plan["windows"]) == (16, 2)
    base = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1e-6, (P, C)).astype(np.float32))
    for t in (0, P + 3):
        got, stores = _split_mirror(rel, vals, base, t, plan)
        want = histogram_ring_plain(ring_ids(rel, t, P, C), vals,
                                    base.clone())
        assert torch.equal(got, want) and (stores <= 1).all()
        assert int((got != base).sum()) > 100


# ---------------------------------------- the live path at 65536 points
def _chirp(samples, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    return (0.5 * np.sin(2 * np.pi * (150.0 * t + 1500.0 * t * t))
            + 0.2 * np.sin(2 * np.pi * 440.0 * t)
            + 0.01 * rng.standard_normal(samples)).astype(np.float32)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_stream_at_65536_is_the_batch_and_the_jax_batch(one_thread):
    """Enhanced 65536 at 96 kHz, mono, the default hop (16,384; a hop of
    32,769 deposits, which the card sums in windows): the port's CPU
    ``Stream`` in 777-sample pushes ≡ its ``process`` bit for bit in vis
    and rgba, and that batch within ``compare_vis`` of the JAX batch."""
    kw = dict(mode="enhanced", multires=False, fft_size=65536,
              sample_rate=96000)
    s = Settings(**kw)
    pipe = Pipeline(s, "cpu")
    x = _chirp(pipe.n_max + 9 * pipe.hop, s.sample_rate, seed=5)
    st = Stream(s, "cpu")
    cols = []
    for i in range(0, x.size, 777):
        cols += st.push(x[i:i + 777])
    cols += st.flush()
    vis_b, rgba_b, _ = pipe.process(x)
    assert [c.index for c in cols] == list(range(vis_b.shape[0])) \
        and vis_b.shape[0] == 10
    assert torch.equal(torch.stack([c.vis for c in cols]), vis_b)
    assert torch.equal(torch.stack([c.rgba for c in cols]), rgba_b)
    jp = JaxPipeline(JaxSettings(**kw))
    jparams = jp.params()
    vis_j, _, _ = jp.process(x, jparams)
    vis_t, _, _ = pipe.process(x, params_from_jax(jparams, "cpu"))
    assert vis_t.shape == tuple(np.shape(vis_j))
    ok, worst, share = compare_vis(torch.from_numpy(np.array(vis_j)), vis_t)
    assert ok, (worst, share)
    assert math.isfinite(float(vis_b.sum())) and float(vis_b.max()) > 0


@pytest.mark.parametrize("hop,rows,seconds", [(16, 2048, 0.3), (64, 512, 1.0)])
def test_short_hop_batch_against_jax_moves_deposits_as_often_as_1_over_hop(
        one_thread, hop, rows, seconds):
    """Enhanced 8192 at a short hop: the port's CPU batch against the JAX
    package's.  A short hop samples Δt/hop's rounding boundaries finely,
    so the two float32 paths place more deposits apart (9.1e-4 of the
    valid ones at hop 16, 2.2e-4 at hop 64: 4.2×, as 1/hop; printed with
    ``-s``).  Float64 plain (``deposits_ids_plain`` on the frames in
    float64) explains a deposit placed apart where it sides with one path
    in its row and in its column offset, or, where one path drops it,
    drops it too or keeps it where the other does: ≥ 99% of them, and
    each other one at least 60 dB below the loudest deposit (near the
    power floor, where Δt/hop is ill-conditioned).  Where it places a
    deposit as JAX does the port's is settled to it, and the batch from
    those deposits is within ``compare_vis``'s default share of the JAX
    batch — as ``chip_smoke.py``'s ``live_large`` holds the card against
    the CPU path."""
    import jax.numpy as jnp

    from emspec_torch.dsp.kernels.deposits import deposits_ids_plain
    from emspec_torch.post.chain import PostState, postprocess_batch

    kw = dict(mode="enhanced", multires=False, fft_size=8192, hop=hop,
              raster_height=rows)
    x = _chirp(int(seconds * 48000), 48000, seed=8)
    jp = JaxPipeline(JaxSettings(**kw))
    jparams = jp.params()
    vis_j, _, _ = jp.process(x, jparams)
    vis_j = torch.from_numpy(np.array(vis_j))
    pipe = Pipeline(Settings(**kw), "cpu")
    p = params_from_jax(jparams, "cpu")
    t = pipe.num_columns(x.size)
    inputs = pipe._bank_inputs(pipe.to_device(x), t)
    ip, cp = pipe._deposit_ids_rel(inputs, p)
    ij, cj = (torch.from_numpy(np.array(a)) for a in jp._deposit_ids_rel(
        jp._bank_inputs(jnp.asarray(x), t), jparams))
    i64, c64 = deposits_ids_plain(
        inputs[0].double(), p.logmap_a, p.logmap_b, p.power_floor, n=8192,
        hop=hop, sr=48000.0, rows=pipe.rows, reach=pipe.reach)
    vj, vp, v64 = cj > 0, cp > 0, c64 > 0
    apart = ~(((ij == ip) & vj & vp) | (~vj & ~vp))
    jax64 = apart & (ij == i64) & (vj == v64)
    C = pipe.rows

    def sides(part):            # float64 with one path in one coordinate
        return (part(i64) == part(ij)) | (part(i64) == part(ip))
    explained = apart & torch.where(
        vj == vp, v64 & sides(lambda i: i % C) & sides(lambda i: i // C),
        ~v64 | (i64 == torch.where(vj, ij, ip)))
    loud = float(torch.where(apart & ~explained, torch.maximum(cj, cp),
                             0.0).max()) / float(cj.max())
    ip = torch.where(jax64, i64, ip)
    cp = torch.where(jax64, c64.float(), cp)
    grid = pipe._scatter_absolute(pipe._absolute_ids(ip, t, pipe.reach), cp,
                                  t, exact=True)
    vis_s, _ = postprocess_batch(grid.movedim(-2, 0).contiguous(),
                                 PostState.init((pipe.rows,), "cpu"), p.post,
                                 pipe.settings.agc_global)
    _, _, raw = compare_vis(vis_j, pipe.process(x, p)[0])
    ok, worst, share = compare_vis(vis_j, vis_s)
    print(f"8192 at hop {hop}, {rows} rows: {int(apart.sum())} of "
          f"{int(vp.sum())} valid deposits apart "
          f"({int(apart.sum()) / int(vp.sum()):.3g}), float64 explains them "
          f"on {int(explained.sum())} (with JAX on {int(jax64.sum())}; the "
          f"loudest other {loud:.2e} of the loudest); {raw:.3g} of the "
          f"cells over 2/255, settled {share:.3g}, max {worst:.3g}")
    assert int(explained.sum()) >= 0.99 * int(apart.sum())
    assert loud <= 1e-6
    assert ok, (worst, share)
