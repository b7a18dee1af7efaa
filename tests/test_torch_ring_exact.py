"""Equal runs on the card's defaults: B2's ring form and the ordered
sums, on the CPU.

* ``_ring_mirror`` follows ``ring_kernel`` in ``emspec_torch/csrc/
  histogram_ring.cu`` step by step: S CTAs a lane, rank o owning the
  rows in 8-row groups g with g mod S = o, local row j = (g div S)·8 +
  row mod 8, local cell slot·rb + j owned by warp j mod 16; each rank's
  share of the hop (cs chunks, one warp a chunk, at most kMaxStage a
  warp: a cluster's 1/S, or in the local form the whole hop, each rank
  keeping its own deposits); each deposit's ring cell computed from its relative
  id and t (the drop of an id outside [0, P·C) and of a column below 0,
  the slot wrap), its group in its chunk (__match_any_sync), the entry
  word (cell, next lane, lowest lane, length) stored at the owner; each
  chunk's mask by owner; each warp's walk over its chunks in bin order,
  each group's lowest lane adding the group's values in lane order (the
  next-lane chain, or the unrolled shuffles where a warp holds a long
  group); the touched cells stored once.  It must be bit for bit
  (tolerance 0) an ordered float32 loop — every cell adding its deposits
  one after another in deposit order onto the value it holds — and
  ``histogram_ring_plain`` of ``ring_ids``, at the six live cells' shapes
  on the ids a real hop makes there (one lane, 16 at the stress cell),
  at t from 0 through the slot wrap, with ids of −1 and out of range
  carrying NaN/Inf, and a ring that is not zero; every touched cell
  stored once, no other cell written.  Also against the JAX step's ring
  update (its relative histogram rolled into the ring) within 1e-6
  relative: the same sum in another order.
* ``ring_plan`` at those shapes, against the ``.cu``'s limits.
* The default ``Stream`` on the CPU gives ``Stream(exact_sums=False)``'s
  columns bit for bit and ``Pipeline.process()``'s (the JAX invariant,
  streaming ≡ batch), with ``scatter="pallas"`` too (where
  ``exact_sums=False`` takes the relative histogram); its step reads no
  tensor's value on the host, so the card's graph captures it.
* Spies on the pipeline's ``histogram`` and ``histogram_ring`` pin who
  asks for which sums: the CLI's ``stream``, ``render.animate``'s frames,
  ``TimeParallelRenderer.render``, the app, ``stream_signal`` and
  ``ShardedStream`` the ordered forms by default; ``exact_sums=False``
  B2's atomic routes.
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.dsp.pallas.scatter import histogram_reference
from emspec_torch import kernels_build
from emspec_torch import parallel
from emspec_torch import pipeline as pl
from emspec_torch.__main__ import main as cli_main
from emspec_torch.app import EmSpecApp
from emspec_torch.config import Settings
from emspec_torch.dsp.kernels.scatter import (
    RING_CELLS, RING_LOCAL_CHUNKS, RING_MAX_CLUSTER, RING_PORTABLE,
    RING_STAGE, SMEM_BYTES, SMS,
    SORTED, TILE_WARPS, histogram, histogram_ring, histogram_ring_plain,
    ring_ids, ring_plan)
from emspec_torch.io.wav import write_wav
from emspec_torch.render.animate import animate_frames
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.validate import compare_vis

CSRC = Path(kernels_build.__file__).parent / "csrc"
SR = 48_000
# the six live cells: settings, and the hop's deposits, slots and lanes
CELLS = {
    "live": (Settings(mode="enhanced", multires=False, fft_size=8192),
             4097, 5, 1),
    "direct_live": (Settings(mode="enhanced", multires=False, fft_size=8192,
                             fft_method="direct"), 4097, 5, 1),
    "multires_live": (Settings(), 382, 65, 1),
    "north_live": (Settings(mode="enhanced", multires=False,
                            fft_size=32768, hop=800), 16385, 41, 1),
    "stress_live": (Settings(mode="enhanced", multires=False,
                             fft_size=32768, sample_rate=96000,
                             channels=16), 16385, 5, 16),
    "wide_live": (Settings(mode="enhanced", multires=False, fft_size=8192,
                           hop=64), 4097, 129, 1),
}
CU = (CSRC / "histogram_ring.cu").read_text()
K_MAX_STAGE = int(re.search(r"kMaxStage = (\d+);", CU).group(1))
K_LONG_GROUP = int(re.search(r"kLongGroup = (\d+);", CU).group(1))
K_THREADS = int(re.search(r"kThreads = (\d+);", CU).group(1))
CLUSTERS16 = 7          # 16-CTA clusters the H100 holds at these shapes


def _audio(seconds, channels=1, seed=0, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = [(0.5 * np.sin(2 * np.pi * (150.0 + 90 * c) * t
                         + 2 * np.pi * 3000.0 * t * t)
            + 0.2 * np.sin(2 * np.pi * 440.0 * t)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
           for c in range(channels)]
    return out[0] if channels == 1 else np.stack(out)


def _hop_ids(settings, t, seed=0):
    """B1's relative ids (δ + R)·rows + row and contrib of hop ``t`` of
    ``settings``' live step on the CPU, lanes leading; the pipeline."""
    pipe = pl.Pipeline(settings, "cpu")
    sr, n = settings.sample_rate, pipe.n_max
    lead = (settings.channels,) if settings.channels > 1 else ()
    x = _audio((n + (t + 1) * pipe.hop) / sr + 0.01, settings.channels,
               seed, sr)
    x = torch.from_numpy(np.asarray(x)[..., t * pipe.hop:t * pipe.hop + n])
    p = pipe.params()
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_windows(x), p)
    assert ids_rel.shape == lead + (ids_rel.shape[-1],)
    assert ids_rel.dtype == torch.int32 and (ids_rel >= 0).any()
    return ids_rel.contiguous(), contrib.contiguous(), pipe


def _spoil(ids, vals, P, C, seed):
    """A tenth of the ids dropped (−1) or out of range (P·C and above),
    NaN or Inf behind each: none of them may land."""
    rng = np.random.default_rng(seed)
    ids, vals = ids.clone(), vals.clone()
    pick = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.1)
    far = torch.from_numpy(rng.integers(P * C, P * C + 50,
                                        tuple(ids.shape)).astype(np.int32))
    half = torch.from_numpy(rng.random(tuple(ids.shape)) < 0.5)
    ids = torch.where(pick, torch.where(half, -1, far), ids)
    bad = torch.where(half, float("nan"), float("inf"))
    vals = torch.where((ids < 0) | (ids >= P * C), bad, vals)
    return ids, vals


def _ordered(ids, vals, ring):
    """Each cell adds its lane's deposits (ring ids) one after another in
    deposit order, float32, onto the value it holds."""
    P, C = ring.shape[0], ring.shape[-1]
    lanes = ring[0].numel() // C
    out = ring.numpy().reshape(P, lanes, C).copy()
    i2 = ids.reshape(lanes, -1).numpy()
    v2 = vals.reshape(lanes, -1).numpy()
    for lane in range(lanes):
        for i, v in zip(i2[lane].tolist(), v2[lane].tolist()):
            if 0 <= i < P * C:
                s, r = divmod(i, C)
                out[s, lane, r] = np.float32(out[s, lane, r] + np.float32(v))
    return torch.from_numpy(out.reshape(ring.shape))


def _cell_walk(rb, cells):
    """``CellWalk``: each thread's (slot, j) of i = thread + n·kThreads,
    advanced without a division → (slot, j) of every cell in i order."""
    slot, j = np.zeros(cells, np.int64), np.zeros(cells, np.int64)
    for th in range(min(K_THREADS, cells)):
        s, jj, q, r = th // rb, th % rb, K_THREADS // rb, K_THREADS % rb
        for i in range(th, cells, K_THREADS):
            slot[i], j[i] = s, jj
            jj, s = jj + r, s + q
            if jj >= rb:
                jj, s = jj - rb, s + 1
    return slot, j


def _ring_mirror(ids, vals, ring, t, cluster=None, clusters16=CLUSTERS16,
                 local=None):
    """``ring_kernel`` in numpy, rank by rank and warp by warp (module
    docstring); ids are relative ids of frame ``t`` → (the ring after the
    hop, stores a cell, the walk's steps on each path)."""
    P, C, K = ring.shape[0], ring.shape[-1], ids.shape[-1]
    lanes = ring[0].numel() // C
    plan = ring_plan(K, P, C, cluster, lanes, clusters16, local)
    assert plan["fits"]
    S, rb, chunks, cs = (plan["cluster"], plan["rb"], plan["chunks"],
                         plan["stage_chunks"])
    log_s, R = S.bit_length() - 1, P // 2
    assert 1 << log_s == S and cs <= K_MAX_STAGE * 16
    slot_of, j_of = _cell_walk(rb, plan["cells"])
    assert (slot_of * rb + j_of == np.arange(plan["cells"])).all()
    out = ring.numpy().reshape(-1).copy()
    stores = np.zeros(out.size, np.int64)
    paths = {"chain": 0, "unrolled": 0}
    i2 = ids.reshape(lanes, -1).numpy().astype(np.int64)
    v2 = vals.reshape(lanes, -1).numpy().astype(np.float32)
    pad = chunks * 32 - K
    for lane_row in range(lanes):
        rid = np.concatenate([i2[lane_row], np.full(pad, -1)])
        rv = np.concatenate([v2[lane_row], np.zeros(pad, np.float32)])
        # 2. each deposit's cell and owner, staged by warp (k div 32 −
        # rank·cs) mod 16 of rank k div 32 div cs (every rank, the whole
        # hop, in the local form), its slot below kMaxStage
        ch = np.arange(chunks * 32) // 32
        assert ((ch - (ch // cs) * cs) // 16 < K_MAX_STAGE).all()
        assert not plan["local"] or cs == chunks
        ok = (rid >= 0) & (rid < P * C)
        d = np.where(ok, rid, 0) // C
        row = np.where(ok, rid, 0) - d * C
        col = t + d - R
        ok &= col >= 0
        g = row >> 3
        owner = np.where(ok, g & (S - 1), -1)
        cell = np.where(ok, (np.maximum(col, 0) % P) * rb
                        + ((g >> log_s) << 3) + (row & 7), 0)
        assert (cell[ok] < plan["cells"]).all() and (cell <= 0xfffe).all()
        key = np.where(ok, (owner << 16) | cell, -1).reshape(chunks, 32)
        same = key[:, :, None] == key[:, None, :]          # the groups
        lead = same.argmax(-1)
        length = same.sum(-1)
        above = same & (np.arange(32)[None, None, :] >
                        np.arange(32)[None, :, None])
        nxt = np.where(above.any(-1), above.argmax(-1), -1)
        masks = np.zeros((S, chunks), np.int64)
        for k in np.flatnonzero(ok):
            masks[owner[k], k >> 5] |= 1 << int(cell[k] & 15)
        for o in range(S):
            # the rank's cells from the ring (rows below C), its entries
            rows_o = ((j_of >> 3) << (3 + log_s)) | (o << 3) | (j_of & 7)
            offs = np.where(rows_o < C, (slot_of * lanes + lane_row) * C
                            + rows_o, -1)
            tile = np.where(offs >= 0, out[np.maximum(offs, 0)], np.nan
                            ).astype(np.float32)
            touched = np.zeros(plan["cells"], bool)
            mine = (owner == o).reshape(chunks, 32)
            for w in range(16):                           # 3. the walk
                for c in range(chunks):
                    if not (masks[o, c] >> w) & 1:
                        continue
                    base = c * 32
                    own = mine[c] & ((cell[base:base + 32] & 15) == w)
                    leaders = own & (lead[c] == np.arange(32))
                    long = (leaders & (length[c] - 1 >= K_LONG_GROUP)).any()
                    paths["unrolled" if long else "chain"] += 1
                    for ln in np.flatnonzero(leaders):
                        cl = cell[base + ln]
                        acc = np.float32(tile[cl] + rv[base + ln])
                        if long:                  # lanes j > ln, lead ln
                            for jl in range(ln + 1, 32):
                                if mine[c, jl] and lead[c, jl] == ln:
                                    acc = np.float32(acc + rv[base + jl])
                        else:                     # the next-lane chain
                            nx = nxt[c, ln]
                            while nx >= 0:
                                acc = np.float32(acc + rv[base + nx])
                                nx = nxt[c, nx]
                        tile[cl] = acc
                        touched[cl] = True
            for i in np.flatnonzero(touched):             # 4. the store
                assert offs[i] >= 0
                out[offs[i]] = tile[i]
                stores[offs[i]] += 1
    return (torch.from_numpy(out.reshape(ring.shape)),
            torch.from_numpy(stores.reshape(ring.shape)), paths)


def _base(P, lanes, C, seed):
    rng = np.random.default_rng(seed)
    shape = (P,) + ((lanes,) if lanes > 1 else ()) + (C,)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _hop_ts(P):
    """Frames t from 0 (every column t + δ < 0 for δ < 0 dropped) past the
    slot wrap (t ≥ P), and far along."""
    R = P // 2
    return sorted({0, 1, max(R - 1, 0), R, P - 1, P, P + 1, 2 * P + 3,
                   100_003})


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_ring_form_mirror_is_the_ordered_sum_at_the_live_cells(cell):
    settings, K, P, lanes = CELLS[cell]
    rel, vals, pipe = _hop_ids(settings, 7, seed=len(cell))
    assert (rel.shape[-1], 2 * pipe.reach + 1,
            rel[..., 0].numel()) == (K, P, lanes)
    C = pipe.rows
    rel, vals = _spoil(rel, vals, P, C, seed=K)
    assert torch.isnan(vals).any() and torch.isinf(vals).any()
    base = _base(P, lanes, C, seed=P)
    ts = _hop_ts(P) if lanes == 1 else [0, P + 1]
    for t in ts:
        ids = ring_ids(rel, t, P, C)
        assert torch.equal(ids, ring_ids(rel, torch.tensor(t), P, C))
        want = _ordered(ids, vals, base)
        got, stores, paths = _ring_mirror(rel, vals, base, t)
        assert torch.equal(got, want), t
        assert torch.equal(histogram_ring_plain(ids, vals, base.clone()),
                           want)
        assert torch.equal(histogram_ring(rel, vals, base.clone(), t), want)
        assert torch.equal(histogram_ring(rel, vals, base.clone(),
                                          torch.tensor(t, dtype=torch.int32)),
                           want)
        assert torch.isfinite(got).all()
        assert (stores <= 1).all() and (stores[got != base] == 1).all()
        # a stored cell is one the hop's valid ids name, of its own lane
        flat = set()
        i2 = ids.reshape(lanes, -1)
        for lane in range(lanes):
            for i in i2[lane].tolist():
                if 0 <= i < P * C:
                    flat.add((i // C * lanes + lane) * C + i % C)
        assert set(np.flatnonzero(stores.reshape(-1).numpy()).tolist()) \
            == flat
        if t == 0:            # no column below 0 lands
            assert (ids[rel < pipe.reach * C] == -1).all()
    if lanes == 1:
        assert paths["chain"] > 0


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_ring_form_mirror_at_forced_bands_with_hot_cells(cluster):
    """Two lanes of 1,500 relative ids into 9 × 40 cells a lane, a third of
    them on one hot cell and runs of equal cells across chunks (groups
    longer than kLongGroup), values 1e-3 … 1e3 of both signs, at t before
    and past the wrap: bit for bit the ordered sum at every count of
    blocks a lane (the CTAs of its cluster, forced)."""
    rng = np.random.default_rng(cluster)
    P, C, K, lanes = 9, 40, 1500, 2
    ids = rng.integers(0, P * C, (lanes, K))
    ids = np.where(rng.random((lanes, K)) < 0.33, 3 * C + 17, ids)
    ids[:, 200:400] = 5 * C + 2                       # a run of 200
    ids = torch.from_numpy(ids.astype(np.int32))
    vals = torch.from_numpy((10.0 ** rng.uniform(-3, 3, (lanes, K))
                             * rng.choice([-1.0, 1.0], (lanes, K))
                             ).astype(np.float32))
    ids, vals = _spoil(ids, vals, P, C, seed=cluster)
    base = _base(P, lanes, C, seed=cluster + 1)
    for local in (False, True):
        paths = {"chain": 0, "unrolled": 0}
        for t in (2, 11, 40):
            got, stores, p = _ring_mirror(ids, vals, base, t, cluster,
                                          local=local)
            assert torch.equal(got, _ordered(ring_ids(ids, t, P, C), vals,
                                             base))
            assert (stores <= 1).all()
            paths = {k: paths[k] + p[k] for k in paths}
        assert paths["chain"] > 0 and paths["unrolled"] > 0


def test_ring_ids_drop_what_the_kernel_drops():
    """``ring_ids`` (the plain version's input): −1 for an id below 0 or
    at P·C and above, and for a column t + δ below 0; slot (t + δ) mod P."""
    P, C = 5, 4
    rel = torch.tensor([-1, 0, 3, 4, 7, 8, 19, 20, 33], dtype=torch.int32)
    assert ring_ids(rel, 0, P, C).tolist() == [-1, -1, -1, -1, -1, 0, 11,
                                               -1, -1]
    assert ring_ids(rel, 1, P, C).tolist() == [-1, -1, -1, 0, 3, 4, 15,
                                               -1, -1]
    assert ring_ids(rel, 6, P, C).tolist() == [-1, 16, 19, 0, 3, 4, 15,
                                               -1, -1]


def test_ring_plan_at_the_live_cells_and_the_cu_limits():
    src = (CSRC / "histogram_ring.cu").read_text()
    assert f"kMaxCluster = {RING_MAX_CLUSTER};" in src
    assert f"kMaxSmem = {SMEM_BYTES};" in src
    assert RING_STAGE == K_MAX_STAGE * TILE_WARPS and K_THREADS == 32 * TILE_WARPS
    assert "cells > 0xffff" in src and RING_CELLS == 0xffff
    assert ("bytes = 256LL * a->window\n"
            "                          + 5 * ((cells + (cells >> 5) + 16) & ~15LL)\n"
            "                          + 4LL * a->window;") in src
    sig = re.search(r'extern "C" int emspec_histogram_ring\(([^)]*)\)', src)
    argc = len(sig.group(1).split(","))
    assert argc == len(kernels_build._SIGNATURES["emspec_histogram_ring"])
    occ = re.search(r'extern "C" int emspec_histogram_ring_occupancy\('
                    r'([^)]*)\)', src)
    assert len(occ.group(1).split(",")) == len(
        kernels_build._SIGNATURES["emspec_histogram_ring_occupancy"])
    # the largest cluster that fits, 16 where the card holds one a lane;
    # 16 lanes take at most half the SMs; a hop of at most 16 chunks (the
    # display default's 382 deposits) in the local form, 16 CTAs a lane
    for cell, (_, K, P, lanes) in CELLS.items():
        plan = ring_plan(K, P, 512, lanes=lanes, clusters16=CLUSTERS16)
        assert plan["fits"], cell
        assert plan["cluster"] == (4 if lanes == 16 else 16), cell
        assert plan["local"] == (cell == "multires_live")
        assert lanes * plan["cluster"] <= SMS // 2
        assert ring_plan(K, P, 512, lanes=lanes)["cluster"] == (
            4 if lanes == 16 else 16 if plan["local"] else RING_PORTABLE)
        assert plan["cells"] == P * 512 // plan["cluster"]
    assert RING_LOCAL_CHUNKS == 16
    assert ring_plan(512, 65, 512)["local"]
    assert not ring_plan(513, 65, 512)["local"]
    assert ring_plan(16385, 5, 512, 4, local=True)["stage_chunks"] == 513
    for K, P in ((4097, 5), (16385, 41), (382, 65), (4097, 129)):
        assert ring_plan(K, P, 512, lanes=2, clusters16=CLUSTERS16)[
            "cluster"] == 16
        assert ring_plan(K, P, 512, lanes=2, clusters16=1)["cluster"] == (
            16 if K <= 32 * RING_LOCAL_CHUNKS else 8)     # local: no cluster
    # the smallest that fits where a lane's ring or hop does not fit fewer
    fewest = {(16385, 41): 4, (16385, 5): 4, (4097, 129): 2, (382, 65): 1,
              (4097, 5): 1}
    for (K, P), s in fewest.items():
        assert ring_plan(K, P, 512, lanes=1000)["cluster"] == s
        assert s == 1 or not ring_plan(K, P, 512, s // 2)["fits"]
    assert not ring_plan(4097, 4, 512, 8)["fits"]          # P even
    assert not ring_plan(16385, 41, 512, 32)["fits"]
    assert ring_plan(131073, 5, 512, 16)["fits"]            # in windows


def test_ring_form_checks_its_inputs():
    ids = torch.zeros((2, 5), dtype=torch.int32)
    vals = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="same leading axes"):
        histogram_ring(ids, vals, torch.zeros(3, 5, 4), 0)
    with pytest.raises(ValueError, match="same leading axes"):
        histogram_ring(ids, vals[:, :4], torch.zeros(3, 2, 4), 0)
    with pytest.raises(ValueError, match="P odd"):
        histogram_ring(ids, vals, torch.zeros(4, 2, 4), 0)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_ring_form_against_the_jax_step_ring_update(cell):
    """The mirror's ring after a hop against the JAX package's live step
    (``emspec/pipeline.py`` ``_stream_step``, its relative branch with the
    histogram reference, ``segment_sum``): the contrib of a column below 0
    masked, the relative histogram rolled by t − R into the ring; each
    cell within n·ε relative of it (n the most deposits one cell of the
    hop takes, ε = 2⁻²³: the bound of the same sum in another order)."""
    settings, K, P, lanes = CELLS[cell]
    rel, vals, pipe = _hop_ids(settings, 9, seed=3)
    C, R = pipe.rows, pipe.reach
    base = _base(P, lanes, C, seed=2).abs()
    for t in (0, P + 2):
        got = _ring_mirror(rel, vals, base, t)[0] if lanes == 1 else \
            histogram_ring(rel, vals, base.clone(), t)
        ids = ring_ids(rel, t, P, C)
        lane = torch.arange(ids[..., 0].numel()).reshape(ids.shape[:-1] + (1,))
        n = int(torch.bincount((ids + lane * P * C)[ids >= 0].long()).max())
        ri, cj = jnp.asarray(rel.numpy()), jnp.asarray(vals.numpy())
        cj = jnp.where(ri >= (R - t) * C, cj, 0.0)
        hist = histogram_reference(ri, cj, P * C)
        dep = jnp.moveaxis(hist.reshape(hist.shape[:-1] + (P, C)), -2, 0)
        want = base.numpy() + np.asarray(jnp.roll(dep, t - R, axis=0))
        np.testing.assert_allclose(got.numpy(), want, rtol=n * 2.0 ** -23,
                                   atol=0)
        assert (got != base).sum() > 50


def test_ring_plain_against_the_jax_reference_added_into_the_ring():
    settings, K, P, lanes = CELLS["multires_live"]
    rel, vals, pipe = _hop_ids(settings, 40, seed=3)
    ids = ring_ids(rel, 40, P, pipe.rows)
    base = _base(P, 1, pipe.rows, seed=2).abs()
    got = histogram_ring_plain(ids, vals, base.clone())
    hist = np.asarray(histogram_reference(jnp.asarray(ids.numpy()),
                                          jnp.asarray(vals.numpy()),
                                          P * pipe.rows))
    want = base.numpy() + hist.reshape(P, pipe.rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert (got != base).sum() > 50


def _columns(stream, x, chunk):
    cols = []
    for i in range(0, x.shape[-1], chunk):
        cols += stream.push(x[..., i:i + chunk])
    cols += stream.flush()
    return (torch.stack([c.vis for c in cols]),
            torch.stack([c.rgba for c in cols]), [c.index for c in cols])


@pytest.mark.parametrize("kw", [
    {}, dict(scatter="pallas"),
    dict(mode="enhanced", multires=False, fft_size=2048, hop=256),
    dict(mode="enhanced", multires=False, fft_size=2048, hop=256,
         scatter="pallas", channels=2),
    dict(mode="enhanced", multires=False, fft_size=1024, hop=256,
         fft_method="direct")], ids=["display", "display-pallas", "2048",
                                     "2048-pallas-2ch", "direct"])
def test_exact_stream_is_the_default_stream_and_the_batch_on_the_cpu(kw):
    s = Settings(**kw)
    x = _audio(0.45, s.channels, seed=11)
    vis_e, rgba_e, idx = _columns(Stream(s, "cpu"), x, 1000)
    pipe = pl.get_pipeline(s, "cpu")
    vis_b, rgba_b, _ = pipe.process(x)
    assert idx == list(range(vis_b.shape[0]))
    assert torch.equal(vis_e, vis_b) and torch.equal(rgba_e, rgba_b)
    assert torch.equal(_columns(Stream(s, "cpu", exact_sums=True), x,
                                777)[0], vis_e)
    vis_d, rgba_d, _ = _columns(Stream(s, "cpu", exact_sums=False), x, 1000)
    if s.scatter == "pallas":     # relative histograms where asked for
        ok, worst, share = compare_vis(vis_d.reshape(vis_d.shape[0], -1),
                                       vis_e.reshape(vis_e.shape[0], -1))
        assert ok, (worst, share)
    else:
        assert torch.equal(vis_d, vis_e) and torch.equal(rgba_d, rgba_e)
        assert torch.equal(pipe.process(x, exact_sums=False)[0], vis_b)


def test_exact_step_reads_nothing_on_the_host():
    """The exact step with a ``t`` that refuses host reads and no read of
    any tensor's value (what a CUDA graph capture needs) gives the
    unguarded step's bits."""
    from test_torch_stream_graph import _NoHostRead, _NoValueReads

    pipe = pl.Pipeline(Settings(), "cpu")
    x = _audio(0.5, seed=4)
    outs = []
    for guard in (False, True):
        window, (t, acc, post) = pipe.init_roll_carry()
        if guard:
            t = t.as_subclass(_NoHostRead)
        carry = (window, (t, acc, post))
        vis = []
        for f in range(pipe.n_max // pipe.hop + pipe.reach + 8):
            block = torch.from_numpy(x[f * pipe.hop:(f + 1) * pipe.hop])
            with _NoValueReads() if guard else contextlib.nullcontext():
                carry, (v, _, _) = pipe._stream_step_rolling(
                    carry, block, pipe.params(), exact_sums=True)
            vis.append(v.clone())
        outs.append(torch.stack(vis))
    assert torch.equal(outs[0], outs[1]) and outs[0].any()


def _spies(monkeypatch):
    """Every call of the pipeline's ``histogram`` (its route keywords) and
    ``histogram_ring``."""
    calls = {"histogram": [], "ring": 0}

    def spy(ids, vals, num_bins, passes=2, **kw):
        calls["histogram"].append(
            {k: kw.get(k) for k in ("route", "reach", "out")})
        return histogram(ids, vals, num_bins, passes, **kw)

    def ring_spy(ids, vals, ring, t, **kw):
        calls["ring"] += 1
        return histogram_ring(ids, vals, ring, t, **kw)
    monkeypatch.setattr(pl, "histogram", spy)
    monkeypatch.setattr(pl, "histogram_ring", ring_spy)
    return calls


def test_cli_stream_and_animate_ask_for_the_ring_form(monkeypatch, tmp_path):
    calls = _spies(monkeypatch)
    write_wav(tmp_path / "in.wav", _audio(0.4), SR)
    assert cli_main(["stream", str(tmp_path / "in.wav"),
                     str(tmp_path / "s.png"), "--device", "cpu"]) == 0
    assert calls["ring"] > 100 and calls["histogram"] == []
    calls["ring"] = 0
    frames = list(animate_frames(_audio(0.4), Settings(), fps=10, width=64,
                                 device="cpu"))
    assert len(frames) == 4
    assert calls["ring"] > 100 and calls["histogram"] == []
    calls["ring"] = 0
    assert cli_main(["animate", str(tmp_path / "in.wav"),
                     str(tmp_path / "a.png"), "--fps", "10", "--device",
                     "cpu"]) == 0
    assert calls["ring"] > 100 and calls["histogram"] == []


def test_time_parallel_render_sums_in_order(monkeypatch, tmp_path):
    calls = _spies(monkeypatch)
    write_wav(tmp_path / "in.wav", _audio(0.4), SR)
    assert cli_main(["render", str(tmp_path / "in.wav"),
                     str(tmp_path / "tp.png"), "--multires",
                     "--time-parallel", "--device", "cpu"]) == 0
    assert calls["histogram"] == [dict(route=SORTED, reach=32, out=None)]
    calls["histogram"].clear()
    created = parallel.init_group("cpu")
    try:
        r = parallel.TimeParallelRenderer(
            Settings(), parallel.channel_mesh(axis="t", device="cpu"))
        v1 = r.render(_audio(0.4, seed=2))[0]
        assert calls["histogram"] == [dict(route=SORTED, reach=32,
                                           out=None)]
        assert calls["ring"] == 0
        want = pl.get_pipeline(Settings(), "cpu").process(
            _audio(0.4, seed=2))[0]
        assert float((v1 - want).abs().max()) <= 1e-5
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()


def test_app_stream_signal_and_sharded_stream_keep_their_routes(
        monkeypatch, tmp_path):
    """The app, ``stream_signal`` and ``ShardedStream`` sum each hop
    through the ring form by default (no other B2 call); a ``Stream`` and
    ``_stream_step`` with ``exact_sums=False`` reach B2's atomic routes
    (the relative histogram under ``"pallas"``, added into the ring
    otherwise) and no ring form."""
    calls = _spies(monkeypatch)
    app = EmSpecApp(Settings(), user_dir=tmp_path, device="cpu")
    assert app.stream.exact_sums is True
    assert app.push_audio(_audio(0.3)) > 0
    assert calls["ring"] > 0 and calls["histogram"] == []
    app.close()
    calls["ring"] = 0
    stream_signal(_audio(0.3), Settings(), "cpu", chunk=2048)
    assert calls["ring"] > 0 and calls["histogram"] == []
    for kw, out in (({}, True), (dict(scatter="pallas"), False)):
        calls["ring"] = 0
        st = Stream(Settings(**kw), "cpu", exact_sums=False)
        st.push(_audio(0.3))
        assert calls["ring"] == 0 and calls["histogram"]
        assert all(c["route"] is None and (c["out"] is not None) == out
                   for c in calls["histogram"])
        calls["histogram"].clear()
    created = parallel.init_group("cpu")
    try:
        s = Settings(mode="enhanced", multires=False, fft_size=2048,
                     channels=2)
        calls["ring"] = 0
        parallel.stream_signal_sharded(
            _audio(0.3, 2), s, parallel.channel_mesh(device="cpu"))
        assert calls["ring"] > 0 and calls["histogram"] == []
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()
