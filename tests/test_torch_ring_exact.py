"""Equal runs for the live path's file outputs: B2's ring form and the
exact stream, on the CPU.

* ``_ring_mirror`` follows ``ring_kernel`` in ``emspec_torch/csrc/
  histogram.cu`` step by step: ``bands`` blocks a lane, row r owned by
  warp r mod 16·bands, a block's local cells slot·rb + (r div nw)·16 +
  r mod 16; the stage (the first deposit to claim a cell loads it from
  the ring), the claims back to 0, each warp's walk over the chunks whose
  mask holds its bit, in bin order, each group of equal cells added by its
  lowest lane in lane order, and the store by the first deposit to claim
  the cell again.  It must be bit for bit (tolerance 0) an ordered float32
  loop — every cell adding its deposits one after another in deposit order
  onto the value it holds — and ``histogram_ring_plain`` (which is
  ``histogram_plain(..., out=)`` of the ring offsets), at the five live
  cells' shapes on the ids a real hop makes there (one lane, 16 at the
  stress cell), with ids of −1 and out of range carrying NaN/Inf, and a
  ring that is not zero; every touched cell stored once, no other cell
  written.
* ``ring_plan`` at those shapes, against the ``.cu``'s limits.
* ``Stream(exact_sums=True)`` on the CPU gives ``Stream()``'s columns bit
  for bit and ``Pipeline.process()``'s (the JAX invariant, streaming ≡
  batch), with ``scatter="pallas"`` too (its ring sums go through the ring
  form, not the relative histogram); its step reads no tensor's value on
  the host, so the card's graph captures it.
* Spies on the pipeline's ``histogram`` and ``histogram_ring`` pin who
  asks for the exact sums: the CLI's ``stream``, ``render.animate``'s
  frames, ``TimeParallelRenderer.render`` and ``render --time-parallel``;
  the app, ``stream_signal`` and ``ShardedStream`` keep B2's atomic
  routes.
* The ring form's plain sum against the JAX package's histogram reference
  (``segment_sum``) added into the ring, within 1e-6 relative: the same
  sum in another order.
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
    PIECE_CHUNKS, RING_CELLS, RING_MAX_BANDS, SMEM_BYTES, SORTED, TILE_WARPS,
    histogram, histogram_ring, histogram_ring_plain, ring_plan)
from emspec_torch.io.wav import write_wav
from emspec_torch.render.animate import animate_frames
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.validate import compare_vis

CSRC = Path(kernels_build.__file__).parent / "csrc"
SR = 48_000
# the five live cells: settings, and the hop's deposits, slots and lanes
CELLS = {
    "live": (Settings(mode="enhanced", multires=False, fft_size=8192),
             4097, 5, 1),
    "multires_live": (Settings(), 382, 65, 1),
    "north_live": (Settings(mode="enhanced", multires=False,
                            fft_size=32768, hop=800), 16385, 41, 1),
    "stress_live": (Settings(mode="enhanced", multires=False,
                             fft_size=32768, sample_rate=96000,
                             channels=16), 16385, 5, 16),
    "wide_live": (Settings(mode="enhanced", multires=False, fft_size=8192,
                           hop=64), 4097, 129, 1),
}


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
    """The ring ids slot·rows + row and contrib of hop ``t`` of
    ``settings``' live step on the CPU (``Pipeline._stream_step``'s exact
    branch), lanes leading; the pipeline."""
    pipe = pl.Pipeline(settings, "cpu")
    sr, n = settings.sample_rate, pipe.n_max
    lead = (settings.channels,) if settings.channels > 1 else ()
    x = _audio((n + (t + 1) * pipe.hop) / sr + 0.01, settings.channels,
               seed, sr)
    x = torch.from_numpy(np.asarray(x)[..., t * pipe.hop:t * pipe.hop + n])
    p = pipe.params()
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_windows(x), p)
    ids = pipe._ring_ids(ids_rel, t)
    assert ids.shape == lead + (ids.shape[-1],) and ids.dtype == torch.int32
    assert (ids >= 0).any()
    return ids.to(torch.int32).contiguous(), contrib.contiguous(), pipe


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
    """Each cell adds its lane's deposits one after another in deposit
    order, float32, onto the value it holds."""
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


def _ring_mirror(ids, vals, ring, bands=None):
    """``ring_kernel`` in PyTorch/numpy, block by block and warp by warp
    (module docstring) → (the ring after the hop, stores a cell)."""
    P, C, K = ring.shape[0], ring.shape[-1], ids.shape[-1]
    lanes = ring[0].numel() // C
    plan = ring_plan(K, P, C, bands, lanes)
    nw, rb, chunks = plan["warps"], plan["rb"], plan["chunks"]
    log_nw = nw.bit_length() - 1
    assert 1 << log_nw == nw
    out = ring.numpy().reshape(-1).copy()
    stores = np.zeros(out.size, np.int64)
    i2 = ids.reshape(lanes, -1).numpy().astype(np.int64)
    v2 = vals.reshape(lanes, -1).numpy().astype(np.float32)
    pad = chunks * 32 - K
    for lane_row in range(lanes):
        rid = np.concatenate([i2[lane_row], np.full(pad, -1)])
        rv = np.concatenate([v2[lane_row], np.zeros(pad, np.float32)])
        for band in range(plan["bands"]):
            # stage: keys (warp << 16 | local, or −1), chunk masks, loads
            ok = (rid >= 0) & (rid < P * C)
            slot, row = np.divmod(np.where(ok, rid, 0), C)
            gw = row & (nw - 1)
            own = ok & ((gw >> 4) == band)
            warp = gw & 15
            local = slot * rb + ((row >> log_nw) << 4) + warp
            keys = np.where(own, (warp << 16) | local, -1)
            assert (np.where(own, local, 0) < plan["cells"]).all()
            masks = [0] * chunks
            for k in np.flatnonzero(own):
                masks[k >> 5] |= 1 << int(warp[k])
            tile = np.full(plan["cells"], np.nan, np.float32)
            claim = np.zeros(plan["cells"], bool)

            def offset(loc):
                s, q = divmod(loc, rb)
                r = ((q >> 4) << log_nw) | (band << 4) | (q & 15)
                return (s * lanes + lane_row) * C + r
            for c0 in range(0, chunks, PIECE_CHUNKS):       # the pieces
                for k in range(c0 * 32, min(c0 + PIECE_CHUNKS, chunks) * 32):
                    if keys[k] >= 0 and not claim[keys[k] & 0xffff]:
                        claim[keys[k] & 0xffff] = True
                        tile[keys[k] & 0xffff] = out[offset(
                            keys[k] & 0xffff)]
            claim[:] = False                    # the claims back to 0
            for w in range(TILE_WARPS):         # walk_chunks, warp by warp
                for ch in range(chunks):
                    if not (masks[ch] >> w) & 1:
                        continue
                    lanes_k = range(ch * 32, ch * 32 + 32)
                    mine = [k for k in lanes_k
                            if keys[k] >= 0 and keys[k] >> 16 == w]
                    groups: dict = {}
                    for k in mine:              # lane order
                        groups.setdefault(keys[k] & 0xffff, []).append(k)
                    for cell, ks in groups.items():
                        acc = np.float32(tile[cell] + rv[ks[0]])
                        for k in ks[1:]:
                            acc = np.float32(acc + rv[k])
                        tile[cell] = acc
            for k in range(chunks * 32):       # the store, once a cell
                if keys[k] >= 0 and not claim[keys[k] & 0xffff]:
                    claim[keys[k] & 0xffff] = True
                    o = offset(keys[k] & 0xffff)
                    out[o] = tile[keys[k] & 0xffff]
                    stores[o] += 1
    return torch.from_numpy(out.reshape(ring.shape)), \
        torch.from_numpy(stores.reshape(ring.shape))


def _base(P, lanes, C, seed):
    rng = np.random.default_rng(seed)
    shape = (P,) + ((lanes,) if lanes > 1 else ()) + (C,)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_ring_form_mirror_is_the_ordered_sum_at_the_live_cells(cell):
    settings, K, P, lanes = CELLS[cell]
    t = 7 if cell != "wide_live" else 70        # past the first R hops
    ids, vals, pipe = _hop_ids(settings, t, seed=len(cell))
    assert (ids.shape[-1], 2 * pipe.reach + 1,
            ids[..., 0].numel()) == (K, P, lanes)
    C = pipe.rows
    ids, vals = _spoil(ids, vals, P, C, seed=K)
    assert torch.isnan(vals).any() and torch.isinf(vals).any()
    base = _base(P, lanes, C, seed=P)
    want = _ordered(ids, vals, base)
    got, stores = _ring_mirror(ids, vals, base)
    assert torch.equal(got, want)
    assert torch.equal(histogram_ring_plain(ids, vals, base.clone()), want)
    assert torch.equal(histogram_ring(ids, vals, base.clone()), want)
    assert torch.isfinite(got).all()
    touched = got != base
    assert (stores[touched] == 1).all() and (stores <= 1).all()
    # a stored cell is one the hop's valid ids name, of its own lane
    flat = set()
    i2 = ids.reshape(lanes, -1)
    for lane in range(lanes):
        for i in i2[lane].tolist():
            if 0 <= i < P * C:
                flat.add((i // C * lanes + lane) * C + i % C)
    assert set(np.flatnonzero(stores.reshape(-1).numpy()).tolist()) == flat


@pytest.mark.parametrize("bands", [1, 2, 4, 8])
def test_ring_form_mirror_at_forced_bands_with_hot_cells(bands):
    """Two lanes of 1,500 deposits into 9 × 40 cells, a third of them on
    one hot cell and runs of equal cells across chunks, values 1e-3 … 1e3
    of both signs: bit for bit the ordered sum at every band count."""
    rng = np.random.default_rng(bands)
    P, C, K, lanes = 9, 40, 1500, 2
    ids = rng.integers(0, P * C, (lanes, K))
    ids = np.where(rng.random((lanes, K)) < 0.33, 3 * C + 17, ids)
    ids[:, 200:400] = 5 * C + 2                       # a run of 200
    ids = torch.from_numpy(ids.astype(np.int32))
    vals = torch.from_numpy((10.0 ** rng.uniform(-3, 3, (lanes, K))
                             * rng.choice([-1.0, 1.0], (lanes, K))
                             ).astype(np.float32))
    ids, vals = _spoil(ids, vals, P, C, seed=bands)
    base = _base(P, lanes, C, seed=bands + 1)
    got, stores = _ring_mirror(ids, vals, base, bands)
    assert torch.equal(got, _ordered(ids, vals, base))
    assert (stores <= 1).all()


def test_ring_plan_at_the_live_cells_and_the_cu_limits():
    src = (CSRC / "histogram.cu").read_text()
    assert f"kRingMaxBands = {RING_MAX_BANDS};" in src
    assert f"kMaxSmem = {SMEM_BYTES};" in src
    assert "tcells > 0x10000" in src and RING_CELLS == 0x10000
    assert "smem = 8 * tcells + chunks * (32 * 8 + 4)" in src
    sig = re.search(r'extern "C" int emspec_histogram_ring\(([^)]*)\)', src)
    argc = len(sig.group(1).split(","))
    assert argc == len(kernels_build._SIGNATURES["emspec_histogram_ring"])
    # one wave of blocks, every warp a row: 32 a mono lane, 8 of 16 lanes
    for cell, (_, K, P, lanes) in CELLS.items():
        plan = ring_plan(K, P, 512, lanes=lanes)
        assert plan["fits"] and plan["bands"] == (8 if lanes == 16 else 32)
        assert plan["cells"] == P * 512 // plan["bands"]
        assert plan["warps"] <= 512 and lanes * plan["bands"] <= 132
    # the fewest that fit where a block cannot hold a lane's ring
    fewest = {(16385, 129): 8, (16385, 41): 2, (382, 65): 2, (4097, 5): 1}
    for (K, P), b in fewest.items():
        assert ring_plan(K, P, 512, lanes=1000)["bands"] == b
        assert b == 1 or not ring_plan(K, P, 512, b // 2)["fits"]
    assert ring_plan(16385, 129, 512, lanes=1000)["fits"]


def test_ring_form_checks_its_inputs():
    ids = torch.zeros((2, 5), dtype=torch.int32)
    vals = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="same leading axes"):
        histogram_ring(ids, vals, torch.zeros(3, 5, 4))
    with pytest.raises(ValueError, match="same leading axes"):
        histogram_ring(ids, vals[:, :4], torch.zeros(3, 2, 4))


def test_ring_plain_against_the_jax_reference_added_into_the_ring():
    settings, K, P, lanes = CELLS["multires_live"]
    ids, vals, pipe = _hop_ids(settings, 40, seed=3)
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
    vis_e, rgba_e, idx = _columns(Stream(s, "cpu", exact_sums=True), x, 1000)
    pipe = pl.get_pipeline(s, "cpu")
    vis_b, rgba_b, _ = pipe.process(x, exact_sums=True)
    assert idx == list(range(vis_b.shape[0]))
    assert torch.equal(vis_e, vis_b) and torch.equal(rgba_e, rgba_b)
    vis_d, rgba_d, _ = _columns(Stream(s, "cpu"), x, 1000)
    if s.scatter == "pallas":     # relative histograms by default
        ok, worst, share = compare_vis(vis_d.reshape(vis_d.shape[0], -1),
                                       vis_e.reshape(vis_e.shape[0], -1))
        assert ok, (worst, share)
    else:
        assert torch.equal(vis_d, vis_e) and torch.equal(rgba_d, rgba_e)
        assert torch.equal(pipe.process(x)[0], vis_b)


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

    def ring_spy(ids, vals, ring, **kw):
        calls["ring"] += 1
        return histogram_ring(ids, vals, ring, **kw)
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
            _audio(0.4, seed=2), exact_sums=True)[0]
        assert float((v1 - want).abs().max()) <= 1e-5
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()


def test_app_stream_signal_and_sharded_stream_keep_their_routes(
        monkeypatch, tmp_path):
    calls = _spies(monkeypatch)
    app = EmSpecApp(Settings(), user_dir=tmp_path, device="cpu")
    assert app.stream.exact_sums is False
    assert app.push_audio(_audio(0.3)) > 0
    assert calls["ring"] == 0 and calls["histogram"]
    assert all(c["route"] is None for c in calls["histogram"])
    app.close()
    calls["histogram"].clear()
    stream_signal(_audio(0.3), Settings(), "cpu", chunk=2048)
    assert calls["ring"] == 0 and calls["histogram"]
    created = parallel.init_group("cpu")
    try:
        s = Settings(mode="enhanced", multires=False, fft_size=2048,
                     channels=2)
        calls["histogram"].clear()
        parallel.stream_signal_sharded(
            _audio(0.3, 2), s, parallel.channel_mesh(device="cpu"))
        assert calls["ring"] == 0 and calls["histogram"]
        assert all(c["route"] is None for c in calls["histogram"])
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()
