"""Equal runs for the display pipeline's file renders: ``Pipeline.process(
..., exact_sums=True)`` on the CPU.

* The file-render entry points (``render_image_multires``,
  ``render_images_channels``, ``emspec_torch.render``, the CLI's export
  with ``--multires`` or ``--channel all``) ask for B2's sorted route with
  its bound: reach R = the pipeline's reach, ``frame_len`` the banks'
  deposits a frame (382 at the display default), ``column_len`` the
  raster's rows (512); the relative single-bank path too, through the
  absolute grid.  So do ``Pipeline.process`` and the bench's
  ``_throughput`` (``_batch_vis``) by default, and ``Stream`` sums no hop
  through ``histogram`` (its ring form); ``exact_sums=False`` reaches
  B2's atomic routes (a spy on the pipeline's ``histogram``).
* The sorted route's tiles form with K deposits a frame into columns of
  C ≠ K cells, mirrored by ``tests/test_torch_sorted_tiles.py``'s
  ``_tiles_mirror`` (the ``.cu``'s loops verbatim), is bit for bit
  (tolerance 0) the ordered CPU sum — every cell adding its deposits in
  (frame, bin) order, a float32 loop — on the display default's own ids
  (3-column tiles, and the 45-column tiles the card's plan takes at 5,937
  columns), on seeded multires-shaped ids in two rows with hot cells,
  and added into an output; every cell stored once.  The exact grid of
  ``_enhanced_power`` is that sum, and on the CPU ``process`` gives the
  same vis with and without ``exact_sums`` at the display default.
"""

import numpy as np
import pytest
import torch
from test_torch_sorted_tiles import _tiles_mirror

from emspec_torch import pipeline as pl
from emspec_torch import render as render_function
from emspec_torch.__main__ import main as cli_main
from emspec_torch.bench.harness import _throughput
from emspec_torch.config import Settings
from emspec_torch.dsp.kernels.scatter import (
    PIECE_CHUNKS, SMEM_BINS, SORTED, TILE_CELLS, batch_plan, histogram,
    histogram_plain, sorted_form, tile_plan)
from emspec_torch.io.wav import write_wav
from emspec_torch.stream import stream_signal
from emspec_torch.validate import compare_vis

DISPLAY = Settings()                  # the display default: multires
K_DISPLAY = 43 + 98 + 241             # its banks' deposits a frame


def _audio(seconds, channels=1, seed=0, sr=48000):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    out = [(0.5 * np.sin(2 * np.pi * (150.0 + 90 * c) * t
                         + 2 * np.pi * 3000.0 * t * t)
            + 0.2 * np.sin(2 * np.pi * 440.0 * t)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
           for c in range(channels)]
    return out[0] if channels == 1 else np.stack(out)


def _spy(monkeypatch):
    """Every call of the pipeline's ``histogram``: its bound keywords."""
    calls = []

    def spy(ids, vals, num_bins, passes=2, **kw):
        calls.append({k: kw.get(k) for k in ("route", "reach", "frame_len",
                                             "column_len")})
        return histogram(ids, vals, num_bins, passes, **kw)
    monkeypatch.setattr(pl, "histogram", spy)
    return calls


def _bounded(reach, k, rows=512):
    return dict(route=SORTED, reach=reach, frame_len=k, column_len=rows)


def test_file_renders_ask_for_the_sorted_tiles_with_their_bound(
        monkeypatch, tmp_path):
    calls = _spy(monkeypatch)
    x = _audio(0.4)
    pl.render_image_multires(x, DISPLAY, "cpu")
    assert calls == [_bounded(32, K_DISPLAY)]
    calls.clear()
    pl.render_images_channels(_audio(0.4, 2), DISPLAY, "cpu")
    assert calls == [_bounded(32, K_DISPLAY)]
    calls.clear()
    render_function(x, DISPLAY, "cpu")
    assert calls == [_bounded(32, K_DISPLAY)]
    # one bank, relative under "pallas": the absolute grid all the same
    single = Settings(multires=False, fft_size=2048, scatter="pallas")
    assert pl.get_pipeline(single, "cpu").use_relative_batch
    calls.clear()
    pl.render_images_channels(_audio(0.4, 2), single, "cpu")
    assert calls == [_bounded(2, 1025)]
    wav = tmp_path / "in.wav"
    write_wav(wav, _audio(0.4, 2), 48000)
    for extra in (["--multires"], ["--channel", "all"]):
        calls.clear()
        assert cli_main(["export", str(wav), str(tmp_path / "e.npz"),
                         "--device", "cpu", *extra]) == 0
        assert len(calls) == 1 and calls[0]["route"] == SORTED
        assert calls[0]["column_len"] == 512 and calls[0]["reach"] > 0


def test_stream_batch_vis_and_bench_keep_their_routes(monkeypatch):
    """The defaults ask for the ordered sums: ``process`` and the bench's
    ``_throughput`` the sorted route with its bound, ``stream_signal`` no
    ``histogram`` (the ring form); ``exact_sums=False`` the scatter
    setting's routes, with no bound."""
    calls = _spy(monkeypatch)
    x = _audio(0.4)
    pipe = pl.get_pipeline(DISPLAY, "cpu")
    pipe.process(x)
    assert calls == [_bounded(32, K_DISPLAY)]
    calls.clear()
    pipe.process(x, exact_sums=False)
    assert calls and all(c["route"] is None and c["reach"] is None
                         for c in calls)
    calls.clear()
    stream_signal(x, DISPLAY, "cpu", chunk=2048)
    assert calls == []
    _throughput(DISPLAY, 0.3, 1, device="cpu")
    assert calls and all(c == _bounded(32, K_DISPLAY) for c in calls)


# chip_smoke.py's batch cells: (frames, deposits a frame, reach, rows,
# lanes) → the sorted route's form their shape takes on the card
BATCH_FORMS = {
    "batch": ((372, 4097, 2, 512, 1), "batch"),
    "batch16": ((372, 4097, 2, 512, 16), "batch"),
    "multires": ((5937, 382, 32, 512, 1), "tiles"),
    "time_parallel chunk": ((6001, 382, 32, 512, 1), "tiles"),
    "raster": ((372, 4097, 2, 4097, 1), "tiles"),
    "stress": ((43, 16385, 2, 512, 16), "batch"),
    "north": ((920, 16385, 20, 512, 1), "batch"),
    "ext262144": ((8, 131073, 2, 512, 1), "batch"),
    "wide": ((1373, 4097, 64, 512, 1), "batch"),
}


@pytest.mark.parametrize("cell", sorted(BATCH_FORMS))
def test_sorted_form_by_shape_at_the_batch_cells(cell):
    """``sorted_form``: the tiles where a frame holds no more deposits than
    a column holds cells, else the batch form, whose plan fits there — by
    shape only; never the global sort."""
    (T, K, R, C, lanes), form = BATCH_FORMS[cell]
    assert sorted_form(T, K, R, C, lanes) == form
    assert (K <= C) == (form == "tiles")
    assert batch_plan(T, K, R, C, lanes)["fits"]


def test_the_batch_weighs_its_lanes_in_the_sorted_form(monkeypatch):
    """``process`` gives ``sorted_form`` its lanes (the channels); a mono
    and a 16-channel batch at 8192 both take the batch form, whose plan
    weighs the lanes (tiles of 3 columns for one lane, of 47 for 16)."""
    seen = []

    def spy(*args):
        seen.append(args)
        return sorted_form(*args)
    monkeypatch.setattr(pl, "sorted_form", spy)
    s = Settings(mode="enhanced", multires=False, fft_size=2048)
    for channels in (1, 3):
        pl.get_pipeline(s.replace(channels=channels), "cpu").process(
            _audio(0.2, channels))
    assert [a[-1] for a in seen] == [1, 3]
    assert sorted_form(372, 4097, 2, 512) == "batch"
    assert sorted_form(372, 4097, 2, 512, 16) == "batch"
    assert (batch_plan(372, 4097, 2, 512)["cols"],
            batch_plan(372, 4097, 2, 512, 16)["cols"]) == (3, 47)


def test_a_sort_shaped_batch_asks_for_the_global_sort(monkeypatch):
    """Where the shape took the global sort until the batch form (the
    north star's 32768 at hop 800), ``process`` asks for the sorted route
    with its bound in the batch form, and its vis is the atomic path's on
    the CPU bit for bit."""
    calls = _spy(monkeypatch)
    forms = []
    spied = pl.histogram

    def form_spy(*args, **kw):
        forms.append(kw.get("form"))
        return spied(*args, **kw)
    monkeypatch.setattr(pl, "histogram", form_spy)
    s = Settings(mode="enhanced", multires=False, fft_size=32768, hop=800)
    pipe = pl.get_pipeline(s, "cpu")
    x = _audio(0.9)
    vis = pipe.process(x)[0]
    assert calls == [_bounded(20, 16385)] and forms == ["batch"]
    assert torch.equal(pipe.process(x, exact_sums=False)[0], vis)


def _display_ids(seconds):
    """The display default's absolute-grid ids (t, 382) and contrib on the
    CPU, and the pipeline."""
    pipe = pl.Pipeline(DISPLAY, "cpu")
    xt = torch.from_numpy(_audio(seconds, seed=3))
    t = pipe.num_columns(xt.shape[-1])
    p = pipe.params()
    ids_rel, contrib = pipe._deposit_ids_rel(pipe._bank_inputs(xt, t), p)
    ids = pipe._absolute_ids(ids_rel, t, pipe.reach)
    return pipe, xt, p, t, ids, contrib


def _ordered_sum(ids, vals, cells, base=None):
    """Each cell's deposits added one after another in deposit order (the
    flat (frame, bin) order), float32."""
    out = (np.zeros(cells, np.float32) if base is None
           else base.numpy().astype(np.float32).copy())
    for i, v in zip(ids.reshape(-1).tolist(),
                    vals.reshape(-1).numpy().tolist()):
        if 0 <= i < cells:
            out[i] = np.float32(out[i] + np.float32(v))
    return torch.from_numpy(out)


@pytest.mark.parametrize("tile_cols", [None, 45], ids=["plan", "45"])
def test_tiles_form_on_display_ids_is_the_ordered_sum(tile_cols):
    pipe, xt, p, t, ids, contrib = _display_ids(0.5)
    assert ids.shape == (t, K_DISPLAY) and pipe.reach == 32
    cells = t * pipe.rows
    want = _ordered_sum(ids, contrib, cells)
    got, stored = _tiles_mirror(ids.reshape(-1), contrib.reshape(-1),
                                K_DISPLAY, pipe.reach, tile_cols=tile_cols,
                                C=pipe.rows)
    assert torch.equal(got, want) and (stored == 1).all()
    assert torch.equal(histogram_plain(ids.reshape(-1), contrib.reshape(-1),
                                       cells), want)
    grid = pipe._enhanced_power(xt, t, p, exact_sums=True)
    assert torch.equal(grid.reshape(-1), want)
    assert torch.equal(histogram(ids.reshape(-1), contrib.reshape(-1), cells,
                                 **_bounded(pipe.reach, K_DISPLAY)), want)


def _multires_like(T, K, C, R, lead=(), seed=0):
    """Seeded ids of the display grid's form: frame s's deposit k lands in
    column s + δ (|δ| <= R) and a row rising with k within each of three
    banks (a few far, a third piled onto one hot cell, a fifth dropped);
    values of 1e-3 … 1e3, half negative, so the order shows in the bits."""
    rng = np.random.default_rng(seed)
    shape = lead + (T, K)
    s = np.arange(T)[:, None]
    c = np.clip(s + rng.integers(-R, R + 1, shape), -1, T)
    bank = np.arange(K) * 3 // K
    row = (bank * C // 3 + (np.arange(K) - bank * K // 3) * C // K) % C
    f = np.clip(row + rng.integers(-1, 2, shape), 0, C - 1)
    f = np.where(rng.random(shape) < 0.02, rng.integers(0, C, shape), f)
    f = np.where(rng.random(shape) < 0.33, C - 2, f)
    ids = np.where((c < 0) | (c >= T), -1, c * C + f)
    ids = np.where(rng.random(shape) < 0.2, -1, ids).astype(np.int32)
    vals = (10.0 ** rng.uniform(-3, 3, shape)
            * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    return (torch.from_numpy(ids.reshape(lead + (-1,))),
            torch.from_numpy(vals.reshape(lead + (-1,))))


@pytest.mark.parametrize("T,K,C,R,tile_cols", [
    (23, 38, 51, 4, None), (23, 38, 51, 4, 7), (17, 70, 20, 3, 2),
    (9, 5, 130, 2, None)])
def test_tiles_form_multires_shaped_ids_in_two_rows(T, K, C, R, tile_cols):
    ids, vals = _multires_like(T, K, C, R, lead=(2,), seed=T + K + C)
    got, stored = _tiles_mirror(ids, vals, K, R, tile_cols=tile_cols, C=C)
    want = torch.stack([_ordered_sum(ids[r], vals[r], T * C)
                        for r in range(2)])
    assert torch.equal(got, want) and (stored == 1).all()
    assert torch.equal(histogram_plain(ids, vals, T * C), want)
    base = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, T * C)).astype(np.float32))
    got, stored = _tiles_mirror(ids, vals, K, R, out=base,
                                tile_cols=tile_cols, C=C)
    assert torch.equal(got, torch.stack([
        _ordered_sum(ids[r], vals[r], T * C, base[r]) for r in range(2)]))
    assert (stored == 1).all()


def test_tile_plan_at_the_display_default():
    """5,937 columns of 512 cells, 382 deposits a frame, R = 32: tiles of
    45 columns (one a streaming multiprocessor, 132), each walking 109
    frames in 10 pieces of 12 frames, within a block's shared memory;
    3-column tiles would walk 67 frames for 3 columns."""
    plan = tile_plan(5937, K_DISPLAY, 32, column=512)
    assert (plan["cols"], plan["cells"], plan["col_tiles"], plan["row_tiles"],
            plan["walk"], plan["frames_per_piece"], plan["piece_chunks"],
            plan["pieces"]) == (45, 512, 132, 1, 109, 12, PIECE_CHUNKS, 10)
    assert plan["cols"] * plan["cells"] <= TILE_CELLS
    assert plan["smem"] <= 4 * SMEM_BINS
    assert tile_plan(5937, K_DISPLAY, 32, 3, column=512)["walk"] == 67
    assert ((plan["cells"] - 1) * plan["owner_mul"]) >> 16 < 16


def test_histogram_checks_the_generalised_bound():
    ids, vals = _multires_like(6, 10, 12, 1, seed=2)
    got = histogram(ids, vals, 6 * 12, route=SORTED, reach=1, frame_len=10,
                    column_len=12)
    assert torch.equal(got, histogram_plain(ids, vals, 6 * 12))
    for bad in (dict(route=SORTED, reach=1, frame_len=10, column_len=11),
                dict(route=SORTED, reach=1, frame_len=12, column_len=12),
                dict(route=SORTED, reach=1, column_len=12),
                dict(reach=1, frame_len=10, column_len=12)):
        with pytest.raises(ValueError, match="reach and frame_len"):
            histogram(ids, vals, 6 * 12, **bad)


def test_exact_sums_give_the_default_vis_on_the_cpu():
    """On the CPU the display default already sums into the absolute grid
    in (frame, bin) order: the same vis bit for bit either way; one bank
    under "pallas" (relative histograms and the fold by default) within
    the vis rule."""
    x = _audio(0.5, seed=5)
    pipe = pl.get_pipeline(DISPLAY, "cpu")
    v0 = pipe.process(x)[0]
    assert torch.equal(pipe.process(x, exact_sums=True)[0], v0)
    single = pl.get_pipeline(Settings(multires=False, fft_size=2048,
                                      scatter="pallas"), "cpu")
    rel, exact = single.process(x)[0], single.process(x, exact_sums=True)[0]
    ok, worst, share = compare_vis(rel, exact)
    assert ok, (worst, share)
