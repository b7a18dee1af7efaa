"""The port's sharded paths (``emspec_torch.parallel``) on CPU process
groups (gloo, a FileStore, no network): world 2 and 4, a 2×2 (ch × t)
mesh, and world 1.  Each world is one set of processes
(``tests/torch_parallel_worker.py``) that runs every case; the tests
read their results.

Tolerances, the JAX package's own (``tests/test_parallel.py:315-345``):
against the port's unsharded ``Pipeline.process`` vis 1e-5, rgba ±1,
smooth 1e-5, agc_ref 1e-4; ``ShardedStream`` against its batch (``:72-
107``) vis 1e-6, rgba ±1 on under 1% of the pixels; an elastic resume
1e-6.  "rgba ±1" is one step of the colormap (``_lut_steps``), not one
unit of a byte: the time renderer's re-base moves vis by ~2e-7, and on a
quantization edge that is the next inferno entry, up to 5 a byte away.  Against the JAX package's single-device ``Pipeline.process``: the
port's ``compare_vis`` (3×3 max-filters within 2/255 on all but 1e-4 of
the cells).  The census is the JAX package's: a render makes two
gathers and one state reduction over "t", plus one max over "ch" on a
(ch × t) mesh with the global AGC; a channel-sharded call or hop makes
one max with the global AGC and none without.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_parallel_worker as worker
from emspec.config import Settings as JaxSettings
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.config import Settings
from emspec_torch.pipeline import Pipeline
from emspec_torch.render.png import read_png
from emspec_torch.tables import lut
from emspec_torch.validate import compare_vis

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(worker.__file__)
WORLDS = (2, 4)


def _run_world(out: Path, world: int, steps: list) -> None:
    """Start ``world`` ranks on a fresh FileStore and wait for them."""
    store = out / f"store_{world}_{'_'.join(steps)}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), json.dumps(dict(
            rank=r, world=world, store=str(store), out=str(out),
            steps=steps))], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=600)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, errs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world → its output folder; the checkpoint saved at world 2 is
    resumed at 1 and 4."""
    out = {w: tmp_path_factory.mktemp(f"world{w}") for w in (1, 2, 4)}
    _run_world(out[2], 2, ["run_cases", "ckpt_save", "migration", "errors"])
    for w in (1, 4):
        (out[w] / "ck.npz").write_bytes((out[2] / "ck.npz").read_bytes())
    _run_world(out[4], 4, ["run_cases", "ckpt_resume", "errors"])
    _run_world(out[1], 1, ["ckpt_resume"])
    return out


def _load(runs, world, name) -> dict:
    with np.load(runs[world] / f"{name}.npz", allow_pickle=False) as z:
        res = {k: z[k] for k in z.files}
    res["census"] = json.loads(str(res["census"]))
    return res


@functools.lru_cache(maxsize=None)
def _unsharded(world, name):
    kind, kw, x = worker.cases(world)[name]
    vis, rgba, st = Pipeline(Settings(**kw), "cpu").process(x)
    return vis.numpy(), rgba.numpy(), st.smooth.numpy(), st.agc_ref.numpy()


@functools.lru_cache(maxsize=None)
def _jax(world, name):
    kind, kw, x = worker.cases(world)[name]
    vis, _, _ = JaxPipeline(JaxSettings(**kw)).process(x)
    return np.asarray(vis)


@functools.lru_cache(maxsize=1)
def _colour_index():
    return {tuple(c): i for i, c in enumerate(lut("inferno"))}


def _lut_steps(got, want):
    """RGBA of two renders → (the largest difference of their colormap
    indices, the share of pixels that differ).  "rgba ±1" is one colormap
    step: adjacent inferno entries differ by up to 5 in a byte, so a vis
    1e-7 apart on a quantization edge moves a byte by more than 1."""
    index = _colour_index()
    got, want = got.reshape(-1, 4), want.reshape(-1, 4)
    moved = (got != want).any(-1)       # a tile's frame is no LUT colour
    to_index = lambda a: np.array([index[tuple(c)] for c in a], int)
    d = np.abs(to_index(got[moved]) - to_index(want[moved]))
    return int(d.max(initial=0)), float(moved.mean())


BATCH_CASES = [(w, n) for w in WORLDS for n in worker.cases(w)
               if not n.startswith("stream")]


@pytest.mark.parametrize("world,name", BATCH_CASES)
def test_sharded_batch_matches_unsharded(runs, world, name):
    res = _load(runs, world, name)
    vis, rgba, smooth, agc_ref = _unsharded(world, name)
    assert res["vis"].shape == vis.shape and res["rgba"].shape == rgba.shape
    np.testing.assert_allclose(res["vis"], vis, atol=1e-5)
    assert _lut_steps(res["rgba"], rgba)[0] <= 1
    np.testing.assert_allclose(res["smooth"], smooth, atol=1e-5)
    np.testing.assert_allclose(res["agc_ref"], agc_ref, atol=1e-4)
    # each rank held its own shard, not the whole
    shard = tuple(res["shard"])
    if name.startswith("pipe"):
        assert shard[1] * world == vis.shape[1]
    else:
        n_t = world // 2 if name.startswith("grid") else world
        assert shard[0] <= -(-vis.shape[0] // n_t)


@pytest.mark.parametrize("world,name", BATCH_CASES)
def test_sharded_batch_matches_jax(runs, world, name):
    res = _load(runs, world, name)
    ok, worst, share = compare_vis(torch.from_numpy(_jax(world, name)),
                                   torch.from_numpy(res["vis"]))
    assert ok, (worst, share)


def test_global_agc_couples_every_shard(runs):
    for world in WORLDS:
        for name in ("pipe_agc", "grid_enhanced_agc", "grid_natural_agc"):
            if name in worker.cases(world):
                refs = _load(runs, world, name)["agc_ref"]
                np.testing.assert_allclose(refs, refs[0], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_stream_matches_its_batch(runs, world):
    res = _load(runs, world, "stream")
    np.testing.assert_allclose(res["vis"], res["vis_b"], atol=1e-6)
    worst, share = _lut_steps(res["rgba"], res["rgba_b"])
    assert worst <= 1 and share < 0.01


@pytest.mark.parametrize("world", WORLDS)
def test_collective_census(runs, world):
    want = {"pipe_enhanced": {}, "pipe_natural": {},
            "pipe_agc": {"all_reduce_max": 1},
            "tp_enhanced": {"all_gather": 2, "broadcast": 1},
            "tp_natural": {"all_gather": 2, "broadcast": 1},
            "tp_tail": {"all_gather": 2, "broadcast": 1},
            "tp_2ch_agc": {"all_gather": 2, "broadcast": 1}}
    for mode in ("enhanced", "natural"):
        want[f"grid_{mode}_local"] = {"all_gather": 2, "broadcast": 1}
        want[f"grid_{mode}_agc"] = {"all_gather": 2, "broadcast": 1,
                                    "all_reduce_max": 1}
    for name in worker.cases(world):
        if name != "stream":
            assert _load(runs, world, name)["census"] == want[name], name
    census = _load(runs, world, "stream")["census"]
    assert census == {"step_agc": {"all_reduce_max": 1}, "step_local": {}}


@pytest.mark.parametrize("world", [1, 4])
def test_elastic_checkpoint_resume(runs, world):
    """Saved at world 2, resumed at 1 and at 4: the continuation equals
    the world-2 stream's own."""
    ref = _load(runs, 2, "ck_ref")
    got = _load(runs, world, f"ck_resume_{world}")
    np.testing.assert_array_equal(got["index"], ref["index"])
    np.testing.assert_allclose(got["vis"], ref["vis"], atol=1e-6)


def test_checkpoint_is_the_jax_layout(runs):
    with np.load(runs[2] / "ck.npz", allow_pickle=False) as z:
        assert sorted(z.files) == sorted(
            [f"carry_{i}" for i in range(5)] + ["t", "needs_window_prime"])
        ch = worker.CKPT["channels"]
        assert z["carry_0"].shape[0] == ch and z["carry_2"].shape[1] == ch
        assert z["carry_1"].dtype == np.int32


def test_migration_guards_step(runs):
    res = _load(runs, 2, "migration")["census"]
    assert res["migrated"] is True
    assert "reset_window" in res["raises"]
    assert res["guard_travels"] is True and "reset_window" in res[
        "raises_again"]
    assert res["same_index"] and res["resumed_max_diff"] <= 1e-6
    assert res["healthy"] is False and res["cleared"] is False


@pytest.mark.parametrize("world", WORLDS)
def test_errors_are_the_jax_texts(runs, world):
    import jax
    from jax.sharding import Mesh

    from emspec.parallel import (ShardedPipeline, ShardedStream,
                                 TimeParallelRenderer, ch_time_mesh,
                                 channel_mesh)

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    devs = jax.devices()[:world]
    three = JaxSettings(**worker.settings(channels=3))
    flat = channel_mesh(devs)
    grid = np.array(devs).reshape(-1, 1)
    want = {
        "pipe": message(lambda: ShardedPipeline(three, flat)),
        "stream": message(lambda: ShardedStream(three, flat)),
        "no_t": message(lambda: TimeParallelRenderer(
            JaxSettings(**worker.settings(channels=2)),
            Mesh(grid, ("a", "b")))),
        "ch_axis": message(lambda: TimeParallelRenderer(
            three, Mesh(grid, ("ch", "t")))),
        "mono": message(lambda: TimeParallelRenderer(
            JaxSettings(**worker.settings(channels=world)),
            Mesh(grid, ("ch", "t"))).render(np.zeros(40_000, np.float32))),
        "n_ch": message(lambda: ch_time_mesh(3, devs)),
    }
    got = _load(runs, world, "errors")["census"]
    assert got == want


# ------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    from emspec_torch.io import synth
    from emspec_torch.io.wav import write_wav

    d = tmp_path_factory.mktemp("wavs")
    write_wav(d / "m.wav", synth.chirp(200.0, 8000.0, 1.2)
              + synth.multitone([440.0, 880.0], 1.2, amplitude=0.4), 48_000)
    write_wav(d / "s.wav", np.stack([synth.tone(300.0, 1.0),
                                     synth.chirp(200.0, 6000.0, 1.0)]),
              48_000)
    return d


def _port_cli(args, launcher=()):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, *launcher, "-m", "emspec_torch",
                        *args, "--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize("wav,extra", [("m.wav", ["--multires"]),
                                       ("s.wav", ["--channel", "all"])])
def test_cli_time_parallel_matches_jax_and_plain_render(wavs, tmp_path,
                                                        wav, extra):
    from emspec.__main__ import main as jax_main

    out = {k: tmp_path / f"{k}.png" for k in ("jax", "tp", "plain")}
    assert jax_main(["render", str(wavs / wav), str(out["jax"]),
                     "--time-parallel", *extra]) == 0
    rc, so, se = _port_cli(["render", str(wavs / wav), str(out["tp"]),
                            "--time-parallel", *extra])
    assert rc == 0, se
    rc, _, se = _port_cli(["render", str(wavs / wav), str(out["plain"]),
                           *extra])
    assert rc == 0, se
    tp, plain, jx = (read_png(out[k]) for k in ("tp", "plain", "jax"))
    assert tp.shape == jx.shape == plain.shape
    assert _lut_steps(tp, plain)[0] <= 1
    assert float((tp != jx).any(-1).mean()) <= 1e-3


def test_cli_time_parallel_under_torchrun(wavs, tmp_path):
    """Two ranks started by torchrun render what one process renders."""
    one, two = tmp_path / "one.png", tmp_path / "two.png"
    args = ["render", str(wavs / "m.wav"), None, "--multires",
            "--time-parallel"]
    args[2] = str(one)
    assert _port_cli(args)[0] == 0
    args[2] = str(two)
    rc, so, se = _port_cli(args, ("-m", "torch.distributed.run",
                                  "--standalone", "--nproc-per-node", "2"))
    assert rc == 0, se
    assert so.count("two.png") == 1              # rank 0 alone writes
    assert _lut_steps(read_png(two), read_png(one))[0] <= 1


def test_cli_time_parallel_usage_error_is_the_jax_text(wavs, capsys):
    from emspec.__main__ import main as jax_main

    args = ["render", str(wavs / "m.wav"), "x.png", "--time-parallel"]
    assert jax_main(args) == 2
    want = capsys.readouterr().err
    rc, _, err = _port_cli(args)
    assert rc == 2 and err == want


def test_package_has_the_jax_packages_lazy_names():
    import emspec
    import emspec_torch
    from emspec_torch import parallel

    for name in ("ShardedPipeline", "ShardedStream", "channel_mesh",
                 "ch_time_mesh", "TimeParallelRenderer"):
        assert getattr(emspec, name).__name__ == name
        assert getattr(emspec_torch, name) is getattr(parallel, name)


class _NoValueReads(TorchDispatchMode):
    """Fails any read of a tensor's value to the host inside the block."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("host read of a tensor inside the step")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("agc", [False, True])
def test_sharded_stream_step_reads_no_host_value(agc):
    """The sharded hop, the global AGC's collective included, reads no
    value of the card's to the host (world size 1 in this process)."""
    import torch.distributed as dist

    from emspec_torch import parallel

    created = parallel.init_group("cpu")
    try:
        s = Settings(**worker.settings(channels=2, agc_global=agc))
        st = parallel.ShardedStream(s, parallel.channel_mesh(device="cpu"))
        x = worker.chirps(2, seconds=0.1)
        st.reset_window(x[:, :st.pipe.n_max])
        with _NoValueReads():
            for t in range(st.pipe.reach + 2):
                out = st.step(worker._block(st.pipe, x, t))
        assert out is not None and out[0] == 1
    finally:
        if created:
            dist.destroy_process_group()
