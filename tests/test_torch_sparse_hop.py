"""Every live path of the port at a hop longer than the largest frame
(``hop > n_max``: a sparse overview, a column every few frames' length),
on the CPU, against the batch that renders the same settings.

The live window rolls by ``Pipeline.roll`` = min(hop, n_max) samples a
hop, so hop t's window is the samples [t·hop, t·hop + n_max) alone, the
batch's frame t.  Held here:

* ``Stream`` / ``stream_signal`` in 777-sample pushes ≡ the port's
  ``Pipeline.process``, bit for bit in vis and rgba (enhanced stencil and
  direct, natural, multires in stereo; hop n_max and n_max − 1 as
  controls);
* the port's batch against the JAX package's **batch** (its ``Stream``
  streams other columns than its batch at these hops), with the
  tolerances of ``tests/test_torch_pipeline.py``: power by
  ``compare_grids``, vis by ``compare_vis`` (3×3 max-filters within 2/255
  on all but 1e-4 of the cells) — the port's stream the same way;
* ``EmSpecApp``'s painted columns ≡ ``process``;
* ``stream_signal_sharded`` on gloo groups of 2 and 4 ranks ≡ the batch,
  and a sharded stream saved mid-stream and resumed ≡ the batch;
* a ``Stream`` saved mid-stream and resumed ≡ the batch, bit for bit; a
  file whose window is not ``n_max`` long (the JAX ``Stream``'s at these
  hops) is refused with a ``ValueError``;
* ``python -m emspec_torch stream --hop 16384`` on the display default.

The bit-for-bit comparisons run on one intra-op thread: the CPU's
threaded reductions may split a sum differently at another batch shape.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from emspec.config import Settings as JaxSettings
from emspec.pipeline import Pipeline as JaxPipeline
from emspec.stream import Stream as JaxStream
from emspec.utils import checkpoint as jax_checkpoint
from emspec_torch.__main__ import main
from emspec_torch.app import EmSpecApp
from emspec_torch.config import Settings
from emspec_torch.convert import params_from_jax
from emspec_torch.io import synth
from emspec_torch.io.wav import write_wav
from emspec_torch.pipeline import Pipeline
from emspec_torch.render.png import read_png
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.utils.checkpoint import load_stream, save_stream
from emspec_torch.validate import compare_grids, compare_vis

ROOT = Path(__file__).resolve().parents[1]
SR = 48_000
ENH = dict(mode="enhanced", multires=False, fft_size=1024)
CASES = {       # name → Settings kwargs (raster_height 128, smoothing 0.3)
    "enhanced_1025": dict(ENH, hop=1025),
    "enhanced_2048": dict(ENH, hop=2048),
    "enhanced_3000": dict(ENH, hop=3000),
    "direct_2048": dict(ENH, hop=2048, fft_method="direct"),
    "natural_2048": dict(mode="natural", multires=False, fft_size=1024,
                         hop=2048),
    "multires_stereo_4096": dict(mode="enhanced", multires=True,
                                 multires_sizes=(2048, 1024, 512), hop=4096,
                                 channels=2),
    # controls: a hop of the largest frame and one below it
    "control_1024": dict(ENH, hop=1024),
    "control_1023": dict(ENH, hop=1023),
}


def _settings(case, cls=Settings):
    return cls(raster_height=128, smoothing=0.3, **CASES[case])


def _signal(seconds=1.0, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    x = (synth.chirp(100.0, 9000.0, seconds)
         + synth.multitone([440.0, 880.0, 1320.0], seconds, amplitude=0.3)
         + 0.01 * rng.standard_normal(int(seconds * SR))).astype(np.float32)
    if channels == 2:
        x = np.stack([x, (synth.tone(300.0, seconds, amplitude=0.5)
                          + 0.02 * rng.standard_normal(x.shape[-1])
                          ).astype(np.float32)])
    return x


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(s, x):
    vis, rgba, _ = Pipeline(s, "cpu").process(x)
    return vis.numpy(), rgba.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_equals_batch(case, one_thread):
    s = _settings(case)
    x = _signal(channels=s.channels)
    vis_b, rgba_b = _batch(s, x)
    vis_s, rgba_s = stream_signal(x, s, "cpu", chunk=777)
    assert vis_s.shape == vis_b.shape and vis_b.shape[0] >= 10
    np.testing.assert_array_equal(vis_s, vis_b)
    np.testing.assert_array_equal(rgba_s, rgba_b)


@pytest.mark.parametrize("case", ["enhanced_2048", "natural_2048",
                                  "multires_stereo_4096"])
def test_batch_and_stream_match_the_jax_batch(case):
    """The JAX package's batch is the reference at these hops; its
    ``Stream`` is not (ROADMAP: outside the port)."""
    s, js = _settings(case), _settings(case, JaxSettings)
    x = _signal(channels=s.channels)
    jp, tp = JaxPipeline(js), Pipeline(s, "cpu")
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    vis_j, _, _ = jp.process(x, jparams)
    vis_t, _, _ = tp.process(x, p)
    assert vis_t.shape == tuple(vis_j.shape)
    t_count = tp.num_columns(x.shape[-1])
    if s.mode == "enhanced":
        power_j = jax.jit(jp._enhanced_power, static_argnums=1)(
            jnp.asarray(x), t_count, jparams)
        cmp = compare_grids(torch.from_numpy(np.array(power_j)),
                            tp._enhanced_power(tp.to_device(x), t_count, p))
        assert cmp.ok, cmp
    want = torch.from_numpy(np.array(vis_j))
    for got in (vis_t, torch.from_numpy(stream_signal(x, s, "cpu",
                                                      chunk=777)[0])):
        ok, worst, share = compare_vis(want, got)
        assert ok, (worst, share)


@pytest.mark.parametrize("case", ["enhanced_2048", "multires_stereo_4096"])
def test_app_columns_equal_process(case, tmp_path, one_thread):
    s = _settings(case)
    x = _signal(channels=s.channels)
    app = EmSpecApp(s, user_dir=tmp_path, device="cpu")
    got, paint = [], app._paint

    def keep(cols):
        got.extend((c.index, c.vis.clone(), c.rgba.clone()) for c in cols)
        return paint(cols)
    app._paint = keep
    for i in range(0, x.shape[-1], 777):
        app.push_audio(x[..., i:i + 777])
    app.close()
    vis_b, rgba_b = _batch(s, x)
    assert [i for i, _, _ in got] == list(range(vis_b.shape[0]))
    np.testing.assert_array_equal(torch.stack([v for _, v, _ in got]), vis_b)
    np.testing.assert_array_equal(torch.stack([c for _, _, c in got]),
                                  rgba_b)


@pytest.mark.parametrize("half", (20_000, 21_500))
@pytest.mark.parametrize("lapped", (False, True))
@pytest.mark.parametrize("case", ["enhanced_3000", "multires_stereo_4096"])
def test_checkpoint_resumes_bit_exact(case, lapped, half, tmp_path,
                                      one_thread):
    """Saved after ``half`` samples.  ``lapped``: the save's read of the
    whole ring reports an overrun (a producer's push), so the file keeps
    the span from the stream's first unread sample, the next hop's block:
    part of it written at 21,500 samples, none yet at 20,000."""
    s = _settings(case)
    x = _signal(channels=s.channels)
    st1 = Stream(s, "cpu")
    cols = st1.push(x[..., :half])
    if lapped:
        read = st1.ring.window_at

        def overrun(start, n):
            st1.ring.window_at = read
            raise ValueError("overrun")
        st1.ring.window_at = overrun
    save_stream(tmp_path / "s.npz", st1)
    with np.load(tmp_path / "s.npz") as z:
        kept, total = z["ring_data"].shape[-1], int(z["ring_total"])
        # the next hop's block starts at next_frame·hop + n_max − roll
        first = int(z["next_frame"]) * st1.pipe.hop + (
            st1.pipe.n_max - st1.pipe.roll)
        assert total == half
        assert total - kept == (min(first, total) if lapped else 0)
    st2 = Stream(s, "cpu")
    load_stream(tmp_path / "s.npz", st2)
    assert st2._window_ready
    cols += st2.push(x[..., half:]) + st2.flush()
    vis_b, rgba_b = _batch(s, x)
    assert [c.index for c in cols] == list(range(vis_b.shape[0]))
    np.testing.assert_array_equal(torch.stack([c.vis for c in cols]), vis_b)
    np.testing.assert_array_equal(torch.stack([c.rgba for c in cols]),
                                  rgba_b)


def test_checkpoint_refuses_a_hop_long_window(tmp_path):
    """The JAX ``Stream`` at a hop past n_max rolls a hop-long window and
    streams other columns than its batch: its file is refused before the
    stream is touched."""
    js = _settings("enhanced_2048", JaxSettings)
    x = _signal(0.3)
    jst = JaxStream(js)
    assert jst.push(x)
    jax_checkpoint.save_stream(tmp_path / "j.npz", jst)
    with np.load(tmp_path / "j.npz") as z:
        assert z["carry_0"].shape[-1] == 2048
    st = Stream(_settings("enhanced_2048"), "cpu")
    with pytest.raises(ValueError, match="window holds 2048 samples"):
        load_stream(tmp_path / "j.npz", st)
    assert st.ring.total_written == 0


def _run_world(out: Path, world: int) -> None:
    """The ``sparse_hop`` step of ``tests/torch_parallel_worker.py`` on
    ``world`` gloo ranks over a FileStore."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, json.dumps(dict(
            rank=r, world=world, store=str(out / "store"), out=str(out),
            steps=["sparse_hop"]))], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = [p.communicate(timeout=300)[1][-3000:] for p in procs]
    assert all(p.returncode == 0 for p in procs), errs


@pytest.mark.parametrize("world", (2, 4))
def test_sharded_stream_equals_batch(world, tmp_path, one_thread):
    _run_world(tmp_path, world)
    x = worker.sparse_signal(world)
    for name, kw in worker.SPARSE.items():
        s = Settings(**kw, channels=world)
        vis_b, rgba_b = _batch(s, x)
        with np.load(tmp_path / f"{name}.npz") as z:
            np.testing.assert_array_equal(z["vis"], vis_b, err_msg=name)
            np.testing.assert_array_equal(z["rgba"], rgba_b, err_msg=name)
            first = int(z["first"])
            np.testing.assert_array_equal(z["resumed"], vis_b[first:],
                                          err_msg=name)
        assert first == vis_b.shape[0] // 2


def test_cli_stream_on_the_display_default(tmp_path, capsys):
    """``stream --hop 16384``: the display default (largest bank 8192), a
    column every 0.34 s, as many columns as the batch's."""
    wav = tmp_path / "t.wav"
    x = _signal(2.0)
    write_wav(str(wav), x, SR)
    png = tmp_path / "o.png"
    assert main(["stream", str(wav), str(png), "--hop", "16384",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    pipe = Pipeline(Settings(hop=16384), "cpu")
    assert pipe.n_max == 8192 and pipe.num_columns(x.size) == 6
    assert "streamed 6 columns x1ch (reach=0 hops)" in out, out
    assert read_png(str(png))[..., :3].max() > 0
