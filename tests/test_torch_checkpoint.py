"""The port's checkpoints (``emspec_torch.utils.checkpoint``) and tracing
(``emspec_torch.utils.tracing``) on the CPU, against the JAX package's
(``tests/test_ops.py``).

Tolerances: a port save resumed in the port is bit-exact against the
uninterrupted port stream (the CPU live path is bit-exact); a file
crossing between the packages resumes within the port's ``compare_vis``
(3×3 max-filters within 2/255 on all but 1e-4 of the cells), the
tolerance of ``test_jax_stream_checkpoint_resumes_in_port``.
"""

import json
import pickle
import time

import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.stream import Stream as JaxStream
from emspec.stream import stream_signal as jax_stream_signal
from emspec.utils import checkpoint as jax_checkpoint
from emspec_torch.config import Settings
from emspec_torch.convert import params_from_jax
from emspec_torch.io import synth
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.utils.checkpoint import load_stream, save_stream
from emspec_torch.utils.tracing import StageTimer, annotation, trace
from emspec_torch.validate import compare_vis

SR = 48_000
CASES = {
    "enhanced": dict(mode="enhanced", multires=False, fft_size=1024),
    "natural": dict(mode="natural", multires=False, fft_size=1024),
    "multires": dict(mode="enhanced", multires=True,
                     multires_sizes=(1024, 512)),
}


def _kw(case, **kw):
    return dict(CASES[case], raster_height=128, hop=256, smoothing=0.4,
                **kw)


def _signal(seconds, seed):
    rng = np.random.default_rng(seed)
    return (synth.chirp(100.0, 9000.0, seconds)
            + synth.multitone([440.0, 880.0, 1320.0], seconds, amplitude=0.3)
            + 0.01 * rng.standard_normal(int(seconds * SR))
            ).astype(np.float32)


def _columns(cols):
    return {c.index: np.asarray(c.vis) for c in cols}


def _assert_bit_exact(got, ref):
    assert sorted(got) == list(range(ref.shape[0]))
    for i, want in enumerate(ref):
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_save_resumes_bit_exact(case, tmp_path):
    s = Settings(**_kw(case))
    x = _signal(0.6, seed=1)
    half = 13_000
    st1 = Stream(s, "cpu")
    cols = st1.push(x[:half])
    save_stream(tmp_path / "s.npz", st1)
    st2 = Stream(s, "cpu")
    load_stream(tmp_path / "s.npz", st2)
    assert st2._window_ready
    cols += st2.push(x[half:]) + st2.flush()
    ref, _ = stream_signal(x, s, "cpu")
    _assert_bit_exact(_columns(cols), ref)


def test_file_layout_is_the_jax_packages(tmp_path):
    s = Settings(**_kw("multires", channels=2))
    x = np.stack([_signal(0.3, seed=2), _signal(0.3, seed=3)])
    st = Stream(s, "cpu")
    st.push(x)
    save_stream(tmp_path / "p.npz", st)
    js = JaxStream(JaxSettings(**_kw("multires", channels=2)))
    js.push(x)
    jax_checkpoint.save_stream(tmp_path / "j.npz", js)
    with np.load(tmp_path / "p.npz", allow_pickle=False) as zp, \
            np.load(tmp_path / "j.npz", allow_pickle=False) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].shape == zj[k].shape, k
            assert zp[k].dtype == zj[k].dtype, k
        for k in ("t", "next_frame", "ring_total", "dropped", "carry_1"):
            assert int(zp[k]) == int(zj[k]), k
        np.testing.assert_array_equal(zp["ring_data"], zj["ring_data"])


@pytest.mark.parametrize("case", ["enhanced", "multires"])
def test_jax_file_resumes_in_port(case, tmp_path):
    kw = _kw(case)
    x = _signal(0.6, seed=4)
    half = 13_000
    js = JaxStream(JaxSettings(**kw))
    cols_a = js.push(x[:half])
    jax_checkpoint.save_stream(tmp_path / "j.npz", js)
    ts = Stream(Settings(**kw), "cpu",
                params=params_from_jax(js.params, "cpu"))
    load_stream(tmp_path / "j.npz", ts)
    cols_b = ts.push(x[half:]) + ts.flush()
    assert [c.index for c in cols_b] == list(
        range(len(cols_a), len(cols_a) + len(cols_b)))
    ref, _ = jax_stream_signal(x, JaxSettings(**kw))
    got = np.stack([np.asarray(c.vis) for c in cols_a]
                   + [c.vis.numpy() for c in cols_b])
    ok, worst, share = compare_vis(torch.from_numpy(np.asarray(ref)),
                                   torch.from_numpy(got))
    assert ok, (worst, share)


@pytest.mark.parametrize("case", ["enhanced", "multires"])
def test_port_file_resumes_in_jax(case, tmp_path):
    kw = _kw(case)
    x = _signal(0.6, seed=5)
    half = 13_000
    ts = Stream(Settings(**kw), "cpu")
    cols_a = ts.push(x[:half])
    save_stream(tmp_path / "p.npz", ts)
    js = JaxStream(JaxSettings(**kw))
    jax_checkpoint.load_stream(tmp_path / "p.npz", js)
    cols_b = js.push(x[half:]) + js.flush()
    assert [c.index for c in cols_b] == list(
        range(len(cols_a), len(cols_a) + len(cols_b)))
    ref, _ = jax_stream_signal(x, JaxSettings(**kw))
    got = np.stack([c.vis.numpy() for c in cols_a]
                   + [np.asarray(c.vis) for c in cols_b])
    ok, worst, share = compare_vis(torch.from_numpy(np.asarray(ref)),
                                   torch.from_numpy(got))
    assert ok, (worst, share)


def test_extensionless_path_roundtrip(tmp_path):
    s = Settings(**_kw("natural"))
    st1 = Stream(s, "cpu")
    st1.push(synth.tone(440.0, 0.1, SR))
    save_stream(tmp_path / "ckpt", st1)
    assert (tmp_path / "ckpt.npz").exists()
    st2 = Stream(s, "cpu")
    load_stream(tmp_path / "ckpt", st2)
    assert st2._t == st1._t and st2._next_frame == st1._next_frame


@pytest.mark.parametrize("case", ["enhanced", "natural"])
def test_pre_rolling_layout_migrates_and_reprimes(case, tmp_path):
    """A snapshot from before the rolling window (the inner leaves only)
    loads with a zeroed window, which the replayed ring re-primes: the
    continuation equals the uninterrupted stream bit for bit."""
    s = Settings(**_kw(case))
    x = _signal(0.5, seed=6)
    half = len(x) // 2
    ck = tmp_path / "s.npz"
    st1 = Stream(s, "cpu")
    cols = st1.push(x[:half])
    save_stream(ck, st1)
    z = dict(np.load(ck, allow_pickle=False))
    n_carry = sum(1 for k in z if k.startswith("carry_"))
    old = {k: v for k, v in z.items() if not k.startswith("carry_")}
    for i in range(1, n_carry):
        old[f"carry_{i - 1}"] = z[f"carry_{i}"]
    np.savez(ck, **old)
    st2 = Stream(s, "cpu")
    load_stream(ck, st2)
    assert st2._window_ready is False
    cols += st2.push(x[half:]) + st2.flush()
    ref, _ = stream_signal(x, s, "cpu")
    _assert_bit_exact(_columns(cols), ref)


def test_pickles_and_foreign_layouts_are_refused(tmp_path):
    st = Stream(Settings(**_kw("natural")), "cpu")
    bad = tmp_path / "evil.npz"
    bad.write_bytes(pickle.dumps({"boom": 1}))
    with pytest.raises(ValueError):
        load_stream(bad, st)
    np.savez(tmp_path / "few.npz", carry_0=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="carry leaves"):
        load_stream(tmp_path / "few.npz", st)


def test_trace_writes_a_chrome_trace_with_its_spans(tmp_path):
    s = Settings(**_kw("enhanced"))
    from emspec_torch.pipeline import Pipeline
    pipe = Pipeline(s, "cpu")
    x = _signal(0.3, seed=7)
    with trace(tmp_path / "tr"):
        with annotation("emspec_batch"):
            pipe.process(x)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "emspec_batch" in names
    assert any(str(n).startswith("aten::") for n in names)


def test_stage_timer_measures_its_sleeps():
    timer = StageTimer()
    timer.start()
    time.sleep(0.05)
    a = timer.stop("a", torch.zeros(3), (torch.ones(2),))
    time.sleep(0.02)
    b = timer.stop("b")
    timer.stop("a")
    assert 0.05 <= a < 0.5 and 0.02 <= b < 0.5
    rep = timer.report_us()
    assert set(rep) == {"a", "b"} and rep["a"] >= a * 1e6 - 1
