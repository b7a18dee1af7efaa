"""The port's application controller (``emspec_torch.app.EmSpecApp``),
``prewarm`` and the terminal view, on the CPU (``device="cpu"``), against
the JAX package's (``tests/test_app.py``, ``tests/test_terminal.py``).

Tolerances: the app's image after the same pushes (and the same
continuous and structural changes) differs from the JAX app's on at most
1e-3 of the pixels, the tolerance of ``test_animate_frames_match_jax``
(float32 FFT rounding can move a reassigned deposit or tip a value over
a colormap edge); the change kinds, hover readouts, axis ticks, column
counts and ANSI frames are host results: equal.
"""

import io
import threading
import time

import numpy as np
import pytest

from emspec.app import EmSpecApp as JaxApp
from emspec.config import Settings as JaxSettings
from emspec.render import terminal as jax_terminal
from emspec_torch import kernels_build
from emspec_torch.app import EmSpecApp
from emspec_torch.config import Settings
from emspec_torch.device import CARD_LOCK
from emspec_torch.integrations import live_state
from emspec_torch.io import synth
from emspec_torch.io.wav import write_wav
from emspec_torch.render import terminal

SR = 48_000
PIXEL_SHARE = 1e-3


def _app(tmp_path, **kw):
    kw.setdefault("multires", True)
    kw.setdefault("multires_sizes", (1024, 512))
    kw.setdefault("raster_height", 64)
    kw.setdefault("raster_width", 32)
    kw.setdefault("hop", 256)
    return EmSpecApp(Settings(**kw), user_dir=tmp_path, device="cpu")


def _signal(seconds, seed):
    """A chirp 200 Hz → 6 kHz, three tones of 0.1 and 1% noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = (0.5 * np.sin(2 * np.pi * (200 * t + 0.5 * 5800 / seconds * t * t))
         + sum(0.1 * np.sin(2 * np.pi * f * t) for f in (440, 880, 1320))
         + 0.01 * rng.standard_normal(t.size))
    return x.astype(np.float32)


# ----------------------------------------------------- the controller
def test_audio_to_image(tmp_path):
    app = _app(tmp_path)
    assert app.device.type == "cpu" and app.stream.device.type == "cpu"
    n = app.push_audio(synth.tone(440.0, 0.3, SR))
    assert n > 0
    img = app.image()
    assert img.shape == (64, 32, 4) and img.dtype == np.uint8
    assert img[..., :3].max() > 0      # something was painted


def test_continuous_change_keeps_stream_and_captures(tmp_path):
    app = _app(tmp_path)
    stream_before = app.stream
    pipe_before = app.stream.pipe
    params_before = app.stream.params
    captures = app.stream.captures
    assert app.set(gain=9.0, colormap="viridis", db_range=80.0) == "continuous"
    assert app.stream is stream_before          # no new stream
    assert app.stream.pipe is pipe_before
    assert app.stream.captures == captures      # nothing re-captured
    # the new values went INTO the stream's own tensors
    assert app.stream.params is params_before
    np.testing.assert_array_equal(app.stream.params.lut.numpy(),
                                  app.stream.pipe.params(app.settings).lut)
    assert app.set(gain=9.0, colormap="viridis", db_range=80.0) == "noop"


def test_structural_change_swaps_and_closes_stream(tmp_path):
    app = _app(tmp_path)
    app.push_audio(synth.tone(440.0, 0.1, SR))
    stream_before = app.stream
    assert app.set(mode="natural") == "structural"
    assert app.stream is not stream_before
    assert app.stream.device == app.device
    with pytest.raises(RuntimeError):            # the old stream is closed
        stream_before.push(np.zeros(16, np.float32))
    assert app.push_audio(synth.tone(440.0, 0.1, SR)) > 0  # keeps working


def test_preset_roundtrip(tmp_path):
    app = _app(tmp_path)
    app.set(low_end_boost=7.5)
    app.save_preset("Bass Heavy")
    app.set(low_end_boost=1.0)
    assert app.load_preset("Bass Heavy") == "continuous"
    assert app.settings.low_end_boost == 7.5
    app2 = _app(tmp_path)                       # persisted across apps
    assert app2.presets.get("Bass Heavy").low_end_boost == 7.5
    app2.delete_preset("Bass Heavy")
    assert "Bass Heavy" not in _app(tmp_path).presets.names()


def test_m4l_pause_resume_via_state_file(tmp_path):
    app = _app(tmp_path)
    live_state.write_state(tmp_path / "live_state.json", "minimized")
    assert app.push_audio(synth.tone(440.0, 0.1, SR)) == 0   # paused
    live_state.write_state(tmp_path / "live_state.json", "restored")
    assert app.push_audio(synth.tone(440.0, 0.1, SR)) > 0


def test_m4l_pause_survives_structural_change(tmp_path):
    app = _app(tmp_path)
    live_state.write_state(tmp_path / "live_state.json", "minimized")
    app.push_audio(synth.tone(440.0, 0.05, SR))              # registers pause
    app.set(mode="natural")                                  # swap stream
    assert app.push_audio(synth.tone(440.0, 0.1, SR)) == 0   # still paused
    live_state.write_state(tmp_path / "live_state.json", "restored")
    assert app.push_audio(synth.tone(440.0, 0.2, SR)) > 0


def test_window_hooks_follow_the_state_file(tmp_path):
    app = _app(tmp_path)
    seen = []
    app.on_minimized = lambda: seen.append("min")
    app.on_restored = lambda: seen.append("res")
    live_state.write_state(tmp_path / "live_state.json", "minimized")
    app.watcher.poll()
    live_state.write_state(tmp_path / "live_state.json", "restored")
    app.watcher.poll()
    assert seen == ["min", "res"]


def test_hover(tmp_path):
    app = _app(tmp_path, raster_height=512)   # fine enough to resolve A4
    row = app.stream.pipe.row_of_frequency(440.0)
    assert "A4" in app.hover(row)
    assert "Hz" in app.hover(0)


def test_scroll_speed_is_continuous(tmp_path):
    app = _app(tmp_path)
    assert app.set(scroll_speed=2.0) == "continuous"
    assert app.waterfall.scroll_speed == 2.0


def test_hover_tracks_continuous_freq_scale(tmp_path):
    import math
    app = _app(tmp_path, raster_height=256)
    top_before = app.hover(255)
    assert app.set(freq_scale=2.0) == "continuous"
    top_after = app.hover(255)
    assert top_before != top_after
    f = float(top_after.split(" ")[0])
    expect = math.sqrt(app.settings.freq_min * app.settings.freq_max)
    assert abs(f / expect - 1) < 0.01


def test_multichannel_app_displays_one_channel(tmp_path):
    app = _app(tmp_path, channels=2)
    x = np.stack([synth.tone(440.0, 0.15, SR), synth.tone(880.0, 0.15, SR)])
    assert app.push_audio(x) > 0
    img0 = app.image()
    assert img0.shape == (64, 32, 4)
    assert app.set(display_channel=1) == "continuous"


def test_crossover_change_is_structural(tmp_path):
    app = _app(tmp_path)
    assert app.set(crossover_low=500.0) == "structural"
    assert app.set(freq_min=40.0) == "structural"


def test_raster_size_change_builds_a_new_waterfall(tmp_path):
    app = _app(tmp_path)
    wf = app.waterfall
    assert app.set(raster_height=32) == "structural"
    assert app.waterfall is not wf and app.image().shape == (32, 32, 4)
    wf = app.waterfall
    assert app.set(mode="natural") == "structural"
    assert app.waterfall is wf                  # the display carries over


def test_apply_settings_is_exception_safe(tmp_path, monkeypatch):
    """A failing construction of the new stream leaves the app on its old,
    consistent state, still working."""
    import emspec_torch.app as app_mod

    app = _app(tmp_path)
    old_settings, old_stream = app.settings, app.stream

    def boom(_settings, *a, **kw):
        raise RuntimeError("construction-time failure")

    monkeypatch.setattr(app_mod, "Stream", boom)
    with pytest.raises(RuntimeError):
        app.set(fft_size=512)
    assert app.settings == old_settings
    assert app.stream is old_stream
    monkeypatch.undo()
    assert app.set(gain=9.0) == "continuous"
    assert app.push_audio(synth.tone(440.0, 0.3, SR)) > 0


def _entry_points():
    from emspec_torch.pipeline import prewarm
    from emspec_torch.shell import ShellServer
    s = Settings(multires=False, fft_size=1024, raster_height=32)
    return {
        "EmSpecApp": lambda d: EmSpecApp(s, user_dir=d),
        "ShellServer": lambda d: ShellServer(s, port=0, source="synthetic",
                                             user_dir=d),
        "prewarm": lambda d: prewarm(s, (512,), background=False),
        "live_view": lambda d: terminal.live_view(
            (np.zeros((1, 4096), np.float32), SR), s, realtime=False,
            out=io.StringIO()),
        "live_capture_view": lambda d: terminal.live_capture_view(
            s, backend="synthetic", duration=0.1, out=io.StringIO()),
    }


@pytest.mark.parametrize("name", ["EmSpecApp", "ShellServer", "prewarm",
                                  "live_view", "live_capture_view"])
def test_default_device_is_the_card(tmp_path, name):
    """No ``device`` means the card: without one, each entry point raises
    instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        _entry_points()[name](tmp_path)


# ----------------------------------------------------- against JAX
APP_CASES = {
    "enhanced-multires": dict(multires=True, multires_sizes=(2048, 1024),
                              hop=256),
    "natural-1024": dict(multires=False, fft_size=1024, mode="natural"),
    "enhanced-2048": dict(multires=False, fft_size=2048),
    "enhanced-1024": dict(multires=False, fft_size=1024),
    "natural-multires": dict(multires=True, multires_sizes=(2048, 1024),
                             mode="natural", hop=256),
}


@pytest.mark.parametrize("name", sorted(APP_CASES))
def test_app_image_matches_jax(name, tmp_path):
    """The same pushes, one continuous change midway: equal column counts
    and the images within 1e-3 of the pixels."""
    kw = dict(APP_CASES[name], raster_height=96, raster_width=64)
    x = _signal(1.0, seed=sorted(APP_CASES).index(name))
    want = JaxApp(JaxSettings(**kw), user_dir=tmp_path / "jax")
    got = EmSpecApp(Settings(**kw), user_dir=tmp_path / "port", device="cpu")
    for i in range(0, x.size, 1500):
        assert got.push_audio(x[i:i + 1500]) == want.push_audio(x[i:i + 1500])
        if i == 15000:
            assert got.set(gain=7.0, smoothing=0.3) == want.set(
                gain=7.0, smoothing=0.3) == "continuous"
    a, b = got.image(), want.image()
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert float((a != b).any(-1).mean()) <= PIXEL_SHARE


def test_structural_swap_image_matches_jax(tmp_path):
    """Enhanced → Natural and an FFT-size change midway, the display
    carried over in both packages."""
    kw = dict(multires=False, fft_size=1024, raster_height=64,
              raster_width=96)
    x = _signal(1.2, seed=11)
    want = JaxApp(JaxSettings(**kw), user_dir=tmp_path / "jax")
    got = EmSpecApp(Settings(**kw), user_dir=tmp_path / "port", device="cpu")
    changes = {9000: dict(mode="natural"), 30000: dict(fft_size=2048)}
    for i in range(0, x.size, 1500):
        assert got.push_audio(x[i:i + 1500]) == want.push_audio(x[i:i + 1500])
        if i in changes:
            assert got.set(**changes[i]) == want.set(**changes[i]) \
                == "structural"
    a, b = got.image(), want.image()
    assert float((a != b).any(-1).mean()) <= PIXEL_SHARE


def test_change_kinds_match_jax(tmp_path):
    changes = [dict(gain=5.0), dict(gain=5.0), dict(fft_size=2048),
               dict(colormap="magma"), dict(mode="natural"),
               dict(freq_scale=2.0), dict(multires=True),
               dict(scroll_speed=0.5), dict(crossover_high=3000.0),
               dict(smoothing=0.5, agc_strength=0.3), dict(on_top=True),
               dict(hop=512), dict(raster_width=48)]
    kw = dict(multires=False, fft_size=1024, raster_height=64,
              raster_width=32, hop=256, multires_sizes=(1024, 512))
    want = JaxApp(JaxSettings(**kw), user_dir=tmp_path / "jax")
    got = EmSpecApp(Settings(**kw), user_dir=tmp_path / "port", device="cpu")
    kinds = []
    for c in changes:
        k = got.set(**c)
        assert k == want.set(**c), c
        assert got.settings.to_dict() == want.settings.to_dict()
        kinds.append(k)
    assert {"continuous", "structural", "noop"} == set(kinds)


@pytest.mark.parametrize("zoom", [1.0, 2.0, 0.5])
def test_hover_and_axis_ticks_match_jax(tmp_path, zoom):
    kw = dict(multires=False, fft_size=1024, raster_height=128,
              raster_width=16)
    want = JaxApp(JaxSettings(**kw), user_dir=tmp_path / "jax")
    got = EmSpecApp(Settings(**kw), user_dir=tmp_path / "port", device="cpu")
    want.set(freq_scale=zoom)
    got.set(freq_scale=zoom)
    assert got.axis_ticks() == want.axis_ticks()
    for row in (0, 1, 40, 64, 127):
        assert got.hover(row) == want.hover(row)


# ----------------------------------------------------- prewarm
def test_prewarm_fills_the_pipeline_cache(tmp_path):
    """A warmed size is a pipeline-cache hit when the app swaps to it."""
    from emspec_torch.pipeline import _cached_pipeline, prewarm

    s = Settings(mode="natural", multires=False, fft_size=1024,
                 raster_height=32, raster_width=16, hop=256)
    assert prewarm(s, (512,), background=False, device="cpu") is None
    app = EmSpecApp(s, user_dir=tmp_path, prewarm_sizes=(2048,),
                    device="cpu")
    app._warm_future.result(timeout=120)
    assert app._warm_future.done()
    before = _cached_pipeline.cache_info().hits
    assert app.set(fft_size=512) == "structural"
    assert app.set(fft_size=2048) == "structural"
    assert _cached_pipeline.cache_info().hits >= before + 2
    app.close()
    assert app._warm_future is None


def test_prewarm_variants_and_signature():
    """The JAX signature plus ``device``; the single-bank variant of each
    size, and a multires base itself."""
    import inspect

    import emspec.pipeline as jax_pipeline
    from emspec_torch import pipeline

    got = list(inspect.signature(pipeline.prewarm).parameters)
    want = list(inspect.signature(jax_pipeline.prewarm).parameters)
    assert got == want + ["device"]
    seen = []
    orig = pipeline._warm_step
    try:
        pipeline._warm_step = lambda s, dev: seen.append(
            (s.multires, s.fft_size, dev.type, CARD_LOCK._is_owned()))
        base = Settings(raster_height=32)
        pipeline.prewarm(base, (512, 4096), background=False, device="cpu")
    finally:
        pipeline._warm_step = orig
    # each job holds the card lock
    assert seen == [(False, 512, "cpu", True), (False, 4096, "cpu", True),
                    (True, base.fft_size, "cpu", True)]


def test_prewarm_in_the_background_can_be_cancelled():
    """Jobs queued behind a busy warmer are dropped by ``cancel()``."""
    from emspec_torch.pipeline import _warm_pool, prewarm

    gate = threading.Event()
    blocker = _warm_pool().submit(gate.wait, 30)
    try:
        h = prewarm(Settings(multires=False, fft_size=1024, raster_height=32),
                    (512, 2048), background=True, device="cpu")
        assert len(h.futures) == 2 and not h.done()
        h.cancel()
        assert all(f.cancelled() for f in h.futures) and h.done()
    finally:
        gate.set()
        blocker.result(timeout=30)


def test_kernel_library_builds_once_across_threads(monkeypatch):
    """Two threads that reach ``library()`` together build it once."""
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)
        return "libfake.so"

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(kernels_build, "build", slow_build)
    monkeypatch.setattr(kernels_build.ctypes, "CDLL", lambda path: FakeLib())
    kernels_build._load.cache_clear()
    try:
        got = []
        threads = [threading.Thread(
            target=lambda: got.append(kernels_build.library()))
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(calls) == 1 and len({id(g) for g in got}) == 1
    finally:
        kernels_build._load.cache_clear()


# ----------------------------------------------------- terminal view
def test_frame_to_ansi_matches_jax():
    rng = np.random.default_rng(4)
    for shape, cols, rows in (((64, 32, 4), 16, 8), ((37, 101, 4), 40, 11),
                              ((512, 1024, 4), 160, 50)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert terminal.frame_to_ansi(img, cols, rows) == \
            jax_terminal.frame_to_ansi(img, cols, rows)
    img = np.zeros((64, 32, 4), np.uint8)
    img[10:20, :, 0] = 200          # a red band
    s = terminal.frame_to_ansi(img, cols=16, rows=8)
    assert s.count("\n") == 7 and "200;0;0" in s and s.endswith("\x1b[0m")


def test_live_view_matches_jax(tmp_path):
    wav = tmp_path / "t.wav"
    write_wav(wav, synth.tone(440.0, 0.2), SR)
    kw = dict(multires=True, multires_sizes=(1024, 512), raster_height=64,
              hop=256)
    buf, jbuf = io.StringIO(), io.StringIO()
    n = terminal.live_view(str(wav), Settings(**kw), width=64,
                           realtime=False, out=buf, device="cpu")
    want = jax_terminal.live_view(str(wav), JaxSettings(**kw), width=64,
                                  realtime=False, out=jbuf)
    out = buf.getvalue()
    assert n == want > 0
    assert "\x1b[2J" in out and "\x1b[?25h" in out
    assert out.count("▀") == jbuf.getvalue().count("▀") > 1000


def test_live_capture_view_reports_its_backend():
    s = Settings(mode="natural", multires=False, fft_size=1024,
                 raster_height=128, hop=256)
    out, opened = io.StringIO(), []
    n = terminal.live_capture_view(
        s, backend="auto", duration=1.2, width=64, out=out, device="cpu",
        on_open=lambda cap: opened.append(terminal.capture_backend(cap)))
    assert n > 10 and "\x1b[38;2;" in out.getvalue()
    try:
        import sounddevice  # noqa: F401
    except ImportError:
        assert opened == ["synthetic"]       # auto without sounddevice
