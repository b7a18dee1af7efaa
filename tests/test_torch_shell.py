"""The port's window shells on the CPU (``device="cpu"``): the web shell
(``emspec_torch.shell.ShellServer``) over HTTP, its feeder
(``shell.feed.AudioFeeder``) and the native window (``shell.native``)
through a fake Tk — ``tests/test_{shell,feed,native_shell}.py`` on the
port — and the host-only endpoints held to the JAX shell's.

Tolerances: ``/api/settings``, ``/api/axis``, ``/api/hover`` and
``/api/presets`` answer exactly what the JAX shell answers for the same
requests, and a change reports the same kind; ``/api/meta`` carries the
same keys and lists, with the torch device for the JAX backend.
"""

import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from emspec.shell import ShellServer as JaxShellServer
from emspec.config import Settings as JaxSettings
from emspec_torch.app import EmSpecApp
from emspec_torch.config import Settings
from emspec_torch.integrations.live_state import write_state
from emspec_torch.shell import ShellServer
from emspec_torch.shell.feed import AudioFeeder
from emspec_torch.shell.native import NativeWindow, hover_row, rgba_to_ppm

KW = dict(mode="natural", multires=False, fft_size=1024, raster_height=128,
          raster_width=256, hop=256)


@pytest.fixture()
def shell(tmp_path):
    srv = ShellServer(Settings(**KW), port=0, source="synthetic",
                      user_dir=tmp_path / "userdir", device="cpu")
    srv.start()
    yield srv
    srv.stop()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                timeout=10) as r:
        return r.read()


def _post(srv, path, payload=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(payload or {}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _frame(srv):
    raw = _get(srv, "/api/frame")
    h = int.from_bytes(raw[:4], "big")
    w = int.from_bytes(raw[4:8], "big")
    return np.frombuffer(raw[8:], np.uint8).reshape(h, w, 4)


# ------------------------------------------------------------ web shell
def test_page_and_meta(shell):
    page = _get(shell, "/").decode()
    assert "<canvas" in page and "Freq Scale" in page
    meta = json.loads(_get(shell, "/api/meta"))
    assert 4096 in meta["fft_sizes"] and "inferno" in meta["colormaps"]
    assert meta["version"]
    assert meta["backend"] == "cpu" and meta["device"] == "cpu"
    assert shell.feeder.backend == "synthetic"


def test_frame_updates_live(shell):
    time.sleep(1.0)                    # let capture fill some columns
    a = _frame(shell)
    assert a.shape == (128, 256, 4)
    time.sleep(0.8)
    b = _frame(shell)
    assert a.any() or b.any()
    assert not np.array_equal(a, b)    # the display is scrolling
    assert shell.columns_emitted > 0 and len(shell.tick_ms) > 0


def test_settings_contract_over_http(shell):
    stream = shell.app.stream
    r = _post(shell, "/api/settings", {"gain": 9.0})
    assert r["kind"] == "continuous" and r["settings"]["gain"] == 9.0
    assert shell.app.stream is stream and stream.captures == 0  # CPU: eager
    r = _post(shell, "/api/settings", {"colormap": "viridis"})
    assert r["kind"] == "continuous"
    r = _post(shell, "/api/settings", {"fft_size": 2048})
    assert r["kind"] == "structural" and shell.app.stream is not stream
    r = _post(shell, "/api/settings", {"fft_size": 2048})
    assert r["kind"] == "noop"
    with pytest.raises(urllib.error.HTTPError):
        _post(shell, "/api/settings", {"colormap": "rainbow"})
    assert json.loads(_get(shell, "/api/settings"))["fft_size"] == 2048


def test_hover_tooltip(shell):
    txt = _get(shell, "/api/hover?frac=0.5").decode()
    assert "Hz" in txt and "¢" in txt
    with pytest.raises(urllib.error.HTTPError):
        _get(shell, "/api/hover?frac=abc")
    assert b"Hz" in _get(shell, "/api/hover?frac=nan")
    assert b"Hz" in _get(shell, "/api/hover?frac=inf")


def test_on_top_flag_and_native_only_affordance(shell):
    _post(shell, "/api/settings", {"on_top": True})
    assert json.loads(_get(shell, "/api/state"))["on_top"] is True
    assert json.loads(_get(shell, "/api/meta"))["on_top_supported"] is False
    page = _get(shell, "/").decode()
    assert "on_top_supported" in page and "disabled" in page


def test_preset_crud_over_http(shell):
    _post(shell, "/api/settings", {"gain": 5.5})
    _post(shell, "/api/preset/save?name=Web")
    assert "Web" in json.loads(_get(shell, "/api/presets"))
    _post(shell, "/api/settings", {"gain": 1.0})
    r = _post(shell, "/api/preset/load?name=Web")
    assert r["settings"]["gain"] == 5.5
    _post(shell, "/api/preset/delete?name=Web")
    assert "Web" not in json.loads(_get(shell, "/api/presets"))
    with pytest.raises(urllib.error.HTTPError):
        _post(shell, "/api/preset/delete?name=Default")
    with pytest.raises(urllib.error.HTTPError):
        _post(shell, "/api/preset/rename?name=Web")


def test_multichannel_shell_channel_switch(tmp_path):
    s = Settings(mode="natural", multires=False, fft_size=1024,
                 raster_height=64, raster_width=128, hop=256, channels=3)
    srv = ShellServer(s, port=0, source="synthetic",
                      user_dir=tmp_path / "ud", device="cpu")
    srv.start()
    try:
        time.sleep(0.8)
        r = _post(srv, "/api/settings", {"display_channel": 2})
        assert r["kind"] == "continuous"
        with pytest.raises(urllib.error.HTTPError):
            _post(srv, "/api/settings", {"display_channel": 9})
        assert len(_get(srv, "/api/frame")) == 8 + 64 * 128 * 4
    finally:
        srv.stop()


def test_axis_ticks_follow_zoom(shell):
    ticks = json.loads(_get(shell, "/api/axis"))
    assert ticks and all(0.0 <= t["frac"] <= 1.0 for t in ticks)
    assert any("kHz" in t["label"] for t in ticks)
    fracs = {t["label"]: t["frac"] for t in ticks}
    _post(shell, "/api/settings", {"freq_scale": 3.0})
    zoomed = {t["label"]: t["frac"]
              for t in json.loads(_get(shell, "/api/axis"))}
    moved = [lb for lb in fracs if lb in zoomed
             and abs(zoomed[lb] - fracs[lb]) > 1e-3]
    assert moved or set(zoomed) != set(fracs)


def test_stream_pushes_frames(shell):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", shell.port, timeout=10)
    conn.request("GET", "/api/stream")
    r = conn.getresponse()
    try:
        frames, buf = 0, b""
        deadline = time.perf_counter() + 8.0
        while frames < 2 and time.perf_counter() < deadline:
            chunk = r.read1(65536)
            if not chunk:
                time.sleep(0.02)
                continue
            buf += chunk
            while len(buf) >= 8:
                h = int.from_bytes(buf[:4], "big")
                w = int.from_bytes(buf[4:8], "big")
                need = 8 + h * w * 4
                if len(buf) < need:
                    break
                assert (h, w) == (128, 256)
                buf = buf[need:]
                frames += 1
        assert frames >= 2
    finally:
        conn.close()


def test_m4l_minimize_restore_pauses_shell(shell, tmp_path):
    state_file = tmp_path / "userdir" / "live_state.json"
    assert state_file.exists()                    # created on launch

    def wait_paused(want):
        deadline = time.perf_counter() + 3.0
        while time.perf_counter() < deadline:
            if json.loads(_get(shell, "/api/state"))["paused"] is want:
                return True
            time.sleep(0.05)
        return False
    state_file.write_text(json.dumps({"state": "minimized"}))
    assert wait_paused(True)
    state_file.write_text(json.dumps({"state": "restored"}))
    assert wait_paused(False)


def test_shell_prewarms_fft_dropdown(tmp_path):
    from emspec_torch.pipeline import _cached_pipeline

    srv = ShellServer(Settings(**KW), port=0, source="synthetic",
                      user_dir=tmp_path / "userdir", prewarm_sizes=(512,),
                      device="cpu")
    srv.start()
    try:
        assert srv.app._warm_future is not None
        srv.app._warm_future.result(timeout=180)
        before = _cached_pipeline.cache_info().hits
        assert srv.app.set(fft_size=512) == "structural"
        assert _cached_pipeline.cache_info().hits > before
    finally:
        srv.stop()
    assert srv.app._warm_future is None            # stop() cancels warming


def test_settings_churn_under_live_drain(shell):
    import random

    rng = random.Random(0)
    for _ in range(30):
        kind = rng.randrange(4)
        if kind == 0:
            payload = {"gain": rng.uniform(0.5, 9.0)}
        elif kind == 1:
            payload = {"fft_size": rng.choice([512, 1024, 2048])}
        elif kind == 2:
            payload = {"mode": rng.choice(["natural", "enhanced"])}
        else:
            payload = {"smoothing": rng.uniform(0.0, 0.9),
                       "colormap": rng.choice(["inferno", "viridis"])}
        r = _post(shell, "/api/settings", payload)
        assert r["kind"] in ("continuous", "structural", "noop")
        assert "paused" in json.loads(_get(shell, "/api/state"))
    assert len(_get(shell, "/api/frame")) == 128 * 256 * 4 + 8
    assert json.loads(_get(shell, "/api/settings"))["fft_size"] in (
        512, 1024, 2048)


def test_record_endpoint_returns_live_apng(shell, tmp_path):
    from emspec_torch.render.apng import read_apng

    p = tmp_path / "rec.png"
    p.write_bytes(_get(shell, "/api/record?seconds=0.6&fps=5"))
    frames, fps = read_apng(p)
    assert fps == 5 and frames.shape == (3, 128, 256, 4)
    assert not np.array_equal(frames[0], frames[-1])


def test_record_survives_structural_change_midway(shell, tmp_path):
    import threading

    from emspec_torch.render.apng import read_apng

    out = {}
    th = threading.Thread(target=lambda: out.update(
        raw=_get(shell, "/api/record?seconds=1.6&fps=5")))
    th.start()
    time.sleep(0.7)
    _post(shell, "/api/settings", {"raster_height": 64})
    th.join(timeout=15)
    assert not th.is_alive()
    p = tmp_path / "trunc.png"
    p.write_bytes(out["raw"])
    frames, fps = read_apng(p)
    assert fps == 5 and frames.shape[1:] == (128, 256, 4)
    assert 1 <= frames.shape[0] < 8


@pytest.mark.parametrize("bad", ["seconds=0", "fps=1000", "seconds=oops"])
def test_record_endpoint_rejects_bad_params(shell, bad):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(shell, f"/api/record?{bad}")
    assert ei.value.code == 400


def test_client_hangup_is_silent_and_nonfatal(shell, capsys):
    import socket

    sk = socket.create_connection(("127.0.0.1", shell.port), timeout=5)
    sk.sendall(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
    sk.close()
    time.sleep(0.3)
    assert json.loads(_get(shell, "/api/meta"))["version"]
    assert "Traceback" not in capsys.readouterr().err
    try:
        raise BrokenPipeError(32, "broken pipe")
    except BrokenPipeError:
        shell.httpd.handle_error(None, ("127.0.0.1", 1))
    assert capsys.readouterr().err == ""
    try:
        raise ValueError("handler bug")
    except ValueError:
        shell.httpd.handle_error(None, ("127.0.0.1", 1))
    assert "ValueError" in capsys.readouterr().err


def test_hostile_settings_barrage_over_http(shell):
    hostile = [{"gain": "x"}, {"gain": None}, {"smoothing": float("nan")},
               {"db_range": 1e308}, {"freq_scale": -5.0},
               {"raster_height": 0}, {"bogus_key": 1}, {"gain": [1, 2]},
               {"scroll_speed": 0}, {"sample_rate": 0}]
    for h in hostile:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(shell, "/api/settings", h)
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read())
    f1 = _get(shell, "/api/frame")
    time.sleep(0.5)
    assert _get(shell, "/api/frame") != f1          # still painting
    assert _post(shell, "/api/settings",
                 {"gain": 5.0})["kind"] == "continuous"


def test_shell_surfaces_update_notice(tmp_path, monkeypatch):
    from emspec_torch.utils.update import UPDATE_MANIFEST_ENV

    manifest = tmp_path / "manifest.json"
    manifest.write_text(json.dumps({"latest": "99.0.0", "url": "x"}))
    monkeypatch.setenv(UPDATE_MANIFEST_ENV, str(manifest))
    srv = ShellServer(Settings(**KW), port=0, source="synthetic",
                      user_dir=tmp_path / "userdir", device="cpu")
    srv.start()
    try:
        srv.update_check.wait(5.0)
        assert json.loads(_get(srv, "/api/meta"))["update"]["latest"] \
            == "99.0.0"
        assert json.loads(_get(srv, "/api/state"))["update"]["current"] \
            == "0.1.0"
        assert _post(srv, "/api/settings",
                     {"gain": 5.5})["update"]["latest"] == "99.0.0"
        assert "update available" in _get(srv, "/").decode()
    finally:
        srv.stop()


def test_wav_source_adopts_the_file_and_loops(tmp_path):
    from emspec_torch.io import synth
    from emspec_torch.io.wav import write_wav

    wav = tmp_path / "st.wav"
    write_wav(wav, np.stack([synth.tone(300.0, 0.2, 44100),
                             synth.tone(600.0, 0.2, 44100)]), 44100)
    srv = ShellServer(Settings(**KW), port=0, source="wav",
                      wav_path=str(wav), user_dir=tmp_path / "ud",
                      device="cpu")
    srv.start()
    try:
        assert srv.feeder.backend == "wav"
        s = json.loads(_get(srv, "/api/settings"))
        assert (s["sample_rate"], s["channels"]) == (44100, 2)
        time.sleep(0.6)                 # 0.2 s file looped: keeps feeding
        assert srv.app.stream.ring.total_written > 0.5 * 44100
    finally:
        srv.stop()


# ------------------------------------------------------------ against JAX
def test_host_endpoints_match_jax(tmp_path):
    """The same requests to both shells get the same host answers."""
    jsrv = JaxShellServer(JaxSettings(**KW), port=0, source="synthetic",
                          user_dir=tmp_path / "jax")
    srv = ShellServer(Settings(**KW), port=0, source="synthetic",
                      user_dir=tmp_path / "port", device="cpu")
    jsrv.start()
    srv.start()
    try:
        def both(fn, *a):
            return fn(srv, *a), fn(jsrv, *a)
        for path in ("/api/settings", "/api/axis", "/api/presets",
                     "/api/hover?frac=0.5", "/api/hover?frac=0",
                     "/api/hover?frac=1", "/api/hover?frac=0.123"):
            got, want = both(_get, path)
            assert got == want, path
        gm, jm = (json.loads(b) for b in both(_get, "/api/meta"))
        assert set(gm) == set(jm) | {"device"}
        for k in ("fft_sizes", "colormaps", "on_top_supported", "update"):
            assert gm[k] == jm[k]
        for payload in ({"gain": 7.0}, {"freq_scale": 2.5}, {"gain": 7.0},
                        {"fft_size": 2048}, {"mode": "enhanced"},
                        {"colormap": "magma", "smoothing": 0.4}):
            got, want = both(_post, "/api/settings", payload)
            assert got == want, payload
            for path in ("/api/axis", "/api/hover?frac=0.7"):
                assert _get(srv, path) == _get(jsrv, path)
        got, want = both(_post, "/api/preset/save?name=Both")
        assert got == want
        assert _get(srv, "/api/presets") == _get(jsrv, "/api/presets")
        for bad in ({"gain": "x"}, {"fft_size": 1000}):
            codes = []
            for s in (srv, jsrv):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _post(s, "/api/settings", bad)
                codes.append((ei.value.code, json.loads(ei.value.read())))
            assert codes[0] == codes[1]
        assert _frame(srv).shape == _frame(jsrv).shape
    finally:
        srv.stop()
        jsrv.stop()


# ------------------------------------------------------------ feeder
class FakeRing:
    def __init__(self):
        self.chunks = []

    def push(self, chunk):
        self.chunks.append(np.asarray(chunk))


def feeder_with(channels: int):
    ring = FakeRing()
    app = SimpleNamespace(stream=SimpleNamespace(channels=channels,
                                                 ring=ring))
    return AudioFeeder(app), ring


def test_ring_push_mono_stream_accepts_both_shapes():
    f, ring = feeder_with(1)
    f._ring_push(np.zeros(64, np.float32))
    f._ring_push(np.zeros((2, 64), np.float32))   # stereo capture → ch 0
    assert ring.chunks[0].shape == ring.chunks[1].shape == (64,)


def test_ring_push_adapts_channel_count_both_ways():
    f, ring = feeder_with(4)
    f._ring_push(np.arange(8, dtype=np.float32))
    assert ring.chunks[0].shape == (4, 8)
    np.testing.assert_array_equal(ring.chunks[0][3], np.arange(8))
    x = np.stack([np.full(8, c, np.float32) for c in range(3)])
    f._ring_push(x)
    np.testing.assert_array_equal(ring.chunks[1][3], np.zeros(8))  # wraps
    x = np.stack([np.full(8, c, np.float32) for c in range(6)])
    f._ring_push(x)
    np.testing.assert_array_equal(ring.chunks[2][3], np.full(8, 3.0))


def test_ring_push_survives_structural_stream_swap():
    f, ring = feeder_with(2)
    f._ring_push(np.zeros((2, 16), np.float32))
    assert ring.chunks[-1].shape == (2, 16)
    ring2 = FakeRing()
    f.app.stream = SimpleNamespace(channels=1, ring=ring2)
    f._ring_push(np.zeros((2, 16), np.float32))
    assert ring2.chunks[-1].shape == (16,)


def test_wav_feeder_restarts_after_stop(tmp_path):
    from emspec_torch.io.wav import write_wav

    wav = tmp_path / "loop.wav"
    write_wav(wav, np.sin(np.arange(4800) / 5.0).astype(np.float32), 48_000)
    ring = FakeRing()
    app = SimpleNamespace(
        settings=SimpleNamespace(sample_rate=48_000, channels=1,
                                 display_channel=0),
        stream=SimpleNamespace(channels=1, ring=ring))
    f = AudioFeeder(app, source="wav", wav_path=str(wav))

    def wait_chunks(n, timeout=5.0):
        t0 = time.time()
        while len(ring.chunks) < n and time.time() - t0 < timeout:
            time.sleep(0.01)
        return len(ring.chunks)

    f.start()
    assert f.backend == "wav" and wait_chunks(1) >= 1
    f.stop()
    mark = len(ring.chunks)
    time.sleep(0.1)
    assert len(ring.chunks) - mark <= 1
    f.start()
    assert wait_chunks(mark + 2) >= mark + 2
    f.stop()


# ------------------------------------------------------------ native window
class FakeWidget:
    def __init__(self, master=None, **kw):
        self.config = dict(kw)
        self.bindings = {}

    def pack(self, **kw):
        pass

    def configure(self, **kw):
        self.config.update(kw)

    def bind(self, seq, fn):
        self.bindings[seq] = fn


class FakeRoot(FakeWidget):
    def __init__(self):
        super().__init__()
        self.attrs, self.geometry_calls, self.after_queue = {}, [], []
        self.frameless = None
        self.withdrawn = self.destroyed = False

    def title(self, t):
        pass

    def overrideredirect(self, flag):
        self.frameless = flag

    def wm_attributes(self, name, value):
        self.attrs[name] = value

    def geometry(self, spec):
        self.geometry_calls.append(spec)

    def after(self, ms, fn):
        self.after_queue.append(fn)

    def withdraw(self):
        self.withdrawn = True

    def deiconify(self):
        self.withdrawn = False

    def destroy(self):
        self.destroyed = True

    def mainloop(self):
        pass


class FakePhotoImage:
    def __init__(self, data=b""):
        self.data = data


def fake_tk():
    return SimpleNamespace(Tk=FakeRoot, Label=FakeWidget,
                           PhotoImage=FakePhotoImage, TclError=RuntimeError)


def event(**kw):
    base = dict(x=0, y=0, x_root=0, y_root=0, state=0)
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.fixture()
def win(tmp_path):
    s = Settings(mode="natural", multires=False, fft_size=1024,
                 raster_height=64, raster_width=96, hop=256)
    app = EmSpecApp(s, user_dir=tmp_path / "userdir", device="cpu")
    return NativeWindow(app, tk=fake_tk())


def test_rgba_to_ppm_and_hover_row_match_jax():
    from emspec.shell import native as jax_native
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 4), np.uint8)
    assert rgba_to_ppm(img) == jax_native.rgba_to_ppm(img)
    assert rgba_to_ppm(img).startswith(b"P6 7 5 255\n")
    with pytest.raises(ValueError):
        rgba_to_ppm(img.astype(np.float32))
    for y, h, rows in ((0, 100, 64), (100, 100, 64), (50, 100, 63),
                       (0, 0, 64), (33.3, 77, 512)):
        assert hover_row(y, h, rows) == jax_native.hover_row(y, h, rows)


def test_native_window_duties(win):
    assert win.root.frameless is True
    before = win.app.settings.on_top
    win.root.bindings["t"](event())
    assert win.app.settings.on_top is (not before)
    assert win.root.attrs["-topmost"] == (1 if not before else 0)
    lbl = win.image_label
    lbl.bindings["<Button-1>"](event(x=5, y=7))
    lbl.bindings["<B1-Motion>"](event(x_root=100, y_root=50))
    assert win.root.geometry_calls[-1] == "+95+43"
    lbl.bindings["<Motion>"](event(y=0, state=1))   # Shift at window top
    assert win.status.config["text"] == win.app.hover(63)


def test_native_live_state_minimize_restore(win):
    write_state(win.app.watcher.path, "minimized")
    win.app.watcher.poll()
    assert win.root.withdrawn and win.app.stream._paused
    write_state(win.app.watcher.path, "restored")
    win.app.watcher.poll()
    assert not win.root.withdrawn and not win.app.stream._paused


def test_native_blit_and_tick(win):
    win.blit()
    assert win._photo.data.startswith(b"P6 96 64 255\n")
    rng = np.random.default_rng(0)
    win.app.stream.ring.push(
        rng.standard_normal(8192).astype(np.float32) * 0.2)
    win._photo = None
    win.root.after_queue.pop(0)()
    assert win._photo is not None                  # columns → re-blit
    assert len(win.root.after_queue) == 1          # re-armed
    win.close()
    assert win.root.destroyed
    win.root.after_queue.pop(0)()
    assert len(win.root.after_queue) == 0


def test_native_mode_keys_switch_pipeline(win):
    win.root.bindings["e"](event())
    assert win.app.settings.mode == "enhanced"
    win.root.bindings["n"](event())
    assert win.app.settings.mode == "natural"
    win.root.bindings["<space>"](event())
    assert win.app.stream._paused
    win.root.bindings["<space>"](event())
    assert not win.app.stream._paused


def test_native_missing_tkinter_falls_back(tmp_path, monkeypatch):
    import sys

    from emspec_torch.shell.native import NativeUnavailable, run_native
    monkeypatch.setitem(sys.modules, "tkinter", None)
    with pytest.raises(NativeUnavailable):
        run_native(Settings(**KW), source="synthetic",
                   user_dir=str(tmp_path / "userdir"), device="cpu")


def test_native_headless_raises_cleanly(tmp_path, monkeypatch):
    import sys
    pytest.importorskip("tkinter")
    if sys.platform != "linux":
        pytest.skip("DISPLAY-less Tk failure only deterministic on linux")
    monkeypatch.delenv("DISPLAY", raising=False)
    from emspec_torch.shell.native import NativeUnavailable, run_native
    with pytest.raises(NativeUnavailable):
        run_native(Settings(**KW), source="synthetic",
                   user_dir=str(tmp_path / "userdir"), device="cpu")
