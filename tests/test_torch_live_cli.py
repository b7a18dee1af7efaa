"""The port's live input and its CLI's live, presets, gui and doctor
commands on the CPU — ``tests/test_{capture,resample,update,cli}.py`` on
the port (``io.capture``, ``io.resample``, ``utils.update``,
``integrations.live_state``, ``python -m emspec_torch``), each held to
the JAX package where both run.

Tolerances: the resampler's output equals the JAX package's bit for bit
on the same chunks (the same numpy code); preset files, printed preset
JSON, exit codes and usage errors equal; ``live`` displays as many
columns as the JAX CLI's.
"""

import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from emspec.__main__ import main as jax_main
from emspec.config import PresetStore as JaxPresetStore
from emspec.config import Settings as JaxSettings
from emspec.io.resample import StreamingResampler as JaxResampler
from emspec_torch.__main__ import main
from emspec_torch.config import PresetStore, Settings
from emspec_torch.integrations import live_state
from emspec_torch.io import synth
from emspec_torch.io.capture import (CaptureUnavailable, SyntheticCapture,
                                     open_capture)
from emspec_torch.io.resample import StreamingResampler
from emspec_torch.io.wav import write_wav
from emspec_torch.stream import Stream
from emspec_torch.utils.update import (UPDATE_MANIFEST_ENV, UpdateChecker,
                                       check_for_update, parse_version)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _settings(**kw):
    kw.setdefault("mode", "natural")
    kw.setdefault("multires", False)
    kw.setdefault("fft_size", 1024)
    kw.setdefault("raster_height", 128)
    kw.setdefault("hop", 256)
    return Settings(**kw)


# ------------------------------------------------------------ capture
def test_synthetic_capture_feeds_stream_realtime():
    st = Stream(_settings(), "cpu")
    cap = SyntheticCapture(st.ring.push, sample_rate=48_000, block=512)
    cap.start()
    cols = []
    deadline = time.perf_counter() + 2.0
    while time.perf_counter() < deadline and len(cols) < 20:
        cols.extend(st.push(np.zeros(0, np.float32)))
        time.sleep(0.02)
    cap.stop()
    assert len(cols) >= 20
    idx = [c.index for c in cols]
    assert idx == sorted(idx)
    assert max(float(c.vis.max()) for c in cols) > 0.1


def test_capture_overrun_recovery_with_live_producer():
    st = Stream(_settings(), "cpu", ring_seconds=0.05)
    cap = SyntheticCapture(st.ring.push, sample_rate=48_000, block=512)
    cap.start()
    try:
        time.sleep(0.7)                        # reader stalls; producer laps
        cols = []
        deadline = time.perf_counter() + 1.5
        while time.perf_counter() < deadline and len(cols) < 5:
            cols.extend(st.push(np.zeros(0, np.float32)))
            time.sleep(0.02)
    finally:
        cap.stop()
    assert st.dropped_frames > 0
    assert len(cols) >= 5
    assert max(c.index for c in cols) >= st.dropped_frames


def test_open_capture_synthetic_and_missing_backend():
    sink = lambda chunk: None                   # noqa: E731
    assert isinstance(open_capture(sink, backend="synthetic"),
                      SyntheticCapture)
    try:
        import sounddevice  # noqa: F401
        has_sd = True
    except ImportError:
        has_sd = False
    if not has_sd:
        with pytest.raises(CaptureUnavailable):
            open_capture(sink, backend="sounddevice")
        assert isinstance(open_capture(sink, backend="auto"),
                          SyntheticCapture)
    with pytest.raises(ValueError):
        open_capture(sink, backend="jack")


def test_synthetic_capture_matches_jax_blocks():
    """The synthetic source delivers the JAX package's samples."""
    from emspec.io.capture import SyntheticCapture as JaxSynthetic
    got, want = [], []
    for cls, out in ((SyntheticCapture, got), (JaxSynthetic, want)):
        cap = cls(out.append, sample_rate=48_000, channels=3, block=256)
        cap.start()
        deadline = time.perf_counter() + 5.0
        while len(out) < 6 and time.perf_counter() < deadline:
            time.sleep(0.01)
        cap.stop()
    for g, w in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(g, w)


def _fake_sounddevice(devices):
    fake = types.ModuleType("sounddevice")
    fake.query_devices = lambda: devices
    return fake


def test_loopback_device_preferred(monkeypatch):
    from emspec_torch.io.capture import (SoundDeviceCapture,
                                         find_loopback_device)
    devices = [
        {"name": "Built-in Microphone", "max_input_channels": 2},
        {"name": "Speakers", "max_input_channels": 0},
        {"name": "Monitor of Built-in Audio Analog Stereo",
         "max_input_channels": 2},
    ]
    fake = _fake_sounddevice(devices)
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    assert find_loopback_device(fake) == (
        2, "Monitor of Built-in Audio Analog Stereo")
    cap = SoundDeviceCapture(lambda c: None)
    assert cap.is_loopback and cap.device == 2
    cap2 = SoundDeviceCapture(lambda c: None, device=0)
    assert cap2.device == 0 and not cap2.is_loopback
    fake.query_devices = lambda: [
        {"name": "Speakers (Realtek) [Loopback]", "max_input_channels": 2}]
    assert find_loopback_device(fake)[0] == 0
    fake.query_devices = lambda: devices[:2]
    cap3 = SoundDeviceCapture(lambda c: None)
    assert cap3.device is None and not cap3.is_loopback
    assert find_loopback_device(fake, channels=3) is None

    def boom():
        raise RuntimeError("no backend")
    fake.query_devices = boom
    assert find_loopback_device(fake) is None


def test_loopback_start_failure_falls_back_to_default_input(monkeypatch):
    fake = types.ModuleType("sounddevice")
    fake.query_devices = lambda *a, **kw: (
        [{"name": "Monitor of Built-in Audio", "max_input_channels": 2,
          "default_samplerate": 48_000.0}] if not a and not kw else
        {"name": "x", "max_input_channels": 2,
         "default_samplerate": 48_000.0})
    fake.check_input_settings = lambda **kw: None
    opened = []

    class FakeStream:
        def __init__(self, samplerate=None, channels=None, blocksize=None,
                     dtype=None, device=None, callback=None):
            self.device = device

        def start(self):
            opened.append(self.device)
            if self.device is not None:      # the monitor source is broken
                raise RuntimeError("device refuses the requested settings")

        def close(self):
            pass

    fake.InputStream = FakeStream
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    from emspec_torch.io.capture import SoundDeviceCapture

    cap = SoundDeviceCapture(lambda c: None, channels=1)
    assert cap.is_loopback and cap.device == 0
    cap.start()
    assert opened == [0, None] and cap.device is None and not cap.is_loopback
    opened.clear()
    cap2 = SoundDeviceCapture(lambda c: None, channels=1, device=0)
    with pytest.raises(RuntimeError):
        cap2.start()


def test_capture_resamples_mismatched_device_rate(monkeypatch):
    """A device that cannot run the pipeline rate opens at its native
    rate, and the sink gets the port resampler's pipeline-rate audio —
    the JAX package's samples."""
    fake = types.ModuleType("sounddevice")

    def check_input_settings(device=None, samplerate=None, channels=None):
        if samplerate != 44_100:
            raise RuntimeError(f"rate {samplerate} unsupported")

    fake.check_input_settings = check_input_settings
    fake.query_devices = lambda device=None, kind=None: (
        {"name": "Fake Mic", "max_input_channels": 2,
         "default_samplerate": 44_100.0})

    class FakeStream:
        def __init__(self, callback=None, **kw):
            self.callback = callback
            self.kw = kw

        def start(self):
            pass

        def stop(self):
            pass

        def close(self):
            pass

    fake.InputStream = FakeStream
    monkeypatch.setitem(sys.modules, "sounddevice", fake)
    from emspec.io.capture import SoundDeviceCapture as JaxCapture
    from emspec_torch.io.capture import SoundDeviceCapture

    x = np.sin(2 * np.pi * 997.0 * np.arange(22050) / 44_100).astype(
        np.float32)
    outs, resamplers = [], []
    for cls in (SoundDeviceCapture, JaxCapture):
        got = []
        cap = cls(got.append, sample_rate=48_000, channels=1,
                  prefer_loopback=False)
        cap.start()
        assert cap.device_rate == 44_100 and cap._stream.kw[
            "samplerate"] == 44_100
        for i in range(0, x.shape[0] - 441, 441):
            cap._stream.callback(x[i:i + 441, None], 441, None, None)
        cap.stop()
        outs.append(np.concatenate([c[0] for c in got]))
        resamplers.append(type(cap._resampler).__module__)
    assert resamplers == ["emspec_torch.io.resample", "emspec.io.resample"]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert abs(outs[0].shape[0] - x.shape[0] * 48_000 / 44_100) < 2000


# ------------------------------------------------------------ resample
def _run_chunked(rs, x, sizes):
    outs, pos, i = [], 0, 0
    while pos < x.shape[-1]:
        k = sizes[i % len(sizes)]
        i += 1
        outs.append(rs.process(x[..., pos:pos + k]))
        pos += k
    outs.append(rs.flush())
    return np.concatenate([o for o in outs if o.shape[-1]], axis=-1)


@pytest.mark.parametrize("in_rate,out_rate", [(44_100, 48_000),
                                              (48_000, 44_100),
                                              (48_000, 96_000),
                                              (96_000, 48_000),
                                              (48_000, 48_000)])
@pytest.mark.parametrize("chunks", [[441], [1, 1000, 37]])
def test_resampler_matches_jax(in_rate, out_rate, chunks):
    rng = np.random.default_rng(in_rate + out_rate + len(chunks))
    x = rng.standard_normal((2, in_rate // 8)).astype(np.float32)
    got = _run_chunked(StreamingResampler(in_rate, out_rate), x, chunks)
    want = _run_chunked(JaxResampler(in_rate, out_rate), x, chunks)
    np.testing.assert_array_equal(got, want)
    rs = StreamingResampler(in_rate, out_rate)
    assert (rs.taps, rs.delay_seconds, rs.identity) == (
        JaxResampler(in_rate, out_rate).taps,
        JaxResampler(in_rate, out_rate).delay_seconds,
        in_rate == out_rate)


def test_resampler_tone_fidelity_and_contracts():
    rs = StreamingResampler(44_100, 48_000)
    f = 997.0
    x = np.sin(2 * np.pi * f * np.arange(11025) / 44_100).astype(np.float32)
    out = _run_chunked(rs, x, [441])
    n = np.arange(out.shape[-1])
    expected = np.sin(2 * np.pi * f * (n / 48_000 - rs.delay_seconds))
    s = slice(4 * rs.taps, out.shape[-1] - 4 * rs.taps)
    err = out[s] - expected[s]
    assert 10 * np.log10(np.sum(expected[s] ** 2) / np.sum(err ** 2)) > 60.0
    rs = StreamingResampler(44_100, 48_000)
    rs.process(np.zeros((2, 100), np.float32))
    with pytest.raises(ValueError):
        rs.process(np.zeros((3, 100), np.float32))
    r = StreamingResampler(48_000, 48_000)
    out = r.process([0.0, 1.0, 2.0])
    assert out.dtype == np.float32 and out.shape == (3,)


# ------------------------------------------------------------ update
def _manifest(tmp_path, latest, url="https://example.invalid/dl"):
    p = tmp_path / "manifest.json"
    p.write_text(json.dumps({"latest": latest, "url": url}))
    return str(p)


def test_update_check_matches_jax(tmp_path, monkeypatch):
    from emspec.utils import update as jax_update
    for v in ("1.2.3", "v0.4.3", "2.0.0-rc1", "1.10"):
        assert parse_version(v) == jax_update.parse_version(v)
    with pytest.raises(ValueError):
        parse_version("not-a-version")
    for latest, cur in (("99.0.0", "0.2.0"), ("0.2.0", "0.2.0"),
                        ("0.1.9", "0.2.0"), ("tomorrow", "0.1.0")):
        m = _manifest(tmp_path, latest)
        assert check_for_update(m, current=cur) == \
            jax_update.check_for_update(m, current=cur)
    assert check_for_update(str(tmp_path / "nope.json")) is None
    assert check_for_update("http://127.0.0.1:9/manifest.json",
                            timeout=0.2) is None
    monkeypatch.setenv(UPDATE_MANIFEST_ENV, _manifest(tmp_path, "99.0.0"))
    assert UPDATE_MANIFEST_ENV == jax_update.UPDATE_MANIFEST_ENV
    notice = check_for_update()           # current: the port's version
    assert notice == {"latest": "99.0.0", "current": "0.1.0",
                      "url": "https://example.invalid/dl"}
    assert UpdateChecker().wait(5.0)["latest"] == "99.0.0"
    monkeypatch.delenv(UPDATE_MANIFEST_ENV)
    assert UpdateChecker(None, current="0.1.0").wait(5.0) is None


# ------------------------------------------------------------ live_state
def test_live_state_file_contract(tmp_path):
    p = tmp_path / "ls" / "live_state.json"
    w = live_state.LiveStateWatcher(p)
    assert p.exists() and w.state == "restored"
    live_state.write_state(p, "minimized")
    assert w.poll() == "minimized"
    p.write_text("{junk")
    assert live_state.read_state(p) == "restored"
    with pytest.raises(ValueError):
        live_state.write_state(p, "maximized")


# ------------------------------------------------------------ presets
def test_presets_file_is_interchangeable(tmp_path):
    """A store written by either package loads in the other, preset for
    preset, and both write the same bytes."""
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    s = dict(gain=7.25, colormap="viridis", fft_size=8192, multires=False,
             smoothing=0.3, multires_sizes=(4096, 1024))
    port, jax_ = PresetStore(a), JaxPresetStore(b)
    port.add("Bass", Settings(**s))
    jax_.add("Bass", JaxSettings(**s))
    assert a.read_bytes() == b.read_bytes()
    assert PresetStore(b).get("Bass") == Settings(**s)
    assert JaxPresetStore(a).get("Bass") == JaxSettings(**s)
    assert PresetStore(b).names() == JaxPresetStore(a).names() == [
        "Bass", "Default"]
    with pytest.raises(ValueError):
        PresetStore(a).delete("Default")
    a.write_text("{not json")
    assert PresetStore(a).names() == ["Default"]


def test_presets_cli_matches_jax(tmp_path, capsys):
    """The same CRUD sequence through both CLIs: same outputs, exit codes
    and files; then each CLI reads the other's file."""
    res = {}
    for name, fn in (("jax", jax_main), ("port", main)):
        store = str(tmp_path / f"{name}.json")
        out = []
        for args in (["add", "--name", "Bass", "--gain", "7.5",
                      "--low-end-boost", "6"],
                     ["list"], ["show", "--name", "Bass"],
                     ["edit", "--name", "Bass", "--gain", "2"],
                     ["show", "--name", "Bass"],
                     ["add", "--name", "Bass"], ["edit", "--name", "Nope"],
                     ["show", "--name", "Nope"],
                     ["delete", "--name", "Default"],
                     ["add", "--name", "Keep", "--mode", "natural"],
                     ["delete", "--name", "Bass"], ["list"]):
            rc = fn(["presets", *args, "--file", store])
            cap = capsys.readouterr()
            out.append((rc, cap.out.replace(store, "FILE"),
                        cap.err.replace(store, "FILE")))
        res[name] = out
    assert res["port"] == res["jax"]
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert main(["presets", "show", "--name", "Keep", "--file",
                 str(tmp_path / "jax.json")]) == 0
    port_show = capsys.readouterr().out
    assert jax_main(["presets", "show", "--name", "Keep", "--file",
                     str(tmp_path / "port.json")]) == 0
    assert capsys.readouterr().out == port_show
    assert json.loads(port_show)["mode"] == "natural"


# ------------------------------------------------------------ CLI
def test_bare_invocation_dispatches_to_gui(monkeypatch):
    import emspec_torch.__main__ as m
    seen = {}
    monkeypatch.setattr(m, "cmd_gui", lambda args: seen.update(
        backend=args.backend, input=args.input, device=args.device,
        native=args.native, no_prewarm=args.no_prewarm) or 0)
    assert m.main([]) == 0
    assert seen == {"backend": "auto", "input": None, "device": "cuda",
                    "native": False, "no_prewarm": False}


def test_live_capture_synthetic_exits_0(capsys):
    rc = main(["live", "--capture", "--backend", "synthetic", "--duration",
               "1", "--no-multires", "--fft-size", "1024", "--width", "64",
               *CPU])
    out = capsys.readouterr().out
    assert rc == 0
    assert "columns (synthetic capture, device cpu)" in out
    n = int(out.rsplit("displayed ", 1)[1].split()[0])
    assert n > 10


def test_live_file_matches_jax(tmp_path, capsys):
    wav = tmp_path / "t.wav"
    write_wav(wav, synth.chirp(300.0, 6000.0, 0.4), 48_000)
    args = ["live", str(wav), "--fast", "--fft-size", "1024", "--width",
            "64"]
    assert jax_main(args) == 0
    want = capsys.readouterr().out.rsplit("displayed", 1)[1]
    assert main(args + CPU) == 0
    got = capsys.readouterr().out.rsplit("displayed", 1)[1]
    assert got == want and int(got.split()[0]) > 0
    assert main(["live", *CPU]) == 1            # neither a file nor --capture
    assert "--capture" in capsys.readouterr().err


def test_new_commands_refuse_without_a_card(tmp_path, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    wav = tmp_path / "t.wav"
    write_wav(wav, synth.tone(440.0, 0.3), 48_000)
    for args in (["gui", "--duration", "1"], ["gui", str(wav)],
                 ["live", str(wav), "--fast"],
                 ["live", "--capture", "--duration", "1"]):
        rc = main(args)
        err = capsys.readouterr().err
        assert rc == 2 and err.count("\n") == 1 and "no CUDA device" in err
        assert "Traceback" not in err


def test_gui_serves_and_stops(tmp_path, capsys):
    rc = main(["gui", "--duration", "1.5", "--port", "0", "--no-prewarm",
               "--backend", "synthetic", "--user-dir", str(tmp_path / "ud"),
               "--no-multires", "--fft-size", "1024", "--mode", "natural",
               *CPU])
    out = capsys.readouterr().out
    assert rc == 0
    assert "emspec_torch shell: http://127.0.0.1:" in out
    assert "source=synthetic, device=cpu" in out
    cols = int(out.split("shell stopped: ")[1].split()[0])
    assert cols > 0 and "0 dropped frames" in out
    assert (tmp_path / "ud" / "live_state.json").exists()


def test_gui_native_falls_back_to_the_web_shell(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setitem(sys.modules, "tkinter", None)   # no python3-tk
    rc = main(["gui", "--native", "--duration", "0.5", "--port", "0",
               "--no-prewarm", "--backend", "synthetic", "--user-dir",
               str(tmp_path / "ud"), "--no-multires", "--fft-size", "1024",
               *CPU])
    cap = capsys.readouterr()
    assert rc == 0 and "falling back to the web shell" in cap.err
    assert "emspec_torch shell:" in cap.out


def test_doctor_on_the_cpu(capsys):
    """``doctor --device cpu`` reports the port's rows and passes where
    nothing is broken; ``--kernels`` on the CPU fails cleanly: the
    kernels run only on a card."""
    rc = main(["doctor", *CPU])
    out = capsys.readouterr().out
    for name in ("emspec_torch", "torch", "cuda device", "kernel library",
                 "nvcc", "audio capture", "native window", "update check"):
        assert f" {name} " in out or out.startswith(f"ok    {name}"), name
    assert rc == 0 and "doctor: all checks passed" in out
    rc = main(["doctor", "--kernels", *CPU])
    out, err = capsys.readouterr()
    assert rc == 1 and "Traceback" not in out + err
    assert "FAIL  cuda kernels" in out and "doctor: 1 FAILURE(S)" in out


def test_doctor_without_a_card_fails(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = main(["doctor"])
    out = capsys.readouterr().out
    assert rc == 1 and "FAIL  cuda device" in out
    assert "FAILURE(S)" in out


def test_validate_kernels_refuses_the_cpu():
    from emspec_torch.dsp.kernels.validate import validate_kernels
    with pytest.raises(ValueError, match="card"):
        validate_kernels(quick=True, device="cpu")


def test_module_entry_point_live_and_presets(tmp_path):
    """``python -m emspec_torch`` as a user runs it: presets and a CPU
    live capture in their own processes."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))

    def run(*args):
        return subprocess.run([sys.executable, "-m", "emspec_torch", *args],
                              capture_output=True, text=True, env=env,
                              cwd=tmp_path, timeout=300)

    r = run("presets", "add", "--name", "Warm", "--gain", "6")
    assert r.returncode == 0 and "add: Warm -> presets.json" in r.stdout
    r = run("presets", "show", "--name", "Warm")
    assert r.returncode == 0 and json.loads(r.stdout)["gain"] == 6.0
    r = run("live", "--capture", "--backend", "synthetic", "--duration",
            "1", "--no-multires", "--fft-size", "1024", "--width", "32",
            "--device", "cpu")
    assert r.returncode == 0 and "synthetic capture" in r.stdout
