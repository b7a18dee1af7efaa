"""The port's CLI (``python -m emspec_torch``) against the JAX package's
(``python -m emspec``), on the CPU (``--device cpu``): the render, export,
stream, animate and note commands and the one-line usage errors of
``tests/test_cli.py``, each output held to the JAX CLI's on the same WAV.

Tolerances: printed summaries, exit codes, error lines and export axes
equal; images (PNG) differ from the JAX CLI's on at most 1e-3 of the
pixels and exported ``vis`` by ``validate.compare_vis`` with 2/255 on all
but 1e-3 of the 3×3 max-filtered cells — float32 FFT rounding between
the two packages can move a reassigned deposit or tip a value over a
colormap edge, and at this export's size (1025 × 43 cells) one moved
deposit touches up to 9 filtered cells, 2e-4 of the grid, so 1e-3 admits
five; within the port, ``apply_lut(export)`` equals ``render`` and the
animation's last frame equals ``stream``'s snapshot, pixel for pixel.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from emspec.__main__ import main as jax_main
from emspec_torch.__main__ import main
from emspec_torch.io import synth
from emspec_torch.io.wav import write_wav
from emspec_torch.post.colormap import apply_lut
from emspec_torch.render.apng import read_apng
from emspec_torch.render.png import read_png, tile_images
from emspec_torch.tables import lut
from emspec_torch.validate import compare_vis

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
PIXEL_SHARE = 1e-3
VIS_SHARE = 1e-3


def _both(capsys, args, tmp_path, port_args=CPU):
    """Run the JAX CLI and the port's on the same arguments (outputs into
    ``jax/`` and ``port/`` under ``tmp_path``) → ((rc, out, err) JAX,
    (rc, out, err) port), the output paths written as ``OUT``."""
    res = []
    for name, fn, extra in (("jax", jax_main, []),
                            ("port", main, list(port_args))):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        argv = [a.replace("{out}", str(d)) for a in args] + extra
        rc = fn(argv)
        cap = capsys.readouterr()
        res.append((rc, cap.out.replace(str(d), "OUT"),
                    cap.err.replace(str(d), "OUT")))
    return res


def _share(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    return float((a != b).any(-1).mean())


@pytest.fixture
def chirp_wav(tmp_path):
    wav = tmp_path / "c.wav"
    write_wav(wav, synth.chirp(300.0, 9000.0, 0.5), 48_000)
    return wav


@pytest.fixture
def stereo_wav(tmp_path):
    wav = tmp_path / "st.wav"
    write_wav(wav, np.stack([synth.tone(300.0, 0.3),
                             synth.chirp(200.0, 6000.0, 0.3)]), 48_000)
    return wav


def test_user_mistakes_are_one_line_and_rc_2(tmp_path, capsys):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a riff file at all, definitely not audio")
    short = tmp_path / "short.wav"
    write_wav(short, synth.tone(440.0, 0.25), 48_000)
    tiny = tmp_path / "tiny.wav"
    write_wav(tiny, synth.tone(440.0, 0.01), 48_000)
    mono = tmp_path / "mono.wav"
    write_wav(mono, synth.tone(440.0, 0.3), 48_000)
    cases = [
        ["render", str(tmp_path / "nope.wav"), "{out}/o.png"],
        ["render", str(bad), "{out}/o.png"],
        ["render", str(short), "{out}/o.png", "--fft-size", "32768"],
        ["render", str(mono), "{out}/o.png", "--fft-size", "1024",
         "--channel", "5"],
        ["render", str(mono), "{out}/o.png", "--fft-size", "1024",
         "--channel", "left"],
        ["export", str(tiny), "{out}/o.npz", "--multires"],
        ["render", str(mono), "{out}/o.png", "--db-range", "0"],
        ["animate", str(mono), "{out}/o.png", "--fps", "-5",
         "--no-multires", "--fft-size", "1024"],
    ]
    for args in cases:
        (jrc, jout, jerr), (rc, out, err) = _both(capsys, args, tmp_path)
        assert rc == jrc == 2, args
        assert err == jerr and len(err.strip().splitlines()) == 1, (args, err)
        assert err.startswith("error:") and "Traceback" not in err


def test_note_matches_jax(tmp_path, capsys):
    for args in (["note", "440"], ["note", "443"], ["note", "27.5"],
                 ["note", "0"]):
        (jrc, jout, jerr), (rc, out, err) = _both(capsys, args, tmp_path, [])
        assert (rc, out, err) == (jrc, jout, jerr)
    assert "A4" in _both(capsys, ["note", "440"], tmp_path, [])[1][1]


@pytest.mark.parametrize("flags", [
    ["--mode", "natural", "--fft-size", "1024", "--no-multires"],
    ["--fft-size", "2048"],
    ["--fft-size", "1024", "--multires"],
], ids=["natural", "enhanced", "multires"])
def test_render_matches_jax(chirp_wav, tmp_path, capsys, flags):
    (jrc, jout, _), (rc, out, _) = _both(
        capsys, ["render", str(chirp_wav), "{out}/r.png"] + flags, tmp_path)
    assert rc == jrc == 0 and out == jout
    assert _share(read_png(tmp_path / "port" / "r.png"),
                  read_png(tmp_path / "jax" / "r.png")) <= PIXEL_SHARE


def test_render_all_channels_tiled_matches_jax(stereo_wav, tmp_path, capsys):
    flags = ["--channel", "all", "--no-multires", "--fft-size", "1024"]
    (jrc, jout, _), (rc, out, _) = _both(
        capsys, ["render", str(stereo_wav), "{out}/t.png"] + flags, tmp_path)
    assert rc == jrc == 0 and out == jout and "2 channels tiled" in out
    assert _share(read_png(tmp_path / "port" / "t.png"),
                  read_png(tmp_path / "jax" / "t.png")) <= PIXEL_SHARE


def test_export_linear_matches_jax_and_the_render(chirp_wav, tmp_path,
                                                  capsys):
    """The export's vis, axes and settings against the JAX CLI's, and
    ``apply_lut(vis)`` against the port's own render, pixel for pixel."""
    (jrc, jout, _), (rc, out, _) = _both(
        capsys, ["export", str(chirp_wav), "{out}/e.npz", "--fft-size",
                 "2048"], tmp_path)
    assert rc == jrc == 0 and out == jout
    z = np.load(tmp_path / "port" / "e.npz", allow_pickle=False)
    w = np.load(tmp_path / "jax" / "e.npz", allow_pickle=False)
    for key in ("freq_hz", "time_s", "settings_json"):
        np.testing.assert_array_equal(z[key], w[key])
    vis = z["vis"]
    assert vis.shape == (1025, len(z["time_s"])) and vis.dtype == np.float32
    ok, worst, share = compare_vis(torch.from_numpy(w["vis"].T.copy()),
                                   torch.from_numpy(vis.T.copy()),
                                   frac=VIS_SHARE)
    assert ok, (worst, share)
    assert main(["render", str(chirp_wav), str(tmp_path / "r.png"),
                 "--fft-size", "2048"] + CPU) == 0
    s = json.loads(str(z["settings_json"]))
    rgba = apply_lut(torch.from_numpy(vis.T.copy()),
                     torch.from_numpy(lut(s["colormap"]).copy())).numpy()
    np.testing.assert_array_equal(rgba.transpose(1, 0, 2)[::-1],
                                  read_png(tmp_path / "r.png"))


def test_export_multires_and_channels_match_jax(stereo_wav, tmp_path,
                                                capsys):
    for flags in (["--multires"], ["--channel", "all", "--fft-size", "1024"]):
        (jrc, jout, _), (rc, out, _) = _both(
            capsys, ["export", str(stereo_wav), "{out}/m.npz"] + flags,
            tmp_path)
        assert rc == jrc == 0 and out == jout
        z = np.load(tmp_path / "port" / "m.npz", allow_pickle=False)
        w = np.load(tmp_path / "jax" / "m.npz", allow_pickle=False)
        np.testing.assert_array_equal(z["freq_hz"], w["freq_hz"])
        np.testing.assert_array_equal(z["time_s"], w["time_s"])
        assert str(z["settings_json"]) == str(w["settings_json"])
        assert z["vis"].shape == w["vis"].shape
    # the per-channel planes reproduce the port's tiled render
    assert main(["render", str(stereo_wav), str(tmp_path / "t.png"),
                 "--channel", "all", "--fft-size", "1024"] + CPU) == 0
    table = torch.from_numpy(lut("inferno").copy())
    tiles = [apply_lut(torch.from_numpy(v.T.copy()), table).numpy()
             .transpose(1, 0, 2)[::-1] for v in z["vis"]]
    np.testing.assert_array_equal(tile_images(tiles),
                                  read_png(tmp_path / "t.png"))


@pytest.mark.parametrize("channel", ["0", "all"])
def test_stream_matches_jax(stereo_wav, tmp_path, capsys, channel):
    flags = ["--channel", channel, "--no-multires", "--fft-size", "1024",
             "--width", "64", "--mode", "natural"]
    (jrc, jout, _), (rc, out, _) = _both(
        capsys, ["stream", str(stereo_wav), "{out}/wf.png"] + flags, tmp_path)
    assert rc == jrc == 0 and out == jout
    assert _share(read_png(tmp_path / "port" / "wf.png"),
                  read_png(tmp_path / "jax" / "wf.png")) <= PIXEL_SHARE


def test_animate_last_frame_is_the_stream_png(chirp_wav, tmp_path, capsys):
    flags = ["--no-multires", "--fft-size", "1024", "--width", "64"] + CPU
    out = tmp_path / "anim.png"
    assert main(["animate", str(chirp_wav), str(out), "--fps", "20"]
                + flags) == 0
    assert "frames @ 20 fps" in capsys.readouterr().out
    frames, fps = read_apng(out)
    assert fps == 20
    assert frames.shape[0] == math.ceil(int(round(0.5 * 48_000)) * 20
                                        / 48_000)
    assert not np.array_equal(frames[0], frames[-1])
    ref = tmp_path / "wf.png"
    assert main(["stream", str(chirp_wav), str(ref)] + flags) == 0
    np.testing.assert_array_equal(frames[-1], read_png(ref))


@pytest.mark.parametrize("cmd,out", [("render", "o.png"), ("export", "o.npz"),
                                     ("stream", "o.png"),
                                     ("animate", "o.png")])
def test_without_a_card_the_command_exits_2(chirp_wav, tmp_path, capsys,
                                            monkeypatch, cmd, out):
    """No card and no ``--device cpu``: one line, exit 2, nothing written —
    the command never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main([cmd, str(chirp_wav), str(tmp_path / out), "--fft-size",
               "1024"])
    err = capsys.readouterr().err
    assert rc == 2 and len(err.strip().splitlines()) == 1
    assert "--device cpu" in err and "Traceback" not in err
    assert not (tmp_path / out).exists()


def test_module_entry_point_runs_and_refuses_without_a_card(chirp_wav,
                                                            tmp_path):
    """``python -m emspec_torch`` as a user runs it: a bare call opens the
    window shell, which without a card is the one-line error (rc 2),
    ``--help`` prints the usage, ``note`` works anywhere, and ``render``
    without a card is the one-line error."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT))

    def run(*args):
        return subprocess.run([sys.executable, "-m", "emspec_torch", *args],
                              capture_output=True, text=True, env=env,
                              cwd=tmp_path, timeout=120)

    r = run()
    assert r.returncode == 2 and r.stderr.count("\n") == 1
    assert "no CUDA device" in r.stderr and "Traceback" not in r.stderr
    r = run("--help")
    assert r.returncode == 0 and r.stdout.startswith("usage: emspec_torch")
    assert "gui" in r.stdout and "doctor" in r.stdout
    r = run("note", "440")
    assert r.returncode == 0 and "A4" in r.stdout
    r = run("render", str(chirp_wav), "o.png")
    assert r.returncode == 2 and r.stderr.count("\n") == 1
    assert "no CUDA device" in r.stderr and not (tmp_path / "o.png").exists()


def test_internal_valueerror_is_not_swallowed(monkeypatch):
    import emspec_torch.__main__ as m
    monkeypatch.setattr(
        m, "cmd_render",
        lambda args: (_ for _ in ()).throw(ValueError("internal bug")))
    with pytest.raises(ValueError, match="internal bug"):
        m.main(["render", "a.wav", "b.png"])
