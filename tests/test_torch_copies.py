"""The port keeps its own copies of the host-only code it needs from the
JAX package (``emspec_torch.config`` with ``PresetStore``,
``dsp.windows``, ``io.ring``, ``post._cmap_data``, ``dsp.multires``'s
tables, ``utils.notes``, ``render.png``, ``render.apng``, ``io.wav``,
``io.synth``, ``io.resample``, ``io.capture``, ``utils.update``,
``integrations.live_state``, ``shell.page``): each is held here to its
original, and the port is held to importing nothing of the JAX package —
not JAX, not ``emspec`` nor any ``emspec.*`` module."""

import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec import config as jax_config
from emspec.dsp import multires as jax_multires
from emspec.dsp import windows as jax_windows
from emspec.io.ring import RingBuffer as JaxRing
from emspec.post import _cmap_data as jax_cmap
from emspec_torch import config
from emspec_torch.dsp import multires, windows
from emspec_torch.io.ring import RingBuffer
from emspec_torch.post import _cmap_data

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ config
def test_settings_fields_and_defaults_equal():
    want = {f.name: f.default for f in dataclasses.fields(jax_config.Settings)}
    got = {f.name: f.default for f in dataclasses.fields(config.Settings)}
    assert got == want
    assert config.Settings().to_dict() == jax_config.Settings().to_dict()


def test_constants_and_structural_fields_equal():
    assert config.STRUCTURAL_FIELDS == jax_config.STRUCTURAL_FIELDS
    assert config.FFT_SIZES == jax_config.FFT_SIZES
    assert config.COLORMAPS == jax_config.COLORMAPS
    assert (config.MODE_ENHANCED, config.MODE_NATURAL) == (
        jax_config.MODE_ENHANCED, jax_config.MODE_NATURAL)


HOSTILE = [
    {"gain": "x"}, {"gain": None}, {"gain": float("nan")},
    {"db_range": float("inf")}, {"db_range": 1e308}, {"db_range": 0},
    {"freq_scale": 0.0}, {"freq_scale": 1e300}, {"raster_height": 3.5},
    {"raster_width": 0}, {"hop": -1}, {"sample_rate": 0},
    {"freq_min": 0.0}, {"crossover_low": -1.0}, {"fft_size": 1000},
    {"mode": "fancy"}, {"colormap": "jet"}, {"channels": 0},
    {"display_channel": 3}, {"smoothing": 1.0}, {"scatter": "x"},
    {"scatter_passes": 4}, {"fft_method": "fast"}, {"fft_impl": "cufft"},
    {"multires_sizes": (8192, 1000)}, {"gain": np.float32("nan")},
]


@pytest.mark.parametrize("kw", HOSTILE, ids=lambda kw: "-".join(map(str, kw)))
def test_hostile_values_raise_the_same_error(kw):
    with pytest.raises(ValueError) as want:
        jax_config.Settings().replace(**kw)
    with pytest.raises(ValueError) as got:
        config.Settings().replace(**kw)
    assert str(got.value) == str(want.value)


def test_derived_quantities_and_structural_change_equal():
    for kw in [{}, {"multires": False, "fft_size": 8192}, {"hop": 300},
               {"multires_sizes": (4096, 1024)}]:
        a, b = config.Settings(**kw), jax_config.Settings(**kw)
        assert (a.active_fft_sizes, a.hop_samples, a.freq_max) == (
            b.active_fft_sizes, b.hop_samples, b.freq_max)
        assert config.Settings.from_dict(b.to_dict()) == a
    base_t, base_j = config.Settings(), jax_config.Settings()
    for kw in [{"gain": 7.0}, {"fft_size": 8192}, {"mode": "natural"},
               {"freq_scale": 2.0}, {"crossover_low": 150.0}]:
        assert config.is_structural_change(base_t, base_t.replace(**kw)) \
            == jax_config.is_structural_change(base_j, base_j.replace(**kw))


# ------------------------------------------------------------ windows
@pytest.mark.parametrize("n", [256, 512, 2048, 8192, 32768])
def test_windows_bit_equal(n):
    for name in ("hann", "time_weighted_hann", "hann_derivative",
                 "window_triple"):
        got = getattr(windows, name)(n)
        want = getattr(jax_windows, name)(n)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ ring
@pytest.mark.parametrize("channels,capacity,seed", [(1, 1000, 0), (2, 777, 1),
                                                    (3, 64, 2)])
def test_ring_matches_original_on_random_pushes(channels, capacity, seed):
    """The same random push sequence into both rings gives the same
    ``window_at`` reads and the same overrun/future errors."""
    rng = np.random.default_rng(seed)
    a, b = RingBuffer(capacity, channels), JaxRing(capacity, channels)
    for _ in range(200):
        k = int(rng.integers(0, 2 * capacity if rng.uniform() < 0.1 else 300))
        x = rng.standard_normal((channels, k)).astype(np.float32)
        a.push(x[0] if channels == 1 and rng.uniform() < 0.5 else x)
        b.push(x)
        assert a.total_written == b.total_written
        for _ in range(3):
            start = int(rng.integers(-50, a.total_written + 50))
            n = int(rng.integers(1, capacity + 20))
            try:
                want = b.window_at(start, n)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    a.window_at(start, n)
                continue
            np.testing.assert_array_equal(a.window_at(start, n), want)
        np.testing.assert_array_equal(a.latest(min(50, capacity)),
                                      b.latest(min(50, capacity)))


# ------------------------------------------------------------ colormaps
def test_cmap_data_equal():
    assert _cmap_data._B64 == jax_cmap._B64
    for name in jax_cmap._B64:
        np.testing.assert_array_equal(_cmap_data.rgb_table(name),
                                      jax_cmap.rgb_table(name))


# ------------------------------------------------------------ multires
@pytest.mark.parametrize("sizes,rows,zoom", [((8192, 2048, 512), 512, 1.0),
                                             ((4096,), 128, 2.5),
                                             ((2048, 512), 64, 0.02)])
def test_merge_tables_bit_equal(sizes, rows, zoom):
    got = multires.build_merge_tables(sizes, 48000, rows, 20.0, zoom,
                                      200.0, 2000.0)
    want = jax_multires.build_merge_tables(sizes, 48000, rows, 20.0, zoom,
                                           200.0, 2000.0)
    np.testing.assert_array_equal(got.row_freqs, want.row_freqs)
    for field in ("i0", "w0", "band_w"):
        for g, w in zip(getattr(got, field), getattr(want, field)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for bank in range(len(sizes)):
        assert multires.band_support_hz(bank, len(sizes), 200.0, 2000.0,
                                        24000.0) == \
            jax_multires.band_support_hz(bank, len(sizes), 200.0, 2000.0,
                                         24000.0)


def test_merge_columns_matches_jax():
    """Gather + lerp + band weight + 1/N² per bank, bit-equal on the CPU
    (the same float32 operations in the same order)."""
    sizes = (8192, 2048, 512)
    t = multires.build_merge_tables(sizes, 48000, 256, 20.0, 1.0, 200.0,
                                    2000.0)
    rng = np.random.default_rng(5)
    specs = [rng.uniform(0, 10, (3, n // 2 + 1)).astype(np.float32)
             for n in sizes]
    want = np.asarray(jax_multires.merge_columns(
        tuple(jnp.asarray(s) for s in specs), t))
    tt = multires.MergeTables(t.row_freqs,
                              *(tuple(torch.from_numpy(v) for v in f)
                                for f in (t.i0, t.w0, t.band_w)))
    got = multires.merge_columns([torch.from_numpy(s) for s in specs], tt)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ verbatim copies
# (copy, original, functions whose body differs): the copies' source is
# the original's with ``emspec.`` imports read as ``emspec_torch.``;
# ``io.wav.read_wav`` drops the native decoder the port does not have;
# ``utils.update.check_for_update`` reads ``emspec_torch.__version__``.
VERBATIM = [("emspec_torch/utils/notes.py", "emspec/utils/notes.py", ()),
            ("emspec_torch/render/png.py", "emspec/render/png.py", ()),
            ("emspec_torch/render/apng.py", "emspec/render/apng.py", ()),
            ("emspec_torch/io/synth.py", "emspec/io/synth.py", ()),
            ("emspec_torch/io/wav.py", "emspec/io/wav.py", ("read_wav",)),
            ("emspec_torch/io/resample.py", "emspec/io/resample.py", ()),
            ("emspec_torch/io/capture.py", "emspec/io/capture.py", ()),
            ("emspec_torch/integrations/live_state.py",
             "emspec/integrations/live_state.py", ()),
            ("emspec_torch/shell/page.py", "emspec/shell/page.py", ()),
            ("emspec_torch/utils/update.py", "emspec/utils/update.py",
             ("check_for_update",))]


@pytest.mark.parametrize("copy,orig,differs", VERBATIM,
                         ids=[v[0] for v in VERBATIM])
def test_verbatim_copy_source(copy, orig, differs):
    want = (ROOT / orig).read_text().replace("from emspec.",
                                             "from emspec_torch.")
    got = (ROOT / copy).read_text()
    if not differs:
        assert got == want
        return

    def kept(text):
        return [ast.get_source_segment(text, n) for n in ast.parse(text).body
                if not (isinstance(n, ast.FunctionDef) and n.name in differs)]
    assert kept(got) == kept(want)


def test_update_copy_differs_only_in_its_version():
    """``check_for_update`` is the original's body with the port's
    version read where the original reads ``emspec.__version__``."""
    import inspect

    from emspec.utils import update as jax_update
    from emspec_torch.utils import update
    got = inspect.getsource(update.check_for_update)
    want = inspect.getsource(jax_update.check_for_update)
    assert got == want.replace("from emspec import __version__",
                               "from emspec_torch import __version__")


def test_preset_store_copy_source_and_files():
    """``PresetStore`` is the original's class, and the presets-section
    comment above it, verbatim; a file either writes loads in the
    other."""
    def segment(path):
        text = (ROOT / path).read_text()
        node = next(n for n in ast.parse(text).body
                    if isinstance(n, ast.ClassDef) and n.name == "PresetStore")
        return ast.get_source_segment(text, node)
    assert segment("emspec_torch/config.py") == segment("emspec/config.py")


def test_preset_files_load_both_ways(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    s = dict(gain=1.5, mode="natural", fft_size=2048, multires=False,
             hop=300, crossover_low=150.0)
    config.PresetStore(a).add("X", config.Settings(**s))
    jax_config.PresetStore(b).add("X", jax_config.Settings(**s))
    assert a.read_text() == b.read_text()
    assert jax_config.PresetStore(a).get("X").to_dict() == \
        config.PresetStore(b).get("X").to_dict()


def test_wav_copy_reads_and_writes_as_the_original(tmp_path):
    from emspec.io import wav as jax_wav
    from emspec_torch.io import wav
    rng = np.random.default_rng(0)
    for shape in ((1000,), (2, 777), (3, 50)):
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        a, b = tmp_path / "a.wav", tmp_path / "b.wav"
        wav.write_wav(a, x, 44100)
        jax_wav.write_wav(b, x, 44100)
        assert a.read_bytes() == b.read_bytes()
        got, want = wav.read_wav(a), jax_wav.read_wav(a)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    with pytest.raises(ValueError) as w:
        jax_wav._read_wav_py(bad)
    with pytest.raises(ValueError) as g:
        wav.read_wav(bad)
    assert str(g.value) == str(w.value)


def test_synth_notes_png_apng_outputs_equal(tmp_path):
    from emspec.io import synth as jax_synth
    from emspec.render import apng as jax_apng
    from emspec.render import png as jax_png
    from emspec.utils import notes as jax_notes
    from emspec_torch.io import synth
    from emspec_torch.render import apng, png
    from emspec_torch.utils import notes
    for name, args in (("tone", (440.0, 0.1)), ("chirp", (100, 9000, 0.1)),
                       ("impulse", (7, 64)), ("noise", (0.1,)),
                       ("silence", (0.01,)),
                       ("multitone", ([220, 330], 0.1))):
        np.testing.assert_array_equal(getattr(synth, name)(*args),
                                      getattr(jax_synth, name)(*args))
    for f in (27.5, 440.0, 443.0, 1000.0, 12345.6):
        assert notes.describe_frequency(f) == jax_notes.describe_frequency(f)
        assert notes.frequency_to_note(f) == jax_notes.frequency_to_note(f)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
            for _ in range(3)]
    np.testing.assert_array_equal(png.tile_images(imgs),
                                  jax_png.tile_images(imgs))
    png.write_png(tmp_path / "a.png", imgs[0])
    jax_png.write_png(tmp_path / "b.png", imgs[0])
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(png.read_png(tmp_path / "a.png"), imgs[0])
    assert apng.apng_bytes(imgs, fps=12.5) == jax_apng.apng_bytes(imgs,
                                                                  fps=12.5)
    apng.write_apng(tmp_path / "a.apng", iter(imgs), fps=12.5)
    frames, fps = apng.read_apng(tmp_path / "a.apng")
    want, wfps = jax_apng.read_apng(tmp_path / "a.apng")
    np.testing.assert_array_equal(frames, want)
    assert fps == wfps


# ------------------------------------------------------------ imports
def _port_files():
    """The port, and what runs on the card machine (which has no JAX)."""
    return sorted((ROOT / "emspec_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]


def _imported(path: Path) -> set:
    nodes = list(ast.walk(ast.parse(path.read_text())))
    names = {a.name for n in nodes if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in nodes
              if isinstance(n, ast.ImportFrom) and n.module and not n.level}
    return names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_the_jax_package(path):
    bad = {m for m in _imported(path)
           if m.split(".")[0] in ("emspec", "jax", "jaxlib")}
    assert not bad, bad


def test_importing_every_port_module_loads_no_emspec_or_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (ROOT / "emspec_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'emspec' "
        "or m.startswith('emspec.') or m.startswith('jax')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 25
