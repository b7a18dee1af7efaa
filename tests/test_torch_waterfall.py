"""The port's scrolling waterfall, its animation and the hover readout
against the JAX package's, on the CPU.

Tolerances: the waterfall's pixels are uint8-equal to the JAX
waterfall's fed the same columns (both quantize the same float32 mean);
the animation's last frame equals the port's own stream snapshot pixel
for pixel (the same Stream and Waterfall), and its frames differ from the
JAX package's on at most 1e-3 of the pixels (a vis within ulps of a
colormap edge takes the neighbouring entry; natural mode, whose spectra
differ by float32 FFT rounding only); the hover readout is host math on
the same axis: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.pipeline import Pipeline as JaxPipeline
from emspec.post.colormap import apply_lut as jax_apply_lut
from emspec.render.animate import animate_frames as jax_animate_frames
from emspec.render.waterfall import Waterfall as JaxWaterfall
from emspec_torch import Settings
from emspec_torch.pipeline import Pipeline
from emspec_torch.render.animate import animate_frames, frame_count
from emspec_torch.render.waterfall import Waterfall
from emspec_torch.stream import Stream
from emspec_torch.tables import lut

ROWS, WIDTH = 8, 16


def _columns(count, seed):
    """(vis (rows,) float32, RGBA (rows, 4) uint8 = LUT(vis)) pairs."""
    rng = np.random.default_rng(seed)
    table = lut("inferno")
    vis = rng.uniform(0, 1, (count, ROWS)).astype(np.float32)
    rgba = np.array(jax_apply_lut(jnp.asarray(vis), jnp.asarray(table)))
    return vis, rgba


@pytest.mark.parametrize("with_vis", [True, False])
@pytest.mark.parametrize("speed", [0.5, 1.0, 2.0, 3.0])
def test_waterfall_uint8_equal_to_jax(speed, with_vis):
    vis, rgba = _columns(40, seed=int(speed * 10) + with_vis)
    table = lut("inferno") if with_vis else None
    want = JaxWaterfall(WIDTH, ROWS, speed, lut_table=table)
    got = Waterfall(WIDTH, ROWS, speed, lut_table=table, device="cpu")
    np.testing.assert_array_equal(got.image(), want.image())
    for i in range(len(vis)):
        v = vis[i] if with_vis else None
        want.add_column(jnp.asarray(rgba[i]),
                        None if v is None else jnp.asarray(v))
        got.add_column(torch.from_numpy(rgba[i]),
                       None if v is None else torch.from_numpy(v))
        img = got.image()
        assert img.shape == (ROWS, WIDTH, 4) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, want.image())


def test_waterfall_errors_match_jax():
    vis, rgba = _columns(3, seed=1)
    for wf in (JaxWaterfall(4, ROWS, 0.5, lut_table=lut("inferno")),
               Waterfall(4, ROWS, 0.5, lut_table=lut("inferno"),
                         device="cpu")):
        wf.add_column(rgba[0], vis[0])
        with pytest.raises(ValueError, match="mixed vis/RGBA"):
            wf.add_column(rgba[1])
        with pytest.raises(ValueError, match=r"one \(rows, 4\) column"):
            wf.add_column(np.zeros((2, ROWS, 4), np.uint8))


def test_waterfall_colormap_swap_takes_the_new_table():
    vis, rgba = _columns(4, seed=2)
    wf = Waterfall(4, ROWS, 0.5, lut_table=lut("inferno"), device="cpu")
    wf.lut_table = lut("grayscale")
    for i in range(2):
        wf.add_column(torch.from_numpy(rgba[i]), torch.from_numpy(vis[i]))
    mean = (vis[0] + vis[1]) / np.float32(2)
    gray = lut("grayscale")[np.clip(np.round(mean * 255), 0, 255).astype(int)]
    np.testing.assert_array_equal(wf.image()[::-1, -1], gray)


def _signal(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 48000)) / 48000
    return (0.5 * np.sin(2 * np.pi * (300 * t + 4000 * t * t))
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _snapshot(x, s, width, chunk=1024):
    st = Stream(s, "cpu")
    wf = Waterfall(width, s.raster_height, s.scroll_speed,
                   lut_table=lut(s.colormap), device="cpu")
    for i in range(0, x.shape[-1], chunk):
        for col in st.push(x[i:i + chunk]):
            wf.add_column(col.rgba, col.vis)
    for col in st.flush():
        wf.add_column(col.rgba, col.vis)
    return wf.image()


@pytest.mark.parametrize("speed", [1.0, 0.5])
def test_animate_last_frame_is_the_stream_snapshot(speed):
    s = Settings(multires=False, fft_size=1024, scroll_speed=speed)
    x = _signal(0.3)
    frames = list(animate_frames(x, s, fps=20, width=48, device="cpu"))
    assert len(frames) == frame_count(x.size, 48000, 20) == 6
    assert not np.array_equal(frames[0], frames[-1])
    np.testing.assert_array_equal(frames[-1], _snapshot(x, s, 48))


def test_animate_frames_match_jax():
    kw = dict(multires=False, fft_size=1024, mode="natural")
    x = _signal(0.25, seed=3)
    got = list(animate_frames(x, Settings(**kw), fps=10, width=32,
                              device="cpu"))
    want = list(jax_animate_frames(x, JaxSettings(**kw), fps=10, width=32))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g != w).any(-1).mean()) <= 1e-3


def test_animate_rejects_what_jax_rejects():
    s = Settings(fft_size=1024, multires=False)
    with pytest.raises(ValueError, match="channels"):
        next(animate_frames(np.zeros((2, 4096), np.float32), s, fps=10,
                            device="cpu"))
    with pytest.raises(ValueError, match="fps must be positive"):
        next(animate_frames(np.zeros(4096, np.float32), s, fps=0,
                            device="cpu"))


@pytest.mark.parametrize("kw", [{}, {"raster_height": 128, "freq_min": 40.0},
                                {"multires": False, "fft_size": 4096}],
                         ids=["default", "rows128", "single"])
def test_hover_readout_matches_jax(kw):
    got, want = Pipeline(Settings(**kw), "cpu"), JaxPipeline(JaxSettings(**kw))
    for zoom in (None, 1.0, 2.5):
        np.testing.assert_array_equal(got._axis(zoom), want._axis(zoom))
        for row in (0, 1, got.rows // 3, got.rows - 1):
            assert got.frequency_at_row(row, zoom) == \
                want.frequency_at_row(row, zoom)
            assert got.describe_row(row, zoom) == want.describe_row(row, zoom)
        for f in (1e-3, 20.0, 440.0, 1234.5, 23999.0, 1e6):
            assert got.row_of_frequency(f, zoom) == \
                want.row_of_frequency(f, zoom)
