"""The single-bank raster of the port (``dsp.stft``, ``dsp.reassign``,
``render.raster``, ``emspec_torch.render``) against the JAX package's, on
the CPU, from numpy-seeded audio.

Tolerances:

* spectra (``stft``, ``power_spectrogram``, ``stft_triple`` by either
  method): within 1e-5 of the peak magnitude (float32 FFT rounding:
  torch's FFT and XLA's round apart);
* ``reassigned_bins`` and ``scatter_segment_sum`` on the same inputs:
  bit-equal (the same float32 elementwise operations; each cell adds its
  deposits in deposit order in both);
* reassigned grids: ``validate.compare_grids`` — energy within 1e-4 and
  3×3 max-filters within 1e-3·peak on all but 1e-4 of the cells (a
  rounding flip moves a whole deposit one cell);
* ``vis``: ``validate.compare_vis`` — 3×3 max-filters within 2/255 on all
  but 1e-4 of the cells; images: the port's image is its own
  ``apply_lut(vis)`` pixel for pixel, and differs from the JAX image on
  at most 1e-3 of the pixels (a vis within ulps of a colormap edge takes
  the neighbouring entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import emspec_torch
from emspec.config import Settings as JaxSettings
from emspec.dsp import reassign as jreassign
from emspec.dsp import stft as jstft
from emspec.render import raster as jraster
from emspec_torch import Settings
from emspec_torch.dsp import reassign, stft
from emspec_torch.dsp.kernels import scatter
from emspec_torch.post.colormap import apply_lut
from emspec_torch.render import raster
from emspec_torch.tables import lut
from emspec_torch.validate import compare_grids, compare_vis

SR = 48000
SPEC_TOL = 1e-5
IMAGE_SHARE = 1e-3


def _audio(seconds=1.0, channels=1, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    out = [(0.5 * np.sin(2 * np.pi * ((200 + 300 * c) * t + 3000 * t * t))
            + 0.2 * np.sin(2 * np.pi * 440 * t)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
           for c in range(channels)]
    return out[0] if channels == 1 else np.stack(out)


def _close(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    peak = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= SPEC_TOL * peak


@pytest.mark.parametrize("n,hop", [(512, 128), (2048, 512)])
def test_stft_and_power_match_jax(n, hop):
    x = _audio(0.5)
    _close(jstft.stft(jnp.asarray(x), n, hop), stft.stft(torch.from_numpy(x),
                                                         n, hop))
    _close(jstft.power_spectrogram(jnp.asarray(x), n, hop),
           stft.power_spectrogram(torch.from_numpy(x), n, hop))


@pytest.mark.parametrize("method", ["stencil", "direct"])
@pytest.mark.parametrize("n,hop", [(1024, 256), (2048, 512)])
def test_stft_triple_matches_jax(n, hop, method):
    x = _audio(0.5, channels=2, seed=n)
    want = jstft.stft_triple(jnp.asarray(x), n, hop, method)
    got = stft.stft_triple(torch.from_numpy(x), n, hop, method)
    for w, g in zip(want, got):
        _close(w, g)


def _corrections(x, n, hop):
    X = jstft.stft_triple(jnp.asarray(x), n, hop)
    return [np.array(c) for c in jreassign.reassignment_corrections(*X)]


@pytest.mark.parametrize("n,hop", [(1024, 256), (2048, 512)])
def test_reassigned_bins_and_segment_sum_bit_equal_to_jax(n, hop):
    """The same corrections into both: the quantized targets, the masked
    power and the summed grid are bit-equal.  The corrections carry a
    Δt/hop tie (rounded half to even in both), a |Δt| beyond N/2 and a
    power at the floor."""
    power, dt, dw = _corrections(_audio(0.5, seed=n), n, hop)
    t = power.shape[0]
    dt[1, :4] = hop * np.array([0.5, 1.5, -0.5, 2.5], np.float32)
    dt[2, 5] = n                                   # beyond the half support
    power[3, 7] = jreassign.DEFAULT_POWER_FLOOR    # at the floor: dropped
    want = jreassign.reassigned_bins(jnp.asarray(power), jnp.asarray(dt),
                                     jnp.asarray(dw), n, hop, t)
    got = reassign.reassigned_bins(torch.from_numpy(power),
                                   torch.from_numpy(dt),
                                   torch.from_numpy(dw), n, hop, t)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    grid_w = jreassign.scatter_segment_sum(*want, t, n // 2 + 1)
    grid_g = reassign.scatter_segment_sum(*got, t, n // 2 + 1)
    np.testing.assert_array_equal(grid_g.numpy(), np.asarray(grid_w))


def test_segment_sum_with_a_channel_axis_bit_equal_to_jax():
    n, hop = 1024, 256
    x = _audio(0.5, channels=2, seed=5)
    X = jstft.stft_triple(jnp.asarray(x), n, hop)
    t = X[0].shape[-2]
    bins = jreassign.reassigned_bins(*jreassign.reassignment_corrections(*X),
                                     n, hop, t)
    want = jreassign.scatter_segment_sum(*bins, t, n // 2 + 1)
    got = reassign.scatter_segment_sum(
        *(torch.from_numpy(np.array(b)) for b in bins), t, n // 2 + 1)
    assert got.shape == (2, t, n // 2 + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n,hop", [(1024, 256), (2048, 512)])
def test_reassigned_spectrogram_matches_jax(n, hop, channels):
    x = _audio(1.0, channels=channels, seed=n + channels)
    want = jreassign.reassigned_spectrogram(jnp.asarray(x), n, hop)
    got = reassign.reassigned_spectrogram(torch.from_numpy(x), n, hop)
    g = compare_grids(torch.from_numpy(np.asarray(want)), got)
    assert g.ok, g


def test_card_formulation_matches_the_stencil_on_the_cpu():
    """The card's spectra are the direct method (B5's window triple);
    run here on the CPU, its grid holds to the stencil method's."""
    n, hop = 2048, 512
    x = torch.from_numpy(_audio(1.0, seed=3))
    grids = []
    for method in ("stencil", "direct"):
        X = stft.stft_triple(x, n, hop, method)
        t = X[0].shape[-2]
        bins = reassign.reassigned_bins(
            *reassign.reassignment_corrections(*X), n, hop, t)
        grids.append(reassign.scatter_segment_sum(*bins, t, n // 2 + 1))
    g = compare_grids(*grids)
    assert g.ok, g


def test_card_sum_is_b2_sorted_route(monkeypatch):
    """The raster's sum is kernel B2, by its deterministic route; here on
    the CPU B2's wrapper takes its plain version."""
    seen = []
    real = scatter.histogram

    def spy(ids, vals, num_bins, *args, **kw):
        seen.append((ids.dtype, kw.get("route")))
        return real(ids, vals, num_bins, *args, **kw)

    monkeypatch.setattr(reassign, "histogram", spy)
    reassign.reassigned_spectrogram(torch.from_numpy(_audio(0.3)), 1024, 256)
    assert seen == [(torch.int32, scatter.SORTED)]


@pytest.mark.parametrize("mode", ["enhanced", "natural"])
@pytest.mark.parametrize("n", [1024, 2048])
def test_render_vis_and_image_match_jax(n, mode):
    x = _audio(1.0, seed=n)
    kw = dict(multires=False, fft_size=n, mode=mode)
    s, js = Settings(**kw), JaxSettings(**kw)
    want_vis = jraster.render_vis(x, js)
    vis = raster.render_vis(x, s, "cpu")
    assert vis.shape == want_vis.shape == (n // 2 + 1, (SR - n) // (n // 4) + 1)
    ok, worst, share = compare_vis(torch.from_numpy(want_vis.T.copy()),
                                   torch.from_numpy(vis.T.copy()))
    assert ok, (worst, share)
    img = raster.render_image(x, s, "cpu")
    own = apply_lut(torch.from_numpy(vis.T.copy()),
                    torch.from_numpy(lut(s.colormap).copy())).numpy()
    np.testing.assert_array_equal(img, own.transpose(1, 0, 2)[::-1])
    want_img = jraster.render_image(x, js)
    assert img.shape == want_img.shape and img.dtype == np.uint8
    assert float((img != want_img).any(-1).mean()) <= IMAGE_SHARE


def test_render_entry_point_single_bank_and_multires():
    """``emspec_torch.render`` takes the single-bank raster for one bank
    (the JAX ``render`` calls ``render_image`` there) and the display
    pipeline for multires; it stays a function after the ``render``
    subpackage's modules are imported."""
    import emspec_torch.render.waterfall  # noqa: F401
    x = _audio(0.5, seed=9)
    s = Settings(multires=False, fft_size=1024)
    img = emspec_torch.render(x, s, "cpu")
    np.testing.assert_array_equal(img, raster.render_image(x, s, "cpu"))
    want = jraster.render_image(x, JaxSettings(multires=False, fft_size=1024))
    assert float((img != want).any(-1).mean()) <= IMAGE_SHARE
    from emspec_torch.pipeline import render_image_multires
    sm = Settings(multires_sizes=(2048, 512), hop=256)
    np.testing.assert_array_equal(emspec_torch.render(x, sm, "cpu"),
                                  render_image_multires(x, sm, "cpu"))
