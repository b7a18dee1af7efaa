"""Enhanced multires — the display default ``Settings()``, banks
8192/2048/512 at hop 128 — in the port against the JAX package on the
CPU, and its streaming loop against its own batch path.

Inputs come from numpy seeds and go to both packages; the port's params
are carried across with ``emspec_torch.convert.params_from_jax``.  The
CPU runs the JAX CPU's chain in both packages: per bank the whole
spectrum, the band-support bins sliced out, corrections, quantization
with the band weight, then one absolute-grid sum.  Tolerances:

* power grids: ``compare_grids`` — total energy ≤ 1e-4 relative, 3×3
  max-filters within 1e-3·peak on all but 1e-4 of the cells (XLA and
  torch round log2 and the FFT differently in the last ulp, which can
  move a quantized deposit one cell);
* ``vis``: ``compare_vis`` — 3×3 max-filters within 2/255 on all but
  1e-4 of the cells; with ``fft_impl="fourstep"`` on all but 2e-3: that
  engine packs the raw and t·h signals into one complex transform (the
  JAX package's numeric spec), which costs the raw spectrum ~10 bits, and
  the JAX package's own two engines differ on 8.3e-4 of the cells of this
  setting's 1 s raster;
* the AGC reference within 0.05 dB;
* streaming ≡ batch in the port, and the windowed plain B1 against the
  slice of the whole-spectrum plain B1: bit for bit;
* the pruned-DFT spectra (``stft_triple_stencil_sliced``/``_blocks``)
  within 1e-5·peak of the JAX package's and of the port's whole stencil
  spectra sliced to the same bins; ``signal_blocks`` bit-equal;
* the rendered images: the port's own RGBA raster bit for bit, and the
  JAX package's through the 3×3 max-filter within two display steps of
  ``vis`` mapped through the colormap's steepest step per channel, on all
  but 1e-4 of the pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.dsp import frame as jax_frame
from emspec.dsp import stft as jax_stft
from emspec.io import synth
from emspec.pipeline import Pipeline as JaxPipeline
from emspec.pipeline import render_image_multires as jax_render_multires
from emspec.pipeline import render_images_channels as jax_render_channels
from emspec.stream import Stream as JaxStream
from emspec.stream import stream_signal as jax_stream_signal
from emspec_torch import Settings, render
from emspec_torch.convert import params_from_jax, stream_state_from_jax
from emspec_torch.dsp import frame, stft
from emspec_torch.dsp.kernels.deposits import deposits_ids_plain
from emspec_torch.dsp.kernels.scatter import histogram_plain
from emspec_torch.dsp.reassign import reassignment_corrections
from emspec_torch.pipeline import (
    Pipeline, render_image_multires, render_images_channels)
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.tables import lut
from emspec_torch.validate import compare_grids, compare_vis

SR = 48_000
ROWS = 256
FOURSTEP_VIS_FRAC = 2e-3


def _kw(**kw):
    out = dict(mode="enhanced", raster_height=ROWS, smoothing=0.3)
    out.update(kw)
    return out


def _signal(seconds, channels=1, seed=0):
    rng = np.random.default_rng(seed)
    x = (synth.chirp(100.0, 9000.0, seconds)
         + synth.multitone([60.0, 440.0, 880.0, 5000.0], seconds,
                           amplitude=0.3)
         + 0.01 * rng.standard_normal(int(seconds * SR))).astype(np.float32)
    if channels == 2:
        x = np.stack([x, (synth.tone(150.0, seconds, amplitude=0.5)
                          + 0.02 * rng.standard_normal(x.shape[-1])
                          ).astype(np.float32)])
    return x


def _vis_close(want, got, frac=1e-4):
    ok, worst, share = compare_vis(torch.from_numpy(np.array(want)),
                                   torch.from_numpy(np.array(got)),
                                   frac=frac)
    assert ok, (worst, share)


CASES = {
    "xla-mono": (dict(), 1.0, 1),
    "xla-2ch": (dict(), 1.0, 2),
    "fourstep-mono": (dict(fft_impl="fourstep"), 1.0, 1),
    "direct-mono": (dict(fft_method="direct"), 1.0, 1),
    "direct-2ch": (dict(fft_method="direct"), 1.0, 2),
    "sizes-4096-1024-256": (dict(multires_sizes=(4096, 1024, 256)), 2.0, 1),
    "crossovers-300-3000": (dict(crossover_low=300.0,
                                 crossover_high=3000.0), 1.0, 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_matches_jax(case):
    extra, seconds, channels = CASES[case]
    kw = _kw(channels=channels, **extra)
    x = _signal(seconds, channels, seed=1)
    jp = JaxPipeline(JaxSettings(**kw))
    tp = Pipeline(Settings(**kw), "cpu")
    assert tp.k_slices == jp.k_slices and tp.reach == jp.reach
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    vis_j, rgba_j, st_j = jp.process(x, jparams)
    vis_t, rgba_t, st_t = tp.process(x, p)
    assert vis_t.shape == vis_j.shape and rgba_t.shape == rgba_j.shape
    t_count = tp.num_columns(x.shape[-1])
    power_j = jax.jit(jp._enhanced_power, static_argnums=1)(
        jnp.asarray(x), t_count, jparams)
    power_t = tp._enhanced_power(tp.to_device(x), t_count, p)
    cmp = compare_grids(torch.from_numpy(np.array(power_j)), power_t)
    assert cmp.ok, cmp
    frac = FOURSTEP_VIS_FRAC if tp.fft_impl == "fourstep" else 1e-4
    _vis_close(vis_j, vis_t.numpy(), frac)
    np.testing.assert_allclose(st_t.agc_ref.numpy(), np.asarray(st_j.agc_ref),
                               atol=0.05)


@pytest.mark.parametrize("scatter", ["auto", "pallas"])
@pytest.mark.parametrize("channels", [1, 2])
def test_streaming_equals_batch_bit_exact(scatter, channels):
    """Port stream ≡ port batch bit for bit: the absolute-grid sum and the
    ring's slot ids add each cell's deposits in (frame, bank, bin) order;
    the relative histograms fold in the ring's order."""
    s = Settings(**_kw(channels=channels, scatter=scatter, smoothing=0.5))
    x = _signal(0.6, channels, seed=4)
    vis_b, rgba_b, _ = Pipeline(s, "cpu").process(x)
    vis_s, rgba_s = stream_signal(x, s, "cpu", chunk=777)
    assert vis_s.shape == tuple(vis_b.shape)
    np.testing.assert_array_equal(vis_s, vis_b.numpy())
    np.testing.assert_array_equal(rgba_s, rgba_b.numpy())


def test_scatter_routes_agree():
    """Relative histograms + fold against the absolute grid: the same
    sums in another order."""
    s = Settings(**_kw())
    x = _signal(0.6, seed=6)
    a = Pipeline(s.replace(scatter="segment_sum"), "cpu").process(x)[0]
    b = Pipeline(s.replace(scatter="pallas"), "cpu").process(x)[0]
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_jax_stream_checkpoint_resumes_in_port():
    kw = _kw(smoothing=0.6)
    x = _signal(0.5, seed=3)
    half = x.shape[-1] // 2
    js = JaxStream(JaxSettings(**kw))
    cols_a = js.push(x[:half])
    saved = js.state_pytree()
    ts = Stream(Settings(**kw), "cpu",
                params=params_from_jax(js.params, "cpu"))
    ts.load_state(stream_state_from_jax(saved))
    ts.ring = js.ring                      # host ring, shared here
    cols_b = ts.push(x[half:]) + ts.flush()
    assert [c.index for c in cols_b] == list(
        range(len(cols_a), len(cols_a) + len(cols_b)))
    ref_vis, _ = jax_stream_signal(x, JaxSettings(**kw))
    got = np.stack([np.asarray(c.vis) for c in cols_a]
                   + [c.vis.numpy() for c in cols_b])
    _vis_close(ref_vis, got)


@pytest.mark.parametrize("scatter", ["segment_sum", "pallas"])
def test_nan_sample_leaves_no_nan(scatter):
    x = _signal(0.6, seed=8)
    x[12000] = np.nan
    x[20000] = np.inf
    s = Settings(**_kw(scatter=scatter))
    vis, _, st = Pipeline(s, "cpu").process(x)
    assert torch.isfinite(vis).all() and torch.isfinite(st.agc_ref).all()
    vis_s, _ = stream_signal(x, s, "cpu")
    assert np.isfinite(vis_s).all()


def _bank_frames(tp, x):
    t = tp.num_columns(x.shape[-1])
    return t, tp._bank_inputs(torch.from_numpy(x), t)


@pytest.mark.parametrize("bank", [0, 1, 2])
def test_windowed_plain_b1_is_the_weighted_slice(bank):
    """Plain B1 on a bank's window [k_lo, k_hi): without a band, the slice
    of the whole-spectrum plain B1 bit for bit; with the band, the same
    ids and contrib = (|X_h|²·band)·(1/N²) from the same corrections, bit
    for bit (within 2 ulp of the whole contrib times the band)."""
    tp = Pipeline(Settings(**_kw()), "cpu")
    p = tp.params()
    x = _signal(0.5, seed=11)
    _, inputs = _bank_frames(tp, x)
    fr, n = inputs[bank], tp.sizes[bank]
    k_lo, k_hi = tp.k_slices[bank]
    band = p.band_bins[bank]
    kw = dict(n=n, hop=tp.hop, sr=float(SR), rows=ROWS, reach=tp.reach)
    scal = (p.logmap_a, p.logmap_b, p.power_floor)
    ids_f, c_f = deposits_ids_plain(fr, *scal, **kw)
    ids_w, c_w = deposits_ids_plain(fr, *scal, **kw, k_lo=k_lo, k_hi=k_hi)
    assert ids_w.shape == (fr.shape[0], k_hi - k_lo)
    assert torch.equal(ids_w, ids_f[..., k_lo:k_hi])
    assert torch.equal(c_w, c_f[..., k_lo:k_hi])
    ids_b, c_b = deposits_ids_plain(fr, *scal, **kw, k_lo=k_lo, k_hi=k_hi,
                                    band=band)
    assert torch.equal(ids_b, ids_w)
    power = reassignment_corrections(*(
        a[..., k_lo:k_hi] for a in stft.stft_triple_stencil(fr)))[0]
    want = torch.where(c_w > 0, (power * band) * (1.0 / float(n * n)), 0.0)
    assert torch.equal(c_b, want)
    np.testing.assert_allclose(c_b.numpy(), (c_f[..., k_lo:k_hi] * band)
                               .numpy(), rtol=2.4e-7, atol=0)
    # band 0 outside the bank's support: those deposits carry nothing
    assert bool((c_b[..., band == 0] == 0).all())


@pytest.mark.parametrize("bank", [0, 1, 2])
def test_windowed_plain_b1_matches_jax_deposits_banked(bank):
    """Plain B1 with the bank's window and band against the JAX
    package's ``_deposits_banked`` for that bank, as relative histograms
    per frame (``compare_grids``)."""
    kw = _kw()
    jp = JaxPipeline(JaxSettings(**kw))
    tp = Pipeline(Settings(**kw), "cpu")
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    x = _signal(0.5, seed=12)
    t, inputs = _bank_frames(tp, x)
    R, n = tp.reach, tp.sizes[bank]
    P = 2 * R + 1

    def banked(x, jparams):
        rows_l, delta_l, contrib_l = jp._deposits_banked(
            jp._bank_inputs(x, t), jparams)
        return ((delta_l[bank] + R) * ROWS + rows_l[bank]), contrib_l[bank]

    ids_j, c_j = jax.jit(banked)(jnp.asarray(x), jparams)
    k_lo, k_hi = tp.k_slices[bank]
    ids_t, c_t = deposits_ids_plain(
        inputs[bank], p.logmap_a, p.logmap_b, p.power_floor, n=n, hop=tp.hop,
        sr=float(SR), rows=ROWS, reach=R, k_lo=k_lo, k_hi=k_hi,
        band=p.band_bins[bank])
    assert ids_t.shape == tuple(ids_j.shape)
    want = histogram_plain(torch.from_numpy(np.array(ids_j)),
                           torch.from_numpy(np.array(c_j)), P * ROWS)
    got = histogram_plain(ids_t, c_t, P * ROWS)
    cmp = compare_grids(want.reshape(t, P, ROWS), got.reshape(t, P, ROWS))
    assert cmp.ok, cmp


@pytest.mark.parametrize("n,hop", [(8192, 128), (2048, 128), (512, 128),
                                   (2048, 300), (1000, 128)])
def test_signal_blocks_bit_equal_to_jax(n, hop):
    x = _signal(0.4, seed=n)
    want = np.asarray(jax_frame.signal_blocks(jnp.asarray(x), n, hop))
    got = frame.signal_blocks(torch.from_numpy(x), n, hop).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bank", [0, 1, 2])
@pytest.mark.parametrize("hop", [128, 300])
def test_pruned_dft_matches_jax_and_the_full_stencil(bank, hop):
    tp = Pipeline(Settings(**_kw()), "cpu")
    n = tp.sizes[bank]
    k_lo, k_hi = tp.k_slices[bank]
    x = _signal(0.4, seed=bank)
    fr = frame.frame_signal(torch.from_numpy(x), n, hop)
    t = fr.shape[0]
    x2 = frame.signal_blocks(torch.from_numpy(x), n, hop)
    sliced = stft.stft_triple_stencil_sliced(fr, k_lo, k_hi)
    blocks = stft.stft_triple_stencil_blocks(x2, t, n, k_lo, k_hi)
    full = [a[..., k_lo:k_hi] for a in stft.stft_triple_stencil(fr)]
    j_sliced = jax_stft.stft_triple_stencil_sliced(jnp.asarray(fr.numpy()),
                                                   k_lo, k_hi)
    j_blocks = jax_stft.stft_triple_stencil_blocks(jnp.asarray(x2.numpy()),
                                                   t, n, k_lo, k_hi)
    for name, s, b, f, js, jb in zip(("X_h", "X_th", "X_dh"), sliced, blocks,
                                     full, j_sliced, j_blocks):
        peak = float(f.abs().max())
        assert s.shape == b.shape == f.shape == (t, k_hi - k_lo)
        for got, want in ((s, np.asarray(js)), (b, np.asarray(jb)),
                          (s, f.numpy()), (b, f.numpy())):
            err = float(np.abs(got.numpy() - want).max())
            assert err <= 1e-5 * peak, (name, err / peak)


def test_render_multires_and_channels_match_jax():
    """The rendered images are the port's RGBA raster, bit for bit, and
    match the JAX package's through the 3×3 max-filter: within two
    display steps of ``vis``, mapped through the colormap's steepest step
    per channel."""
    kw = _kw()
    x = _signal(1.0, 2, seed=5)
    s2 = Settings(**kw, channels=2, display_channel=1)
    img_t = render_image_multires(x, s2, "cpu")
    img_j = np.asarray(jax_render_multires(x, JaxSettings(
        **kw, channels=2, display_channel=1)))
    rgba = Pipeline(s2, "cpu").process(x)[1].numpy()
    np.testing.assert_array_equal(img_t, rgba[:, 1].transpose(1, 0, 2)[::-1])
    imgs_t = render_images_channels(x, Settings(**kw), "cpu")
    imgs_j = jax_render_channels(x, JaxSettings(**kw))
    assert len(imgs_t) == len(imgs_j) == 2
    np.testing.assert_array_equal(imgs_t[1], img_t)
    mono_t = render(x[0], Settings(**kw), device="cpu")
    table = lut(Settings().colormap).astype(np.float64)
    atol = 2.0 * float(np.abs(np.diff(table, axis=0)).max()) / 255.0
    for got, want in [(img_t, img_j), (mono_t, imgs_j[0])] + list(
            zip(imgs_t, imgs_j)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == np.uint8
        # (rows, t, 4) → (t, 4, rows): the max-filter runs over time × row
        g, w = (torch.from_numpy(np.ascontiguousarray(
            a[::-1].transpose(1, 2, 0)).astype(np.float32) / 255.0)
            for a in (got, want))
        ok, worst, share = compare_vis(w, g, atol=atol)
        assert ok, (worst, share, atol)
