"""The port's real FFT (``emspec_torch/dsp/kernels/rfft.py``, kernel
``csrc/rfft.cu``) on the CPU, where the wrapper runs its plain version,
against the JAX package's ``jnp.fft.rfft``; the slice through it —
natural mode, the direct method and a 256 bank of the stencil method —
against the JAX package's batch; the wrapper's routing and refusals.

Tolerances: spectra and power within 2e-5·√(N/512) of the peak (DESIGN.md
§9: pocketfft in torch and XLA's FFT differ in float32 rounding only);
``vis`` through ``compare_vis`` (2/255 on all but 1e-4 of the cells);
the port's stream ≡ its batch bit for bit in ``vis`` and ``rgba``.  The
kernel itself runs on a card only: ``tests/test_torch_cuda.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.dsp.windows import hann as jax_hann
from emspec.io import synth
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch import pipeline as pipeline_module
from emspec_torch.config import Settings
from emspec_torch.convert import params_from_jax
from emspec_torch.dsp import stft
from emspec_torch.dsp.kernels import deposits, rfft
from emspec_torch.dsp.kernels.rfft import (
    rfft_frames, rfft_frames_plain, route_of, supported)
from emspec_torch.pipeline import Pipeline
from emspec_torch.stream import stream_signal
from emspec_torch.validate import compare_vis

ROOT = Path(__file__).resolve().parents[1]
SR = 48_000
SIZES = [256, 512, 1024, 2048, 4096, 8192, 65536]


def _tol(n: int) -> float:
    return 2e-5 * np.sqrt(n / 512)


def _frames(n: int, b: int = 3, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    tone = np.sin(2 * np.pi * 440.0 * t)[None]
    return (tone + 0.1 * rng.standard_normal((b, n))).astype(np.float32)


# ------------------------------------------------------------ plain vs JAX
@pytest.mark.parametrize("window", ["none", "hann"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_spectrum_matches_jax_rfft(n, window):
    x = _frames(n, seed=n)
    w = jax_hann(n) if window == "hann" else None
    want = np.asarray(jnp.fft.rfft(jnp.asarray(x if w is None else x * w),
                                   axis=-1))
    got = rfft_frames(torch.from_numpy(x),
                      None if w is None else torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (3, n // 2 + 1)
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= _tol(n) * np.abs(want).max()


@pytest.mark.parametrize("n", SIZES)
def test_plain_power_matches_jax_and_scrubs_nonfinite(n):
    """The power form: Hann |X|² as the JAX package's ``_bank_power``
    computes it, a frame with a NaN, one with +Inf and one with −Inf
    zeroed, the finite frame within the bound."""
    x = _frames(n, b=4, seed=n + 1)
    x[1, n // 3] = np.nan
    x[2, n // 2] = np.inf
    x[3, 7] = -np.inf
    w = jax_hann(n)
    X = jnp.fft.rfft(jnp.asarray(x * w), axis=-1)
    p = (X.real ** 2 + X.imag ** 2).astype(jnp.float32)
    want = np.asarray(jnp.where(jnp.isfinite(p), p, 0.0))
    got = rfft_frames(torch.from_numpy(x), torch.from_numpy(w),
                      power=True).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1:], 0.0)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got - want).max() <= _tol(n) * want.max()


@pytest.mark.parametrize("n", [4096, 16384])
def test_plain_frame_bits_do_not_depend_on_the_batch(n):
    """Row by row on the CPU: a frame alone, in a batch of 7 and in a
    strided framing view gives the same bits (MKL's batched transform
    rounds otherwise at 16384)."""
    x = torch.from_numpy(_frames(4 * n, b=1, seed=3)[0])
    fr = x.unfold(-1, n, n // 2)                       # (7, n) view
    batch = rfft_frames(fr, stft.hann_window(n, "cpu"))
    for k in (0, 3, 6):
        alone = rfft_frames(fr[k].clone(), stft.hann_window(n, "cpu"))
        assert torch.equal(alone, batch[k])
    assert torch.equal(rfft_frames(fr), rfft_frames_plain(fr))


def test_plain_references_never_reach_the_wrapper(monkeypatch):
    """B1's plain version and the stencil plain spectra call
    ``torch.fft`` through ``rfft_frames_plain``: with the wrapper made to
    raise, both still run."""
    def refuse(*a, **kw):
        raise AssertionError("a plain reference reached the kernel wrapper")
    monkeypatch.setattr(stft, "rfft_frames", refuse)
    monkeypatch.setattr(rfft, "rfft_frames", refuse)
    fr = torch.from_numpy(_frames(1024, b=2, seed=4))
    scal = [torch.tensor(np.float32(v)) for v in (
        np.log2(20.0), 127 / (np.log2(24000.0) - np.log2(20.0)), 1e-12)]
    ids, contrib = deposits.deposits_ids_plain(
        fr, *scal, n=1024, hop=256, sr=float(SR), rows=128, reach=2)
    assert ids.shape == contrib.shape == (2, 513)
    X_h, X_th, X_dh = stft.stft_triple_stencil_plain(fr.double())
    assert X_h.dtype == torch.complex128 and X_th.shape == (2, 513)


# ------------------------------------------------------------ routing
def test_routes_by_size_alone():
    assert [route_of(1 << b) for b in range(8, 19)] == (
        ["full"] + ["block"] * 5 + ["cluster"] * 5)
    assert all(supported(1 << b) for b in range(8, 19))
    assert not any(supported(n) for n in (0, 128, 384, 1000, 524288))


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 1000), torch.float32, "powers of two"),
    ((2, 128), torch.float32, "powers of two"),
    ((1, 524288), torch.float32, "powers of two"),
    ((2, 1024), torch.float64, "float32"),
    ((2, 1024), torch.float32, "expected a CPU or CUDA"),
], ids=["not-power-of-two", "below-256", "above-262144", "float64", "cpu"])
def test_the_kernel_entry_refuses(shape, dtype, match):
    """What the kernel does not take raises a ValueError at its entry,
    before any launch; a CPU tensor there too (the wrapper sends a CPU
    tensor to the plain version before it)."""
    with pytest.raises(ValueError, match=match):
        rfft._launch(torch.zeros(shape, dtype=dtype), None, False)


def test_the_kernel_entry_refuses_a_window_of_another_size():
    with pytest.raises(ValueError, match="window must be"):
        rfft._launch(torch.zeros(2, 1024), torch.zeros(512), True)


def test_a_card_pipeline_refuses_a_bank_the_kernel_does_not_hold(
        monkeypatch):
    """A pipeline on the card (the device faked: its constructor runs no
    CUDA work) refuses a bank of 524288 points on the default engine with
    a ValueError when it is built; one bank of 512, 4096 and 262144 points
    and a multires pipeline with a 256 bank build."""
    monkeypatch.setattr(pipeline_module, "as_device",
                        lambda d: torch.device("cuda", 0))
    with pytest.raises(ValueError, match=r"\[524288\] outside the card's "
                       r"real FFT"):
        Pipeline(Settings(mode="natural", multires_sizes=(524288, 2048)),
                 "cuda")
    for n in (512, 4096, 262144):
        Pipeline(Settings(mode="natural", multires=False, fft_size=n), "cuda")
    Pipeline(Settings(mode="natural", multires_sizes=(2048, 256)), "cuda")
    with pytest.raises(ValueError):
        rfft.require_sizes((8192, 524288), "Pipeline")


def test_the_module_imports_without_nvcc():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", "import emspec_torch.dsp.kernels.rfft as r; "
         "print(r.route_of(4096), r.rfft_frames.launches)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["block", "0"]


# ------------------------------------------------------------ the slice
CASES = {
    "natural-4096": dict(mode="natural", multires=False, fft_size=4096),
    "direct-4096": dict(mode="enhanced", multires=False, fft_size=4096,
                        fft_method="direct"),
    "natural-256-bank": dict(mode="natural", multires_sizes=(2048, 256),
                             hop=128),
    "direct-256-bank": dict(mode="enhanced", multires_sizes=(2048, 256),
                            hop=128, fft_method="direct"),
    "stencil-256-bank": dict(mode="enhanced", multires_sizes=(2048, 256),
                             hop=128),
}


def _signal(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (synth.chirp(60.0, 9000.0, seconds)
            + synth.multitone([110.0, 440.0, 3520.0], seconds, amplitude=0.2)
            + 0.01 * rng.standard_normal(int(seconds * SR))
            ).astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_matches_the_jax_batch(case):
    kw = dict(CASES[case], raster_height=256, smoothing=0.3)
    x = _signal(1.0, 11)
    jp = JaxPipeline(JaxSettings(**{**kw, "scatter": "segment_sum"}))
    tp = Pipeline(Settings(**kw), "cpu")
    assert tp.fft_impl == jp.fft_impl == "xla"
    jparams = jp.params()
    vis_j, _, _ = jp.process(x, jparams)
    vis_t, rgba_t, _ = tp.process(x, params_from_jax(jparams, "cpu"))
    assert vis_t.shape == vis_j.shape and rgba_t.dtype == torch.uint8
    ok, worst, share = compare_vis(torch.from_numpy(np.array(vis_j)), vis_t)
    assert ok, (worst, share)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_is_the_batch_bit_for_bit(case):
    s = Settings(**CASES[case], raster_height=256, smoothing=0.5)
    x = _signal(0.5, 12)
    vis_b, rgba_b, _ = Pipeline(s, "cpu").process(x)
    vis_s, rgba_s = stream_signal(x, s, "cpu", chunk=777)
    np.testing.assert_array_equal(vis_s, vis_b.numpy())
    np.testing.assert_array_equal(rgba_s, rgba_b.numpy())
