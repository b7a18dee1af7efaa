"""On-card kernel validation: every CUDA kernel of the port against its
plain PyTorch version (``emspec.dsp.pallas.validate``), the check
``python -m emspec_torch doctor --kernels`` runs.

Shapes are the JAX package's: B2 at (16, 16512, 4608) and (4, 901, 1152)
(rows, deposits a row, cells), B5 at (90, 2048) and (32768,), B4 at 8192
and 32768 points, B1 at 8192 and 32768 and, unless ``quick``, 131072 and
262144 at b = 2, B3 at (640, 512) pixels in both forms, and the batch
post chain's three kernels: the EMA scan (1024 × 512, also with every
chunk forced to repair), ``post_head`` and ``post_tail`` (1024 × 512, at
smoothing 0 and 0.6).  ``quick`` takes the smaller set: B2 (4, 2048,
4608), B5 (16, 2048), B4 and B1 at 8192.

Tolerances: B2 rtol 5e-5, atol 1e-4 (float32 sums in another order); B5,
B3 and the post chain's kernels bit-equal; B4 2e-5·max|X|; B1 as
histograms (energy and 3×3 max-filters, ``validate.compare_grids``) and
≥ 99.99% equal ids.

The card only: on the CPU the plain versions are what the wrappers run,
so there is nothing to hold them against and ``validate_kernels``
raises.
"""

from __future__ import annotations

import numpy as np
import torch


def _assert(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def validate_histogram(dev, shapes=((16, 16512, 4608), (4, 901, 1152)),
                       rtol: float = 5e-5) -> None:
    """B2 (``histogram``, its route by shape) against ``histogram_plain``
    on ids in [−1, S), a share of them dropped."""
    from emspec_torch.dsp.kernels.scatter import histogram, histogram_plain

    rng = np.random.default_rng(7)
    for b, m, s in shapes:
        ids = torch.from_numpy(rng.integers(-1, s, (b, m)).astype(np.int32))
        vals = torch.from_numpy(rng.uniform(0.0, 1.0, (b, m)).astype(
            np.float32))
        got = histogram(ids.to(dev), vals.to(dev), s).cpu()
        want = histogram_plain(ids, vals, s)
        torch.testing.assert_close(got, want, rtol=rtol, atol=1e-4)


def validate_windowing(dev, shapes=((90, 2048), (32768,))) -> None:
    """B5 (``windowed_frames``) bit-equal to the plain triple multiply."""
    from emspec_torch.dsp.kernels.window import (
        windowed_frames, windowed_frames_plain)

    rng = np.random.default_rng(8)
    for shape in shapes:
        frames = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
        _assert(torch.equal(windowed_frames(frames),
                            windowed_frames_plain(frames)),
                f"B5 at {shape}: differs from the plain triple window")


def validate_fft4(dev, ns=(8192, 32768), rtol: float = 2e-5) -> None:
    """B4 (``fft4_steps123``) against its plain float32 products, three
    sequences at each size."""
    from emspec_torch.dsp.fourstep import _FACTORS
    from emspec_torch.dsp.kernels.fourstep import (
        fft4_steps123, fft4_steps123_plain)

    rng = np.random.default_rng(9)
    for n in ns:
        n1, n2 = _FACTORS[n]
        zr, zi = (torch.from_numpy(rng.standard_normal((3, n1, n2)).astype(
            np.float32)).to(dev) for _ in range(2))
        got = fft4_steps123(zr, zi)
        want = fft4_steps123_plain(zr, zi)
        scale = float(torch.hypot(*want).max())
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        _assert(err <= rtol * scale,
                f"B4 n={n}: error {err / scale:.2e}·max|X| > {rtol}")


def validate_deposits(dev, n: int = 8192, b: int = 3) -> None:
    """B1 (``deposits_ids``, its route by size) against its plain version
    on a tone in noise, as relative histograms (reach 4, hop n/4)."""
    from emspec_torch.dsp.kernels.deposits import (
        deposits_ids, deposits_ids_plain)
    from emspec_torch.dsp.kernels.scatter import histogram_plain
    from emspec_torch.validate import compare_grids

    rng = np.random.default_rng(10)
    hop, rows, sr, reach = n // 4, 128, 48000.0, 4
    frames = torch.from_numpy(
        (0.2 * rng.standard_normal((b, n))
         + np.sin(2 * np.pi * 440.0 / sr * np.arange(n))[None]
         ).astype(np.float32)).to(dev)
    a = np.log2(20.0)
    scal = tuple(torch.tensor(v, dtype=torch.float32, device=dev) for v in (
        a, (rows - 1) / (np.log2(sr / 2) - a), 1e-12))
    kw = dict(n=n, hop=hop, sr=sr, rows=rows, reach=reach)
    ik, ck = deposits_ids(frames, *scal, **kw)
    ip, cp = deposits_ids_plain(frames, *scal, **kw)
    cells = (2 * reach + 1) * rows
    g = compare_grids(
        histogram_plain(ip, cp, cells).reshape(b, 2 * reach + 1, rows),
        histogram_plain(ik, ck, cells).reshape(b, 2 * reach + 1, rows))
    vk, vp = ck > 0, cp > 0
    agree = float((((ik == ip) & vk & vp) | (~vk & ~vp)).float().mean())
    _assert(g.ok and agree >= 0.9999,
            f"B1 n={n}: {g}, ids equal on {agree:.6f} of the bins")


def validate_lut(dev) -> None:
    """B3 in both forms (``lut_lookup`` on int32 indices, ``lut_values``
    on float32 values) bit-equal to the gather."""
    from emspec_torch.dsp.kernels.lut import (
        lut_lookup, lut_lookup_plain, lut_values, lut_values_plain)
    from emspec_torch.tables import lut

    rng = np.random.default_rng(11)
    table = torch.from_numpy(lut("inferno").copy()).to(dev)
    idx = torch.from_numpy(rng.integers(0, 256, (640, 512)).astype(
        np.int32)).to(dev)
    _assert(torch.equal(lut_lookup(idx, table), lut_lookup_plain(idx, table)),
            "B3 lut_lookup differs from the gather")
    vals = torch.from_numpy(rng.uniform(-0.1, 1.1, (640, 512)).astype(
        np.float32)).to(dev)
    _assert(torch.equal(lut_values(vals, table), lut_values_plain(vals, table)),
            "B3 lut_values differs from its plain quantize and gather")


def validate_ema(dev, shape=(1024, 512), alpha: float = 0.7) -> None:
    """The EMA scan kernel bit-equal to its plain loop, with its
    speculation as it comes and with every chunk forced to repair."""
    from emspec_torch.dsp.kernels.ema import ema_scan, ema_scan_plain

    rng = np.random.default_rng(12)
    b = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev)
    y0 = torch.from_numpy(rng.uniform(0, 1, shape[1:]).astype(
        np.float32)).to(dev)
    for a in (alpha, torch.tensor(alpha, dtype=torch.float32, device=dev)):
        want = ema_scan_plain(y0, a, b)
        for window in (None, 0):
            got = ema_scan(y0, a, b, window=window)
            _assert(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"ema_scan (window {window}) differs from its plain "
                    f"loop")


def validate_post(dev, t: int = 1024, rows: int = 512) -> None:
    """The post chain's fused kernels: ``post_head`` bit-equal to its plain
    stages 1–3 and row peak, ``post_tail`` to its plain stages 4–8 around
    the smoothing loop (forced repair too), at smoothing 0 and 0.6."""
    from emspec_torch.config import Settings
    from emspec_torch.dsp.kernels.post import (
        post_head, post_head_plain, post_tail, post_tail_plain)
    from emspec_torch.post.chain import PostParams

    rng = np.random.default_rng(13)
    power = torch.from_numpy((10.0 ** rng.uniform(-12, 0, (t, rows))).astype(
        np.float32)).to(dev)
    y0 = torch.from_numpy(rng.uniform(0, 1, rows).astype(np.float32)).to(dev)
    freqs = np.geomspace(20.0, 24000.0, rows)
    for smoothing in (0.0, 0.6):
        p = PostParams.from_settings(Settings(smoothing=smoothing), freqs,
                                     dev)
        refs = post_head(power, p.low_end_ramp, p.gain)
        _assert(torch.equal(refs, post_head_plain(power, p.low_end_ramp,
                                                  p.gain)),
                "post_head differs from its plain version")
        want = post_tail_plain(power, refs, y0, p)
        for window in (None, 0):
            got = post_tail(power, refs, y0, p, window=window)
            _assert(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"post_tail (smoothing {smoothing}, window {window}) "
                    f"differs from its plain version")


def validate_kernels(quick: bool = False, device="cuda") -> dict:
    """Run every kernel check on ``device`` (a card); raises on the first
    failure, and on the CPU.  Returns a report dict."""
    from emspec_torch.device import as_device

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(
            f"validate_kernels checks the CUDA kernels on a card; on "
            f"{dev} the wrappers run the plain versions themselves")
    if not torch.cuda.is_available():
        raise RuntimeError("validate_kernels: no CUDA device is available")
    dev = as_device(dev)
    from emspec_torch import kernels_build
    kernels_build.library()
    validate_histogram(dev, ((4, 2048, 4608),) if quick
                       else ((16, 16512, 4608), (4, 901, 1152)))
    validate_windowing(dev, ((16, 2048),) if quick else ((90, 2048), (32768,)))
    validate_fft4(dev, (8192,) if quick else (8192, 32768))
    validate_deposits(dev, 8192)
    if not quick:
        validate_deposits(dev, 32768)
        validate_deposits(dev, 131072, b=2)
        validate_deposits(dev, 262144, b=2)
    validate_lut(dev)
    validate_ema(dev)
    validate_post(dev)
    torch.cuda.synchronize(dev)
    return {"device": torch.cuda.get_device_name(dev),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "library": kernels_build.library_path().name,
            "quick": quick, "kernels_validated": True}
