"""Reassigned analysis above 16384 points (the north star's 32768, the
16-channel 96 kHz stress configuration, 65536–262144), kernel B6 and the
scatter-ablation probe: the port against the JAX package on the CPU.

* The port's ``Pipeline`` at 32768–262144 against the JAX package's:
  power grids by ``compare_grids`` (total energy ≤ 1e-4 relative, 3×3
  max-filters within 1e-3·peak on all but 1e-4 of the cells), ``vis`` by
  ``compare_vis`` (2/255 on all but 1e-4 of the cells).
* Streaming ≡ batch, bit for bit on the CPU.
* A plain PyTorch mirror of B1's large-frame route, stage by stage, with
  the CUDA source's own index maps (pack → ``fft4_steps123_plain`` →
  step-4 unpack → epilogue), against plain B1 — where an index mistake
  of the route shows without a card.
* B6's plain version against the JAX ``fft4_hist`` in interpret mode, to
  3e-5·max (the JAX package's own bound, ``tests/test_pallas.py``).
* Each probe variant's plain version against a direct numpy count.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from emspec.config import Settings as JaxSettings
from emspec.dsp.frame import frame_signal as jax_frame_signal
from emspec.dsp.pallas.fft4 import fft4_hist
from emspec.pipeline import Pipeline as JaxPipeline
from emspec.stream import Stream as JaxStream
from emspec.stream import stream_signal as jax_stream_signal
from emspec_torch.config import Settings
from emspec_torch.convert import params_from_jax, stream_state_from_jax
from emspec_torch.dsp.fourstep import _FACTORS
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.deposits import (
    _twiddles, deposits_hist, deposits_hist_plain, deposits_ids,
    deposits_ids_large, deposits_ids_plain, quantize_deposits)
from emspec_torch.dsp.kernels.fourstep import fft4_steps123_plain
from emspec_torch.dsp.kernels.scatter import (
    GLOBAL_THREADS, ROW_THREADS, global_blocks, histogram_plain, route_of)
from emspec_torch.dsp.reassign import reassignment_corrections
from emspec_torch.dsp.stft import stencil_from_raw, th_window
from emspec_torch.pipeline import Pipeline
from emspec_torch.probes.scatter_ablation import (
    NO_ZERO_ROWS, VARIANTS, alignment, hist_variant, hist_variant_plain)
from emspec_torch.stream import Stream, stream_signal
from emspec_torch.validate import compare_grids, compare_vis

LARGE = (32768, 65536, 131072, 262144)


def _signal(samples, sr, channels=1, seed=0):
    """A chirp 100 Hz → 9 kHz, three tones and 1% noise (channel 2: a
    300 Hz tone and 2% noise), from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / sr
    sec = samples / sr
    x = (0.5 * np.sin(2 * np.pi * (100.0 * t + 0.5 * 8900.0 / sec * t * t))
         + sum(0.3 * np.sin(2 * np.pi * f * t) for f in (440.0, 880.0, 1320.0))
         + 0.01 * rng.standard_normal(samples))
    if channels == 2:
        x = np.stack([x, 0.5 * np.sin(2 * np.pi * 300.0 * t)
                      + 0.02 * rng.standard_normal(samples)])
    return x.astype(np.float32)


def _kw(n, sr, rows, channels=1, **extra):
    kw = dict(mode="enhanced", multires=False, fft_size=n, sample_rate=sr,
              raster_height=rows, channels=channels, smoothing=0.3)
    kw.update(extra)
    return kw


def _frames_case(n, sr, t, seed):
    """(t, n) frames at hop n/4 and the quantization constants."""
    s = Settings(**_kw(n, sr, 128))
    pipe = Pipeline(s, "cpu")
    x = _signal((t - 1) * pipe.hop + n, sr, seed=seed)
    p = pipe.params()
    fr = frame_signal(torch.from_numpy(x), n, pipe.hop)
    kw = dict(n=n, hop=pipe.hop, sr=float(sr), rows=pipe.rows,
              reach=pipe.reach)
    return fr, (p.logmap_a, p.logmap_b, p.power_floor), kw


# --------------------------------------------------- the path vs the JAX package
@pytest.mark.parametrize("n,sr,rows,channels,frames", [
    (32768, 48000, 512, 1, 5),
    (32768, 96000, 128, 2, 4),
    (65536, 96000, 128, 1, 4),
    (262144, 96000, 128, 1, 3),
])
def test_process_matches_jax(n, sr, rows, channels, frames):
    kw = _kw(n, sr, rows, channels)
    jp, tp = JaxPipeline(JaxSettings(**kw)), Pipeline(Settings(**kw), "cpu")
    x = _signal((frames - 1) * tp.hop + n, sr, channels, seed=n % 97)
    jparams = jp.params()
    p = params_from_jax(jparams, "cpu")
    vis_j, rgba_j, _ = jp.process(x, jparams)
    vis_t, rgba_t, _ = tp.process(x, p)
    assert vis_t.shape == vis_j.shape == (frames,) + x.shape[:-1] + (rows,)
    assert rgba_t.shape == rgba_j.shape and rgba_t.dtype == torch.uint8
    power_j = jp._enhanced_power(jnp.asarray(x), frames, jparams)
    power_t = tp._enhanced_power(tp.to_device(x), frames, p)
    cmp = compare_grids(torch.from_numpy(np.array(power_j)), power_t)
    assert cmp.ok, cmp
    ok, worst, share = compare_vis(torch.from_numpy(np.array(vis_j)), vis_t)
    assert ok, (worst, share)


@pytest.mark.parametrize("hop,scatter,rows,channels", [
    (0, "auto", 512, 2),            # hop n/4 = 8192, segment-sum route
    (800, "pallas", 128, 1),        # the north star's 60 columns/s, R = 20
])
def test_streaming_equals_batch_bit_exact(hop, scatter, rows, channels):
    s = Settings(**_kw(32768, 48000, rows, channels, hop=hop,
                       scatter=scatter))
    pipe = Pipeline(s, "cpu")
    x = _signal(32768 + 12 * pipe.hop + 300, 48000, channels, seed=11)
    vis_b, rgba_b, _ = pipe.process(x)
    vis_s, rgba_s = stream_signal(x, s, "cpu", chunk=5000)
    assert vis_s.shape == tuple(vis_b.shape)
    np.testing.assert_array_equal(vis_s, vis_b.numpy())
    np.testing.assert_array_equal(rgba_s, rgba_b.numpy())


def test_jax_stream_checkpoint_resumes_in_port():
    """A JAX Stream snapshot at 32768, 2 channels, converted, resumes in
    the port: the resumed columns match the JAX stream's own."""
    kw = _kw(32768, 48000, 128, 2, smoothing=0.6)
    js = JaxStream(JaxSettings(**kw))
    x = _signal(32768 + 8 * js.pipe.hop, 48000, 2, seed=3)
    half = x.shape[-1] // 2
    cols_a = js.push(x[:, :half])
    ts = Stream(Settings(**kw), "cpu",
                params=params_from_jax(js.params, "cpu"))
    ts.load_state(stream_state_from_jax(js.state_pytree()))
    ts.ring = js.ring                      # host ring, shared here
    cols_b = ts.push(x[:, half:]) + ts.flush()
    assert [c.index for c in cols_b] == list(
        range(len(cols_a), len(cols_a) + len(cols_b)))
    ref_vis, _ = jax_stream_signal(x, JaxSettings(**kw))
    got = np.stack([np.asarray(c.vis) for c in cols_a]
                   + [c.vis.numpy() for c in cols_b])
    ok, worst, share = compare_vis(torch.from_numpy(ref_vis),
                                   torch.from_numpy(got))
    assert ok, (worst, share)


# ------------------------------------------- B1's large route, stage by stage
def _large_route_mirror(frames, logmap_a, logmap_b, power_floor, *, n, hop,
                        sr, rows, reach):
    """csrc/deposits_large.cu in plain PyTorch, its index maps verbatim."""
    m = n // 2
    n1, n2 = _FACTORS[m]
    b = frames.shape[0]
    th = th_window(n, frames.device)
    # 1. pack: sequence 2f the raw, 2f+1 the t·h signal; z[i] = s[2i] + i·s[2i+1]
    sig = torch.stack([frames, frames * th], 1)                # (b, 2, n)
    zr = sig[..., 0::2].reshape(2 * b, n1, n2)
    zi = sig[..., 1::2].reshape(2 * b, n1, n2)
    # 2. B4 steps 1–3: X[k1, k2] at address k1·n2 + k2
    xr, xi = fft4_steps123_plain(zr, zi)
    xr, xi = xr.reshape(b, 2, m), xi.reshape(b, 2, m)
    # 3. finish: thread q → bin k, X[j] by spectrum_at
    q = torch.arange(m + 1)
    k = torch.where(q == m, m, q // n2 + n1 * (q % n2))
    tw = torch.view_as_complex(_twiddles(n, "cpu"))

    def spectrum_at(j, plane):
        upper = j > m // 2
        jl = torch.where(upper, m - j, j)
        jm = torch.where(jl == 0, 0, m - jl)
        a0 = (jl % n1) * n2 + jl // n1
        a1 = (jm % n1) * n2 + jm // n1
        zk = torch.complex(xr[:, plane, a0], xi[:, plane, a0])
        zmk = torch.complex(xr[:, plane, a1], xi[:, plane, a1])
        ze = torch.complex(0.5 * (zk.real + zmk.real), 0.5 * (zk.imag - zmk.imag))
        zo = torch.complex(0.5 * (zk.imag + zmk.imag), -0.5 * (zk.real - zmk.real))
        t = tw[jl] * zo
        return torch.where(upper, torch.conj(ze - t), ze + t)

    X = spectrum_at(k, 0)
    Y = spectrum_at(k, 1)
    assert sorted(k.tolist()) == list(range(m + 1))           # a bijection
    order = torch.argsort(k)
    X, Y = X[:, order], Y[:, order]                             # natural order
    # 4. epilogue (Hermitian neighbours at k = 0 and N/2 in stencil_from_raw)
    row, delta, contrib = quantize_deposits(
        *reassignment_corrections(*stencil_from_raw(X, Y, n)), logmap_a,
        logmap_b, power_floor, n=n, hop=hop, sr=sr, rows=rows)
    return (delta + reach) * rows + row, contrib


@pytest.mark.parametrize("n,sr", [(32768, 96000), (65536, 96000),
                                  (131072, 48000)])
def test_large_route_mirror_matches_plain(n, sr):
    """The route's arithmetic, its index maps and its Hermitian edges,
    against plain B1 (torch.fft): the B1 criteria of the card check."""
    fr, scal, kw = _frames_case(n, sr, 3, seed=n % 89)
    im, cm = _large_route_mirror(fr, *scal, **kw)
    ip, cp = deposits_ids_plain(fr, *scal, **kw)
    S = (2 * kw["reach"] + 1) * kw["rows"]
    g = compare_grids(histogram_plain(ip, cp, S), histogram_plain(im, cm, S))
    assert g.ok, g
    vm, vp = cm > 0, cp > 0
    both = vm & vp
    agree = (both & (im == ip)) | (~vm & ~vp)
    assert float(agree.float().mean()) >= 0.9999
    assert bool(agree[:, [0, n // 2]].all())                   # edges exact
    assert float((cm - cp)[both].abs().max()) <= 1e-5 * float(cp.max())


@pytest.mark.parametrize("n", LARGE)
def test_step4_map_covers_every_bin(n):
    """Thread q of the finish kernel takes bin k = q div n2 + n1·(q mod n2)
    (k = N/2 for q = N/2); X[j] is read at (j mod n1)·n2 + j div n1: both
    maps are bijections, and the thread's own bin is read at address q."""
    m = n // 2
    n1, n2 = _FACTORS[m]
    q = np.arange(m)
    k = q // n2 + n1 * (q % n2)
    assert np.array_equal(np.sort(k), q)
    assert np.array_equal((k % n1) * n2 + k // n1, q)
    mirror = (m - k) % m                                       # Z[m − k]
    addr = (mirror % n1) * n2 + mirror // n1
    assert np.array_equal(np.sort(addr), q)


# --------------------------------------------------------------- B6 and routing
@pytest.mark.parametrize("min_id", [-2**30, 2 * 128])
def test_deposits_hist_plain_matches_pallas_interpret(min_id):
    """Plain B6 vs the TPU kernel fft4_hist itself (interpret mode)."""
    n, hop, rows, t, sr = 1024, 256, 128, 3, 48000.0
    jp = JaxPipeline(JaxSettings(**_kw(n, 48000, rows, hop=hop)))
    p, R = jp.params(), jp.reach
    x = _signal((t - 1) * hop + n, 48000, seed=21)
    fr = np.asarray(jax_frame_signal(jnp.asarray(x), n, hop))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fft4_hist(jnp.asarray(fr), p.logmap_a, p.logmap_b,
                                    p.power_floor, min_id, n=n, hop=hop,
                                    sr=sr, rows=rows, reach=R))
    got = deposits_hist(torch.from_numpy(fr), float(p.logmap_a),
                        float(p.logmap_b), float(p.power_floor), min_id,
                        n=n, hop=hop, sr=sr, rows=rows, reach=R).numpy()
    assert got.shape == want.shape == (t, (2 * R + 1) * rows)
    scale = max(float(want.max()), 1e-30)
    assert np.abs(got - want).max() / scale < 3e-5
    if min_id > 0:
        assert np.abs(got[:, :min_id]).max() == 0.0


def test_deposits_hist_plain_is_masked_histogram_of_b1():
    fr, scal, kw = _frames_case(32768, 48000, 2, seed=5)
    S = (2 * kw["reach"] + 1) * kw["rows"]
    ids, contrib = deposits_ids_plain(fr, *scal, **kw)
    full = deposits_hist_plain(fr, *scal, -2**30, **kw)
    torch.testing.assert_close(full, histogram_plain(ids, contrib, S),
                               rtol=0, atol=0)
    masked = deposits_hist_plain(fr, *scal, S // 2, **kw)
    assert float(masked[:, :S // 2].abs().max()) == 0.0
    torch.testing.assert_close(masked[:, S // 2:], full[:, S // 2:],
                               rtol=0, atol=0)


def test_new_wrappers_route_cpu_to_plain_without_launching():
    before = (deposits_ids.launches, deposits_ids_large.launches,
              deposits_hist.launches, hist_variant.launches)
    fr, scal, kw = _frames_case(32768, 48000, 2, seed=1)
    got = deposits_ids_large(fr, *scal, **kw)
    want = deposits_ids_plain(fr, *scal, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(deposits_ids(fr, *scal, **kw),
                                                 want))
    deposits_hist(fr, *scal, 0, **kw)
    hist_variant(torch.zeros(2, 9, dtype=torch.int32), torch.ones(2, 9), 5,
                 "full")
    assert (deposits_ids.launches, deposits_ids_large.launches,
            deposits_hist.launches, hist_variant.launches) == before


def test_new_wrappers_raise_on_other_devices():
    meta = torch.empty(2, 32768, device="meta")
    s = torch.empty((), device="meta")
    kw = dict(n=32768, hop=8192, sr=48000.0, rows=64, reach=2)
    with pytest.raises(ValueError, match="deposits_ids_large"):
        deposits_ids_large(meta, s, s, s, **kw)
    with pytest.raises(ValueError, match="deposits_hist"):
        deposits_hist(meta, s, s, s, 0, **kw)
    with pytest.raises(ValueError, match="hist_variant"):
        hist_variant(torch.empty(2, 3, dtype=torch.int32, device="meta"),
                     torch.empty(2, 3, device="meta"), 4, "io_only")
    with pytest.raises(ValueError, match="variant"):
        hist_variant(torch.zeros(2, 3, dtype=torch.int32), torch.ones(2, 3),
                     4, "no_gemm")


# ----------------------------------------------------------------- the probe
# (b, m, S) that B2's route_of sends to each route
PROBE_SHAPES = {"row": (264, 37, 50), "global": (9, 1300, 700)}


def _probe_case(b=9, m=1300, S=700, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-5, S + 5, (b, m)).astype(np.int32)
    ids[rng.random((b, m)) < 0.5] = -1
    vals = rng.random((b, m)).astype(np.float32)
    vals[ids < 0] = np.nan                  # never read behind a dropped id
    return ids, vals, S


def _consume_threads(n, head, vec, threads):
    """``consume``'s thread for each element of a range of n: 16-byte
    path — the head (up to the 16-byte boundary) to lanes 0–2, vector j
    to thread j mod T, the tail to lanes 4–6; 4-byte path — element j to
    thread j mod T."""
    j = np.arange(n)
    if not vec:
        return j % threads
    head = min(n, head)
    t0 = head + 4 * ((n - head) // 4)
    return np.where(j < head, j, np.where(j < t0, (j - head) // 4 % threads,
                                          4 + j - t0))


def _probe_numpy(ids, vals, S, variant, a0=0, vec=True):
    b, m = ids.shape
    ok = (ids >= 0) & (ids < S)
    h = np.zeros((b, S), np.float64)
    hit = np.zeros((b, S), bool)
    for r in range(b):
        np.add.at(h[r], ids[r][ok[r]], vals[r][ok[r]])
        hit[r, ids[r][ok[r] & (vals[r] >= 0)]] = True
    if variant in ("full", "no_merge"):
        return h
    if variant == "no_atomic":
        return hit.astype(np.float64)
    if variant == "no_zero":
        return np.concatenate([np.cumsum(h[g:g + NO_ZERO_ROWS], 0)
                               for g in range(0, b, NO_ZERO_ROWS)])
    v = np.where(ok, vals, 0.0)
    if route_of(b, m, S) == "global":       # one range: the flat stream
        threads = global_blocks(b, m) * GLOBAL_THREADS
        s = np.zeros(threads)
        np.add.at(s, _consume_threads(b * m, (4 - a0) & 3, vec, threads),
                  v.reshape(-1))
        return s[np.arange(b * S) % threads].reshape(b, S)
    out = np.zeros((b, S))
    for r in range(b):                      # a block a row
        s = np.zeros(ROW_THREADS)
        np.add.at(s, _consume_threads(m, (4 - (a0 + r * m)) & 3, vec,
                                      ROW_THREADS), v[r])
        out[r] = s[np.arange(S) % ROW_THREADS]
    return out


@pytest.mark.parametrize("route", sorted(PROBE_SHAPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_probe_variant_plain_matches_numpy(variant, route):
    ids, vals, S = _probe_case(*PROBE_SHAPES[route])
    assert route_of(*ids.shape, S) == route
    a0, vec = alignment(*map(torch.from_numpy, (ids, vals)))
    got = hist_variant_plain(torch.from_numpy(ids), torch.from_numpy(vals), S,
                             variant, a0=a0, vec=vec).numpy()
    want = _probe_numpy(ids, vals, S, variant, a0, vec)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", sorted(PROBE_SHAPES))
@pytest.mark.parametrize("a0,vec", [(0, True), (1, True), (2, True),
                                    (3, True), (1, False)])
def test_probe_io_only_lane_map_at_every_alignment(route, a0, vec):
    """io_only's thread map follows the 16-byte vector map from every
    start alignment of the ids (and the 4-byte map where ids and vals are
    aligned apart)."""
    ids, vals, S = _probe_case(*PROBE_SHAPES[route], seed=a0 + 3)
    got = hist_variant_plain(torch.from_numpy(ids), torch.from_numpy(vals), S,
                             "io_only", a0=a0, vec=vec).numpy()
    want = _probe_numpy(ids, vals, S, "io_only", a0, vec)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if vec and a0:                           # the map moves with the head
        other = _probe_numpy(ids, vals, S, "io_only", 0, True)
        assert not np.allclose(want, other)


@pytest.mark.parametrize("route", sorted(PROBE_SHAPES))
def test_probe_full_and_no_merge_equal_histogram_plain(route):
    ids, vals, S = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in _probe_case(*PROBE_SHAPES[route], seed=2))
    want = histogram_plain(ids, vals, S)
    for variant in ("full", "no_merge"):
        assert torch.equal(hist_variant_plain(ids, vals, S, variant), want)
        assert torch.equal(hist_variant(ids, vals, S, variant), want)


def test_probe_no_zero_is_refused_on_the_global_route():
    ids, vals, S = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                    for a in _probe_case(*PROBE_SHAPES["global"]))
    with pytest.raises(ValueError, match="row-route variant"):
        hist_variant(ids, vals, S, "no_zero")
    rows = torch.from_numpy(_probe_case(*PROBE_SHAPES["row"])[0])
    assert hist_variant(rows, torch.ones(rows.shape), 50,
                        "no_zero").shape == (264, 50)


def test_kernels_share_histogram_common():
    """B2, B6 and the probe include one copy of the warp merge; none
    defines it (or the sinks and the range walk) itself."""
    csrc = Path(__file__).resolve().parents[1] / "emspec_torch" / "csrc"
    common = (csrc / "histogram_common.cuh").read_text()
    defs = (r"void\s+warp_add\s*\(", r"bool\s+reduce_peers\s*\(",
            r"struct\s+Sink\b", r"void\s+consume\s*\(",
            r"unsigned\s+bucket_bit\s*\(")
    for d in defs:
        assert re.search(d, common), d
    for name in ("histogram.cu", "deposits.cu", "scatter_ablation.cu"):
        src = (csrc / name).read_text()
        assert '#include "histogram_common.cuh"' in src, name
        assert "warp_add" in src, name
        for d in defs:
            assert not re.search(d, src), (name, d)
