"""A seeded settings fuzz of the port on the CPU, against itself and the
JAX package: the draws of ``emspec_torch.probes.settings_fuzz`` (the
card's fuzz, ``chip_smoke.py``'s ``fuzz`` phase), limited to banks of at
most 8192 points and 1–3 channels — both modes, one to three banks (256
included), rasters of 2–4,096 rows, hops 16 … 2·n_max (past the largest
frame too) or auto, 8–192 kHz, zoom 0.02–100, smoothing to 0.99, every
scatter setting, engine and method.  For each draw, on one intra-op
thread:

* the port's ``Stream`` in 777-sample pushes ≡ its batch, bit for bit in
  ``vis`` and ``rgba``;
* the port's batch ``vis`` within ``compare_vis`` of the JAX package's
  batch (the JAX ``Stream`` differs from its own batch past the largest
  frame, so the batch is the reference; under ``scatter="pallas"`` the
  JAX side sums by ``"segment_sum"``: its Pallas kernel runs on a TPU or
  in interpret mode, and the JAX package holds the two backends to one
  sum), at every third draw (``JAX_SEEDS``): each JAX batch compiles its
  own program, 1.5–16 s a draw under the suite's six workers, and the
  file keeps within a minute of one worker;
* the draw's signal with NaN/±Inf samples gives finite ``vis`` in [0, 1].
"""

import functools

import numpy as np
import pytest
import torch

from emspec.config import Settings as JaxSettings
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.convert import params_from_jax
from emspec_torch.pipeline import Pipeline
from emspec_torch.probes.settings_fuzz import case_of
from emspec_torch.stream import Stream
from emspec_torch.validate import compare_vis

SEEDS = range(24)
JAX_SEEDS = SEEDS[::3]
MAX_SIZE = 8192
MAX_CHANNELS = 3
PUSH = 777


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _case(seed: int):
    s, x, bad, _, _ = case_of(seed, MAX_SIZE, MAX_CHANNELS)
    return s, x, bad


@functools.lru_cache(maxsize=None)
def _batch(seed: int):
    s, x, _ = _case(seed)
    vis, rgba, _ = Pipeline(s, "cpu").process(x)
    return vis, rgba


def _nonfinite(x: np.ndarray, seed: int) -> np.ndarray:
    """``x`` with NaN, +Inf and −Inf at 6 samples of each channel."""
    rng = np.random.default_rng(10_000 + seed)
    y = np.array(x, copy=True)
    for row in y.reshape(-1, y.shape[-1]):
        at = rng.choice(row.size, size=6, replace=False)
        row[at] = [np.nan, np.inf, -np.inf] * 2
    return y


@pytest.mark.parametrize("seed", SEEDS)
def test_the_stream_in_pushes_is_the_batch(seed):
    s, x, _ = _case(seed)
    vis, rgba = _batch(seed)
    st = Stream(s, "cpu")
    cols = []
    for i in range(0, x.shape[-1], PUSH):
        cols += st.push(x[..., i:i + PUSH])
    cols += st.flush()
    assert st.dropped_frames == 0, s
    assert [c.index for c in cols] == list(range(vis.shape[0])), s
    assert torch.equal(torch.stack([c.vis for c in cols]), vis), s
    assert torch.equal(torch.stack([c.rgba for c in cols]), rgba), s


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_the_batch_is_the_jax_batch(seed):
    s, x, _ = _case(seed)
    kw = s.to_dict()
    if kw["scatter"] == "pallas":
        kw["scatter"] = "segment_sum"
    jp = JaxPipeline(JaxSettings.from_dict(kw))
    jparams = jp.params()
    vis_j, _, _ = jp.process(x, jparams)
    vis_j = torch.from_numpy(np.array(vis_j))
    vis = Pipeline(s, "cpu").process(x, params_from_jax(jparams, "cpu"))[0]
    assert vis.shape == vis_j.shape, s
    ok, worst, share = compare_vis(vis_j, vis)
    assert ok, (s, worst, share)


@pytest.mark.parametrize("seed", SEEDS)
def test_nonfinite_input_gives_finite_vis_in_0_1(seed):
    s, x, bad = _case(seed)
    y = x if bad else _nonfinite(x, seed)
    assert not np.isfinite(y).all()
    vis, rgba, state = Pipeline(s, "cpu").process(y)
    assert bool(torch.isfinite(vis).all()), s
    assert float(vis.min()) >= 0.0 and float(vis.max()) <= 1.0, s
    assert rgba.dtype == torch.uint8
    assert bool(torch.isfinite(state.agc_ref).all()), s
