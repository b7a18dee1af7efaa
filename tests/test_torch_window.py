"""Kernel B5 (fused triple windowing): its plain version bit-equal to the
JAX package's Pallas kernel in interpret mode (``atol=0``, as
``tests/test_pallas.py:255`` demands of the TPU kernel) and device
routing (the kernel itself, on a card: ``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from emspec.dsp.pallas.window import windowed_frames as jax_windowed_frames
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.dsp.kernels.window import (
    windowed_frames, windowed_frames_plain)


@pytest.mark.parametrize("shape", [(7, 512), (2, 5, 512), (90, 2048), (512,)])
def test_windowed_frames_plain_bit_equal_to_pallas(shape):
    frames = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_windowed_frames(jnp.asarray(frames),
                                              t_tile=16, n_tile=512))
    got = windowed_frames(torch.from_numpy(frames)).numpy()
    assert got.shape == (3,) + shape
    np.testing.assert_allclose(got, want, atol=0, rtol=0)


def test_strided_framing_view_and_routing():
    """The framing view goes in as it is; the CPU launches nothing."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 6000)).astype(np.float32))
    fr = frame_signal(x, 1024, 256)
    before = windowed_frames.launches
    got = windowed_frames(fr)
    assert windowed_frames.launches == before
    assert torch.equal(got, windowed_frames_plain(fr.contiguous()))
    with pytest.raises(ValueError, match="windowed_frames"):
        windowed_frames(torch.empty(3, 512, device="meta"))
