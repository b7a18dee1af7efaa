"""Kernel B3's float32 form (``lut_values``: display values → RGBA in one
pass, the whole of ``apply_lut``) on the CPU: its plain version against
the JAX package's ``apply_lut``, and the kernel's quantization and its
head/vector/tail schedule mirrored in numpy.

Every comparison is bit for bit.  The values probe the rounding: k/255
and the ties (k + 0.5)/255 for every k, 0 and 1, values outside [0, 1],
and, for the port alone, NaN and ±Inf (the JAX package's int cast of a
non-finite value is left to XLA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emspec.post import colormap as jcolormap
from emspec_torch.dsp.kernels.lut import (
    BLOCKS_PER_SM, THREADS, launch_shape, lut_lookup_plain, lut_values,
    lut_values_plain)
from emspec_torch.post.colormap import apply_lut
from emspec_torch.tables import lut

CMAPS = ["inferno", "magma", "viridis", "turbo", "grayscale"]
H100_SMS = 132


def _values(seed: int) -> np.ndarray:
    k = np.arange(256, dtype=np.float32)
    edges = np.array([0.0, 1.0, -0.0, 1e-7, -1e-7, 1.0 + 1e-7, 0.5 / 255,
                      254.5 / 255, 255.5 / 255, -0.5 / 255, -0.5, 1.5, 2.0,
                      -3.0, 1e6, -1e6], np.float32)
    rng = np.random.default_rng(seed)
    return np.concatenate([k / 255, (k + 0.5) / 255, edges,
                           rng.uniform(-0.2, 1.2, 4080)]).astype(np.float32)


def _kernel_index(v: np.ndarray) -> np.ndarray:
    """``lut.cu``'s ``lut_index(float)``: r = rint(v·255) in float32 (one
    IEEE multiply, half to even), 255 if r ≥ 255, r if r > 0, else 0 (a
    NaN fails both tests)."""
    with np.errstate(invalid="ignore", over="ignore"):
        r = np.rint(v.astype(np.float32) * np.float32(255.0))
        return np.where(r >= 255, 255, np.where(r > 0, r, 0)).astype(np.int64)


@pytest.mark.parametrize("cmap", CMAPS)
def test_fused_plain_bit_equal_to_jax_apply_lut(cmap):
    vals = _values(3).reshape(9, 512)
    table = jcolormap.lut(cmap)
    want = np.asarray(jcolormap.apply_lut(jnp.asarray(vals),
                                          jnp.asarray(table)))
    got = lut_values_plain(torch.from_numpy(vals),
                           torch.from_numpy(table.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        apply_lut(torch.from_numpy(vals), torch.from_numpy(table.copy())
                  ).numpy(), want)


def test_fused_plain_maps_nan_and_inf():
    table = torch.from_numpy(lut("turbo").copy())
    vals = torch.tensor([np.nan, -np.nan, np.inf, -np.inf, 0.5],
                        dtype=torch.float32)
    got = lut_values_plain(vals, table)
    assert torch.equal(got[:2], table[[0, 0]])
    assert torch.equal(got[2], table[255]) and torch.equal(got[3], table[0])
    assert torch.equal(got[4], table[128])


def test_fused_plain_equals_index_then_lookup():
    """Where the int32 index fits, the fused plain version is the earlier
    two-step ``apply_lut``: index by round/cast/clip, then ``table[idx]``."""
    vals = torch.from_numpy(_values(5))
    table = torch.from_numpy(lut("inferno").copy())
    idx = torch.clamp(torch.round(vals * 255).to(torch.int32), 0, 255)
    assert torch.equal(lut_values_plain(vals, table),
                       lut_lookup_plain(idx, table))


def test_kernel_quantization_mirror_matches_plain():
    vals = np.concatenate([_values(7), np.array(
        [np.nan, np.inf, -np.inf, 3e38, -3e38], np.float32)])
    table = torch.arange(1024, dtype=torch.int32).to(torch.uint8).reshape(
        256, 4)
    got = table[torch.from_numpy(_kernel_index(vals))]
    assert torch.equal(got, lut_values_plain(torch.from_numpy(vals), table))


@pytest.mark.parametrize("a0", [0, 1, 2, 3])
@pytest.mark.parametrize("npix", [0, 1, 2, 3, 4, 5, 7, 8, 9, 512, 1021,
                                  8192 + 3, 372 * 512, 5952 * 512 + 1])
def test_kernel_schedule_writes_each_pixel_once(npix, a0):
    """``lut.cu``'s loops over the wrapper's (head, blocks): the head's
    threads, each thread's 16-byte vectors of the grid-stride loop and the
    tail's threads write every pixel exactly once, and every vector sits
    on a 16-byte boundary of input and output (both ``a0`` words past
    one)."""
    head, blocks = launch_shape(npix, a0, H100_SMS)
    assert 0 <= head <= min(3, npix)
    assert 1 <= blocks <= BLOCKS_PER_SM * H100_SMS
    if npix == 0:
        return
    threads = blocks * THREADS
    hits = np.zeros(npix, np.int64)
    hits[:head] += 1                         # tid < head
    nvec = (npix - head) >> 2
    assert (a0 + head) % 4 == 0 or npix - head < 4
    tid = np.arange(threads)
    steps = -(-nvec // threads) if nvec else 0
    for s in range(steps):                   # v = tid, tid + stride, …
        v = tid + s * threads
        v = v[v < nvec]
        for lane in range(4):
            np.add.at(hits, head + 4 * v + lane, 1)
    tail = head + 4 * nvec
    assert npix - tail <= 3
    hits[tail:] += 1                         # tid < npix − tail
    np.testing.assert_array_equal(hits, 1)


def test_apply_lut_on_cpu_never_launches():
    before = lut_values.launches
    vals = torch.from_numpy(_values(9))[1:]            # an offset view
    table = torch.from_numpy(lut("magma").copy())
    assert torch.equal(apply_lut(vals, table),
                       lut_values_plain(vals.contiguous(), table))
    assert lut_values.launches == before


def test_lut_values_raises_on_other_devices():
    with pytest.raises(ValueError, match="lut_values"):
        lut_values(torch.empty(3, device="meta"),
                   torch.empty(256, 4, dtype=torch.uint8, device="meta"))
