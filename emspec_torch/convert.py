"""Carry parameters and state across from the JAX package.

Each function takes the JAX object (any array leaves: JAX arrays or
numpy) and returns the port's counterpart, so both packages compute the
same thing from the same state.  Nothing here imports JAX: leaves are
read through ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from emspec_torch.pipeline import PipelineParams
from emspec_torch.post.chain import PostParams, PostState


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def post_params_from_jax(post, device) -> PostParams:
    return PostParams(*(_t(leaf, device, np.float32) for leaf in post))


def post_state_from_jax(state, device) -> PostState:
    return PostState(smooth=_t(state.smooth, device, np.float32),
                     agc_ref=_t(state.agc_ref, device, np.float32))


def params_from_jax(params, device) -> PipelineParams:
    """``emspec.pipeline.PipelineParams`` → the port's, merge tables and
    band weights included (one tensor per bank each)."""
    per_bank = lambda leaves, dtype: tuple(_t(v, device, dtype)
                                           for v in leaves)
    return PipelineParams(
        post=post_params_from_jax(params.post, device),
        lut=_t(params.lut, device, np.uint8),
        logmap_a=_t(params.logmap_a, device, np.float32),
        logmap_b=_t(params.logmap_b, device, np.float32),
        power_floor=_t(params.power_floor, device, np.float32),
        i0=per_bank(params.i0, np.int32),
        w0=per_bank(params.w0, np.float32),
        band_rows=per_bank(params.band_rows, np.float32),
        band_bins=per_bank(params.band_bins, np.float32),
    )


def stream_state_from_jax(state) -> dict:
    """``emspec.stream.Stream.state_pytree()`` → the host-numpy layout of
    ``emspec_torch.stream.Stream.state_dict`` (feed it to ``load_state``)."""
    window, (t, acc, post) = state["carry"]
    f32 = lambda a: np.array(a, np.float32)
    return {
        "carry": (f32(window),
                  (np.int32(np.asarray(t)), f32(acc),
                   PostState(smooth=f32(post.smooth),
                             agc_ref=f32(post.agc_ref)))),
        "t": int(state["t"]),
        "next_frame": int(state["next_frame"]),
    }
