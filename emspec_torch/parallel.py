"""Channel and time sharding over ``torch.distributed`` (``emspec.parallel``).

One process a device.  A mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the ranks of the default group: 1-D with one axis
(``"ch"`` by default, ``"t"`` for the time renderer) or 2-D (``"ch"``,
``"t"``) with ``"ch"`` the major axis.  Without a group, the first mesh
creates one of world size 1 on a local store (NCCL on the card, gloo on
the CPU), so one process runs every sharded path, as the JAX package does
on one device; under ``torchrun`` the group comes from the environment
and each rank's card is ``cuda:{LOCAL_RANK}``.

Every rank is given the whole input, as JAX is given host input, and
keeps its own shard.  The collectives are the JAX package's, and only
those (``COLLECTIVES`` counts each call, for the census):

* ``ShardedPipeline.process`` and ``ShardedStream.step``: none, or with
  ``agc_global`` one ``all_reduce_max`` of the per-column peak over
  ``"ch"`` a call or a hop;
* ``TimeParallelRenderer.render``: two ``all_gather``s of the chunk
  finals over ``"t"`` (one for each EMA), one ``broadcast`` of the final post
  state from the rank that owns the last column (the JAX package's masked
  ``psum``), and on a 2-D mesh with ``agc_global`` one ``all_reduce_max``
  over ``"ch"``.

The deposits that cross a time chunk's edges are recomputed from halo
frames, never sent.  Gathering a stream's state for a checkpoint, and a
render's chunks for an image (``TimeParallelRenderer.gather``), are
collectives of their own, outside those calls.

>>> mesh = channel_mesh()                     # every rank of the group
>>> sp = ShardedPipeline(settings, mesh)      # channels % ranks == 0
>>> vis, rgba, state = sp.process(x)          # this rank's channel shard
"""

from __future__ import annotations

import os
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from emspec_torch.config import MODE_ENHANCED, Settings
from emspec_torch.device import as_device
from emspec_torch.pipeline import Pipeline, get_pipeline
from emspec_torch.post.chain import PostState, postprocess_batch_timeshard
from emspec_torch.post.colormap import apply_lut
from emspec_torch.stream import _copy_into

COLLECTIVES: Counter = Counter()    # collective → calls in this process
PLANS = 8                           # per-length plans a renderer keeps


def _rank_device(device) -> torch.device:
    """``"cuda"`` → this rank's card (``LOCAL_RANK``, 0 alone)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return as_device(d)


def init_group(device="cuda") -> bool:
    """Make sure a default process group exists: from the environment
    under ``torchrun``, else world size 1 on a local ``HashStore``.
    NCCL for the card, gloo for the CPU.  True when this call created it."""
    if dist.is_initialized():
        return False
    dev = _rank_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def _ranks(devices) -> list:
    return (list(range(dist.get_world_size())) if devices is None
            else [int(r) for r in devices])


def channel_mesh(devices=None, axis: str = "ch", device="cuda"):
    """1-D mesh over the given ranks (default: every rank of the group;
    every rank of the group makes the same call)."""
    from torch.distributed.device_mesh import DeviceMesh
    init_group(device)
    return DeviceMesh(_rank_device(device).type, _ranks(devices),
                      mesh_dim_names=(axis,))


def ch_time_mesh(n_ch: int, devices=None, device="cuda"):
    """2-D (ch × t) mesh: ``n_ch`` channel shards × (ranks/n_ch) time
    shards, "ch" the major axis (consecutive ranks hold the same channels
    at consecutive times)."""
    from torch.distributed.device_mesh import DeviceMesh
    init_group(device)
    ranks = _ranks(devices)
    if len(ranks) % n_ch:
        raise ValueError(f"{len(ranks)} devices not divisible by "
                         f"n_ch={n_ch}")
    return DeviceMesh(_rank_device(device).type,
                      torch.tensor(ranks).reshape(n_ch, -1),
                      mesh_dim_names=("ch", "t"))


class MeshAxis:
    """One axis of a mesh as this rank sees it: its coordinate on the axis
    (``index``), the axis's ``size``, and the counted collectives over its
    group."""

    def __init__(self, mesh, name: str):
        self.name = name
        self.group = mesh.get_group(name)
        self.index = mesh.get_local_rank(name)
        self.size = mesh.size(mesh.mesh_dim_names.index(name))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(...) on each rank → (size, ...) in axis order."""
        COLLECTIVES["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        COLLECTIVES["all_reduce_max"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of the rank at coordinate ``src`` into every rank's."""
        COLLECTIVES["broadcast"] += 1
        dist.broadcast(t, src=dist.get_global_rank(self.group, src),
                       group=self.group)
        return t


class _ChannelShards:
    """This rank's ``channels / n`` channels of a 1-D mesh: the first
    ``lo`` … ``lo + local``."""

    def __init__(self, settings: Settings, mesh):
        if settings.channels % mesh.size() != 0:
            raise ValueError(
                f"channels ({settings.channels}) must be divisible by the "
                f"mesh size ({mesh.size()})")
        self.mesh = mesh
        self.axis = MeshAxis(mesh, mesh.mesh_dim_names[0])
        self.device = _rank_device(mesh.device_type)
        self.pipe: Pipeline = get_pipeline(settings, self.device)
        self.settings = settings
        self.local = settings.channels // mesh.size()
        self.lo = self.axis.index * self.local

    def _shard(self, a):
        return a[self.lo:self.lo + self.local]

    def _agc_reduce(self):
        """The global AGC's peak across the channel shards, or None."""
        return self.axis.all_reduce_max if self.settings.agc_global else None


class ShardedPipeline(_ChannelShards):
    """Channel-sharded batch processing: each rank processes its
    ``channels / n`` channels; params are replicated."""

    def init_state(self) -> PostState:
        return PostState.init((self.local, self.pipe.rows), self.device)

    def process(self, x, params=None, state=None):
        """x: the whole (channels, samples) → this rank's (vis (t, ch/n,
        rows), rgba (t, ch/n, rows, 4), PostState (ch/n, ...))."""
        t_count = self.pipe.num_columns(x.shape[-1])
        if t_count <= 0:
            raise ValueError(f"need at least {self.pipe.n_max} samples")
        xd = self.pipe.to_device(self._shard(x))
        p = params or self.pipe.params(self.settings)
        st = state if state is not None else self.init_state()
        return self.pipe._batch_vis(xd, p, st, t_count,
                                    peak_reduce=self._agc_reduce())


class ShardedStream(_ChannelShards):
    """Channel-sharded streaming: the per-hop rolling step
    (``Pipeline._stream_step_rolling``) on this rank's channels, its
    carry (window, hop counter, pending ring, post state) the rank's
    shard.  The step reads no host value.

    Feed protocol (``emspec.parallel.ShardedStream``):
    ``reset_window(x[:, :n_max])`` primes the window for hop 0, then
    ``step(x[:, t*hop + n_max - roll : t*hop + n_max])`` a hop, ``roll``
    = ``pipe.roll`` = min(hop, n_max) new samples; at flush
    ``reset_window(None)`` zeroes the window and zero blocks drain the
    pending ring.  ``stream_signal_sharded`` packages it."""

    def __init__(self, settings: Settings, mesh, params=None):
        super().__init__(settings, mesh)
        self._carry = self.pipe.init_roll_carry((self.local,))
        self.params = params or self.pipe.params(settings)
        self._t = 0
        self.needs_window_prime = False

    def reset_window(self, window) -> None:
        """(Re)prime the rolling window: ``window`` is hop 0's whole
        (channels, n_max) samples, whose completing block
        ``window[:, n_max-roll:]`` the next ``step`` must bring, or None
        (zeros, for the flush hops)."""
        roll, n_max = self.pipe.roll, self.pipe.n_max
        w = self._carry[0]
        w.zero_()
        if window is not None:
            w[..., roll:].copy_(self.pipe.to_device(
                self._shard(window)[..., :n_max - roll]))
        self.needs_window_prime = False

    def step(self, block):
        """One hop: the whole (channels, roll) new samples → None while
        warming up (the first ``reach`` hops), else (index, vis (ch/n,
        rows), rgba) of this rank's channels."""
        if self.needs_window_prime:
            # set by the migration of a pre-rolling-window snapshot: the
            # window is zeros and cannot continue the roll
            raise RuntimeError(
                "this stream was restored from a pre-rolling-window "
                "snapshot: call reset_window(window_at_resume_point) "
                "before the next step")
        blk = self.pipe.to_device(self._shard(block))
        self._carry, (vis, rgba, _) = self.pipe._stream_step_rolling(
            self._carry, blk, self.params, self._agc_reduce())
        idx = self._t - self.pipe.reach
        self._t += 1
        return None if idx < 0 else (idx, vis, rgba)

    # ----------------------------------------------------- checkpoint/resume
    def state_dict(self) -> dict:
        """The whole stream's state as host numpy, every channel gathered
        (the layout of ``emspec.parallel.ShardedStream.state_pytree``), so
        it loads onto any number of ranks that divides the channels."""
        window, (t, acc, post) = self._carry
        g = self.axis.all_gather
        whole = lambda a, dim: torch.cat(list(g(a)), dim=dim).cpu().numpy()
        carry = (whole(window, 0),
                 (np.int32(t.item()), whole(acc, 1),
                  PostState(smooth=whole(post.smooth, 0),
                            agc_ref=whole(post.agc_ref, 0))))
        return {"carry": carry, "t": self._t}

    def load_state(self, state) -> None:
        """Resume from :meth:`state_dict` of a stream on any number of
        ranks (the channels must match), taking this rank's shard."""
        window, (t, acc, post) = state["carry"]
        sl = slice(self.lo, self.lo + self.local)
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
        _copy_into(self._carry,
                   (f32(window[sl]),
                    (torch.tensor(np.int32(t)), f32(acc[:, sl]),
                     (f32(post.smooth[sl]), f32(post.agc_ref[sl])))),
                   "load_state")
        self._t = int(state["t"])


class _Plan(NamedTuple):
    """What a render of ``t_count`` columns needs on this rank."""
    L: int                  # columns a time chunk
    slice_len: int          # samples a chunk analyses, halo included
    valid: int              # the chunk's columns inside [0, t_count)
    frame_valid: torch.Tensor   # (L + 2R,) 1 where a frame is the signal's


class TimeParallelRenderer:
    """Offline batch rendering sharded over time: rank ``d`` of the
    ``"t"`` axis renders columns [d·L, (d+1)·L).

    * Reassignment reach: a column receives deposits from frames up to R
      away, so each rank analyses its L frames plus R halo frames on each
      side, from the zero-padded signal every rank holds, and keeps its L
      columns: the deposits that cross a chunk edge are recomputed by
      both neighbours, never sent.  Halo frames outside the signal's frame
      range are masked (``Pipeline._enhanced_power(frame_valid=)``).  The
      chunk's grid sums each cell in (frame, bin) order (B2's sorted
      route on the card), so a render is the same on every run, as
      ``Pipeline.process``'s is.
    * The post chain's two EMAs: ``post.chain.postprocess_batch_timeshard``
      (the chunk scans on the ``ema_scan`` kernel on the card, one gather
      each, the affine re-base).

    A 2-D mesh with a ``"t"`` axis shards channels over the other axis
    too; the global AGC then takes one ``all_reduce_max`` over it.
    ``render`` returns this rank's chunk; ``gather`` assembles the whole
    result.  Tolerance against ``Pipeline.process``: the EMA re-base's
    reassociation (~1e-6)."""

    def __init__(self, settings: Settings, mesh, params=None):
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        if len(names) == 1:
            t_name, ch_name = names[0], None
        elif len(names) == 2:
            if "t" not in names:
                raise ValueError(
                    f"a 2-D TimeParallelRenderer mesh needs an axis "
                    f"named 't' (time); got {names}")
            t_name = "t"
            ch_name = next(a for a in names if a != "t")
            n_ch = mesh.size(names.index(ch_name))
            if settings.channels % n_ch != 0:
                raise ValueError(
                    f"channels ({settings.channels}) must be divisible "
                    f"by the mesh's {ch_name!r} axis ({n_ch})")
        else:
            raise ValueError(f"mesh must be 1-D (time) or 2-D (ch × "
                             f"time); got axes {names}")
        self.axis = MeshAxis(mesh, t_name)
        self.ch_axis = None if ch_name is None else MeshAxis(mesh, ch_name)
        self.device = _rank_device(mesh.device_type)
        self.pipe: Pipeline = get_pipeline(settings, self.device)
        self.settings = settings
        self.params = params or self.pipe.params(settings)
        self._plans: dict = {}

    def _plan(self, t_count: int) -> _Plan:
        """The plan of a length, kept FIFO for the last ``PLANS`` lengths
        (a folder of files of many lengths keeps no more)."""
        if t_count not in self._plans:
            while len(self._plans) >= PLANS:
                self._plans.pop(next(iter(self._plans)))
            pipe, d, n = self.pipe, self.axis.index, self.axis.size
            L = -(-t_count // n)
            R = pipe.reach
            g = torch.arange(L + 2 * R, device=self.device) + (d * L - R)
            self._plans[t_count] = _Plan(
                L=L, slice_len=(L + 2 * R - 1) * pipe.hop + pipe.n_max,
                valid=min(max(t_count - d * L, 0), L),
                frame_valid=((g >= 0) & (g < t_count)).to(torch.float32))
        return self._plans[t_count]

    def render(self, x, state: PostState | None = None):
        """x: the whole (samples,) or (channels, samples) → this rank's
        (vis (l, ..., rows), rgba (l, ..., rows, 4), final PostState),
        l ≤ L the chunk's columns inside the signal; the final state (the
        one after the last column, on every rank of the time axis) covers
        this rank's channels.  ``state``: the initial state of every
        channel (default: a fresh one)."""
        x = np.asarray(x, np.float32)
        pipe = self.pipe
        t_count = pipe.num_columns(x.shape[-1])
        if t_count <= 0:
            raise ValueError(f"need at least {pipe.n_max} samples")
        ch = self.ch_axis
        if ch is not None and (x.ndim != 2 or x.shape[0] % ch.size):
            raise ValueError(
                f"a (ch × t) mesh needs (channels, samples) input with "
                f"channels divisible by the {ch.name!r} axis "
                f"({ch.size}); got {x.shape}")
        plan = self._plan(t_count)
        L, R, hop = plan.L, pipe.reach, pipe.hop
        d = self.axis.index
        mine = lambda a: a                       # this rank's channels
        if ch is not None:
            width = x.shape[0] // ch.size
            mine = lambda a: a[ch.index * width:(ch.index + 1) * width]
        # this rank's slice of the signal padded with R·hop zeros on the
        # left (the first chunk's halo) and zeros past its end: samples
        # [d·L·hop − R·hop, … + slice_len) of x, zeros outside it, padded
        # on the device (only the samples cross from the host)
        start = (d * L - R) * hop
        xm = mine(x)
        xd = torch.zeros(xm.shape[:-1] + (plan.slice_len,),
                         dtype=torch.float32, device=self.device)
        lo, hi = max(start, 0), min(start + plan.slice_len, x.shape[-1])
        if hi > lo:
            xd[..., lo - start:hi - start] = pipe.to_device(xm[..., lo:hi])
        if state is None:
            st0 = PostState.init(xd.shape[:-1] + (pipe.rows,), self.device)
        else:
            st0 = PostState(*(mine(torch.as_tensor(a)).to(self.device)
                              for a in state))
        t_local = L + 2 * R
        p = self.params
        power = (pipe._enhanced_power(xd, t_local, p, plan.frame_valid)
                 if self.settings.mode == MODE_ENHANCED
                 else pipe._natural_power(xd, t_local, p))
        power = power.movedim(-2, 0)[R:R + L].contiguous()
        vis, st = postprocess_batch_timeshard(
            power, st0, p.post, self.axis, self.settings.agc_global,
            valid_count=plan.valid, ch_axis=ch)
        rgba = apply_lut(vis, p.lut)
        # the final state is the carry-out of the chunk holding column
        # t_count − 1, sent from its rank over the time axis
        k = st.smooth.numel()
        buf = torch.cat([st.smooth.reshape(-1), st.agc_ref.reshape(-1)])
        self.axis.broadcast(buf, (t_count - 1) // L)
        final = PostState(smooth=buf[:k].reshape(st.smooth.shape),
                          agc_ref=buf[k:].reshape(st.agc_ref.shape))
        return vis[:plan.valid], rgba[:plan.valid], final

    def gather(self, a: torch.Tensor, t_count: int) -> torch.Tensor:
        """This rank's chunk of a ``render`` output → the whole (t_count,
        ..., rows[, 4]) result, every channel, on every rank."""
        L = -(-t_count // self.axis.size)
        chunk = a.new_zeros((L,) + tuple(a.shape[1:]))
        chunk[:a.shape[0]] = a
        parts = self.axis.all_gather(chunk)
        whole = parts.reshape((-1,) + tuple(a.shape[1:]))[:t_count]
        if self.ch_axis is not None:
            whole = torch.cat(list(self.ch_axis.all_gather(whole)), dim=1)
        return whole


def stream_signal_sharded(x, settings: Settings, mesh):
    """Hop-by-hop sharded streaming of a whole (channels, samples) signal
    → (vis (t, channels, rows), rgba) host arrays of every channel
    (``emspec.parallel.stream_signal_sharded``; zero flush hops drain the
    pending ring)."""
    st = ShardedStream(settings, mesh)
    pipe = st.pipe
    x = np.asarray(x, np.float32)
    t_count = pipe.num_columns(x.shape[-1])
    if t_count <= 0:
        raise ValueError(f"need at least {pipe.n_max} samples")
    cols = []
    n_max, hop, roll = pipe.n_max, pipe.hop, pipe.roll
    zero_block = np.zeros((settings.channels, roll), np.float32)
    st.reset_window(x[..., :n_max])              # prime for hop 0
    for t in range(t_count + pipe.reach):
        if t < t_count:
            block = x[..., t * hop + n_max - roll: t * hop + n_max]
        else:
            if t == t_count:
                st.reset_window(None)            # flush: all-zero windows
            block = zero_block
        out = st.step(block)
        if out is not None:
            cols.append(out)
    cols.sort(key=lambda c: c[0])
    whole = lambda a: torch.cat(list(st.axis.all_gather(a)), dim=1)
    vis = whole(torch.stack([v for _, v, _ in cols]))
    rgba = whole(torch.stack([r for _, _, r in cols]))
    return vis.cpu().numpy(), rgba.cpu().numpy()
