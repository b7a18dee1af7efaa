"""Streaming: the live hop→raster loop (``emspec.stream``).

Samples arrive in a host ring (``emspec_torch.io.ring.make_ring``: the
lock-free C++ ring of ``emspec_torch.native`` by default, the numpy
``RingBuffer`` with ``native_ring=False`` or where the library does not
build; one contract, bit-equal output); each hop stages only the
``hop`` new samples to the device (the analysis window of ``n_max``
samples — the largest bank's — is device carry state,
``Pipeline._stream_step_rolling``), one step adds the frame's deposits
(enhanced) or merged column (natural) to the pending ring and emits one
display column.

On the card a hop is one CUDA graph replay.  The ``Stream`` owns static
tensors — the carry (window, hop counter ``t``, pending ring, post
state), the params, the hop's input block — runs the eager step a few
hops on cloned carries to warm up (kernel library, CUDA modules, kernel
attributes, cuFFT plans, cached tables), then captures one step on the
static tensors with ``torch.cuda.graph``.  A hop then copies its samples
through a small ring of pinned host buffers into the static block
(``non_blocking``), replays, and clones the graph's two outputs into the
``Column``.  A failed capture raises: there is no eager fallback on the
card.  What a capture cannot survive: a host read of a device value
inside the step (``t`` is a device tensor for that reason) and rebinding
a carry or params tensor — every method here writes into the static
tensors with ``copy_``/``zero_`` instead, and the ``params`` setter
copies new values into the captured tensors, never re-capturing.  On the
CPU the same step runs eagerly on the same static tensors.

The warm-up and the capture hold ``device.CARD_LOCK``, so a prewarm job
on another thread cannot break the capture; ``close`` releases the
graph's private memory pool when an app drops the stream.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emspec_torch.config import Settings
from emspec_torch.device import CARD_LOCK, as_device
from emspec_torch.dsp.kernels import add_launch_counts, launch_counts
from emspec_torch.io.ring import make_ring
from emspec_torch.pipeline import Pipeline, PipelineParams, get_pipeline
from emspec_torch.post.chain import PostState

WARMUP_HOPS = 3         # eager hops before the capture
PINNED_SLOTS = 4        # pinned host staging buffers, used in turn


class Column(NamedTuple):
    """One emitted display column (device tensors until read).
    ``index`` is the absolute hop number, frames skipped on overrun
    included, so the time axis stays aligned with the audio."""
    index: int
    vis: torch.Tensor      # (..., rows) float32 in [0, 1]
    rgba: torch.Tensor     # (..., rows, 4) uint8


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().to("cpu", copy=True).numpy()


def _leaves(tree) -> list:
    """The tensors of a nested tuple (PipelineParams, a carry), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _clone(tree):
    """A nested tuple of fresh copies of ``tree``'s tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(s) for s in tree)) if hasattr(
        tree, "_fields") else tuple(_clone(s) for s in tree)


def _copy_into(dst, src, what: str) -> None:
    """Copy every tensor of ``src`` into the same-shaped one of ``dst``."""
    d, s = _leaves(dst), _leaves(src)
    if len(d) != len(s) or any(a.shape != b.shape or a.dtype != b.dtype
                               for a, b in zip(d, s)):
        raise ValueError(f"{what}: shapes or dtypes differ from the "
                         f"stream's (a structural change needs a new Stream)")
    for a, b in zip(d, s):
        a.copy_(b)


class Stream:
    """Stateful stream over one Pipeline on ``device`` (the card unless
    the caller asks for the CPU).

    >>> stream = Stream(Settings(multires=False, fft_size=8192))
    >>> cols = stream.push(samples)     # list[Column] ready so far
    >>> cols += stream.flush()          # drain the pending ring
    """

    def __init__(self, settings: Settings, device="cuda",
                 params: PipelineParams | None = None,
                 ring_seconds: float = 4.0, native_ring: bool = True):
        self.device = as_device(device)
        self.pipe: Pipeline = get_pipeline(settings, self.device)
        self.settings = settings
        s = settings
        self.channels = s.channels
        self._lead = (s.channels,) if s.channels > 1 else ()
        # the pipeline is cached by structural projection; params come
        # from THIS stream's settings (sliders live here), in tensors
        # this stream owns
        self._params = _clone(params or self.pipe.params(settings))
        capacity = max(int(ring_seconds * s.sample_rate),
                       self.pipe.n_max + 8 * self.pipe.hop)
        self.ring = make_ring(capacity, s.channels, prefer_native=native_ring)
        self.dropped_frames = 0
        self._carry = self.pipe.init_roll_carry(self._lead)
        self._block = torch.zeros(self._lead + (self.pipe.hop,),
                                  dtype=torch.float32, device=self.device)
        self._window_ready = False  # device window primed for _next_frame?
        self._t = 0                 # host mirror of the carry's hop counter
        self._last_col = None
        self._next_frame = 0        # next hop index to analyze
        self._paused = False
        self._finished = False
        self.captures = 0           # CUDA graph captures (one per stream)
        self._graph = None
        if self.device.type == "cuda":
            self._capture()

    # ------------------------------------------------------------------ API
    @property
    def reach(self) -> int:
        return self.pipe.reach

    @property
    def params(self) -> PipelineParams:
        """The continuous params, in the tensors the step reads (and, on
        the card, that the graph captured)."""
        return self._params

    @params.setter
    def params(self, params: PipelineParams) -> None:
        """Slider move, colormap change, Freq-Scale zoom: the new values
        are copied into the captured tensors; nothing is re-captured."""
        _copy_into(self._params, params, "params")

    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def push(self, samples: np.ndarray) -> list[Column]:
        """Feed new samples; returns every display column that became
        final.  While paused the ring still fills but nothing is analyzed."""
        if self._finished:
            raise RuntimeError(
                "stream already flushed; create a new Stream to continue")
        samples = np.asarray(samples)
        if samples.shape[-1]:
            self.ring.push(samples)
        if self._paused:
            return []
        return self._drain()

    def last_column(self) -> Column | None:
        """The most recently emitted column (the underrun repaint)."""
        return self._last_col

    def flush(self) -> list[Column]:
        """Emit the R pending columns at stream end (all-zero hops, which
        deposit nothing).  The stream is finished afterwards."""
        self._finished = True
        self._carry[0].zero_()
        zero = np.zeros(self._lead + (self.pipe.hop,), np.float32)
        out = []
        for _ in range(self.pipe.reach):
            out.extend(self._dispatch(zero, self.dropped_frames))
        return out

    def close(self) -> None:
        """Release what the stream holds on the card: the graph, its
        outputs, and with them the graph's private memory pool, which the
        caching allocator frees at the ``empty_cache`` that follows (a
        dropped graph's pool is only marked freeable).  An app calls this
        on the stream a structural change replaced; the stream is
        finished afterwards."""
        self._finished = True
        self._graph = None
        self._out = None
        if self.device.type == "cuda":
            with CARD_LOCK:
                torch.cuda.empty_cache()

    # ------------------------------------------------------------- internals
    def _step(self, block: torch.Tensor):
        """One eager step on the static carry → (vis, rgba)."""
        _, (vis, rgba, _) = self.pipe._stream_step_rolling(
            self._carry, block, self._params)
        return vis, rgba

    def _capture(self) -> None:
        """Warm up on cloned carries (side stream), then capture one step
        on the static tensors, both under ``CARD_LOCK``.  The wrappers'
        counters rise while the capture records launches that did not
        run: that rise is taken back now and added again on every
        replay."""
        with CARD_LOCK:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                carry = _clone(self._carry)
                for _ in range(WARMUP_HOPS):
                    self.pipe._stream_step_rolling(carry, self._block,
                                                   self._params)
            torch.cuda.current_stream(self.device).wait_stream(side)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._out = self._step(self._block)
            after = launch_counts()
        self._replay_launches = {k: after[k] - before[k] for k in after
                                 if after[k] != before.get(k, 0)}
        add_launch_counts(self._replay_launches, -1)
        self._graph = graph
        self.captures += 1
        self._pinned = [torch.empty(self._block.shape, dtype=torch.float32,
                                    pin_memory=True)
                        for _ in range(PINNED_SLOTS)]
        self._copied = [torch.cuda.Event() for _ in range(PINNED_SLOTS)]
        self._slot = 0

    def _replay(self, block: np.ndarray):
        """Stage ``block`` through the next pinned buffer (once its last
        copy has left it) into the static block, replay → (vis, rgba)."""
        i = self._slot
        self._slot = (i + 1) % PINNED_SLOTS
        self._copied[i].synchronize()
        self._pinned[i].numpy()[...] = block
        self._block.copy_(self._pinned[i], non_blocking=True)
        self._copied[i].record()
        self._graph.replay()
        add_launch_counts(self._replay_launches)
        vis, rgba = self._out
        return vis.clone(), rgba.clone()

    def _stage_one(self):
        """The next hop's new samples (plus, at stream start or after an
        overrun skip-ahead, the window prefix that re-primes the device
        window) → (host block, drop count, window prefix or None); None
        when the ring lacks hop ``_next_frame``'s window."""
        n_max, hop = self.pipe.n_max, self.pipe.hop
        while True:
            t = self._next_frame
            if self.ring.total_written < t * hop + n_max:
                return None
            try:
                if self._window_ready:
                    block = self.ring.window_at(t * hop + n_max - hop, hop)
                    w_init = None
                else:
                    # prime: concat(w_init[hop:], block) == window t
                    window = self.ring.window_at(t * hop, n_max)
                    block = window[..., n_max - hop:]
                    w_init = np.concatenate(
                        [np.zeros(window.shape[:-1] + (hop,), np.float32),
                         window[..., :n_max - hop]], axis=-1)
                    self._window_ready = True
            except ValueError:
                # overrun: skip to the newest full frame, re-prime the window
                newest = (self.ring.total_written - n_max) // hop
                self.dropped_frames += max(newest - self._next_frame, 0)
                self._next_frame = max(newest, self._next_frame + 1)
                self._window_ready = False
                continue
            if self.channels == 1:
                block = block[0]
                if w_init is not None:
                    w_init = w_init[0]
            # the drop count is snapshotted with the window (Column.index)
            self._next_frame += 1
            return block, self.dropped_frames, w_init

    def _drain(self) -> list[Column]:
        out = []
        while (staged := self._stage_one()) is not None:
            out.extend(self._dispatch(*staged))
        return out

    def _dispatch(self, block: np.ndarray, dropped: int,
                  w_init=None) -> list[Column]:
        if w_init is not None:
            self._carry[0].copy_(torch.from_numpy(
                np.ascontiguousarray(w_init, np.float32)))
        if self._graph is None:
            vis, rgba = self._step(torch.from_numpy(
                np.ascontiguousarray(block, np.float32)).to(self.device))
        else:
            vis, rgba = self._replay(block)
        idx = self._t - self.pipe.reach + dropped
        self._t += 1
        if idx < 0:
            return []                                     # warmup
        col = Column(index=idx, vis=vis, rgba=rgba)
        self._last_col = col
        return [col]

    # ------------------------------------------------------- state save/load
    def state_dict(self) -> dict:
        """Streaming state as host numpy (post-chain carries, pending
        ring, rolling window, hop counter read back from the device) —
        the layout of ``emspec.stream.Stream.state_pytree``."""
        window, (t, acc, post) = self._carry
        carry = (_host(window),
                 (np.int32(t.item()), _host(acc),
                  PostState(smooth=_host(post.smooth),
                            agc_ref=_host(post.agc_ref))))
        return {"carry": carry, "t": self._t, "next_frame": self._next_frame}

    def load_state(self, state) -> None:
        """Resume from :meth:`state_dict` (or a converted JAX snapshot,
        ``emspec_torch.convert.stream_state_from_jax``), copied into the
        stream's own carry tensors."""
        window, (t, acc, post) = state["carry"]
        f32 = lambda a: torch.from_numpy(np.array(a, np.float32))
        _copy_into(self._carry,
                   (f32(window), (torch.tensor(np.int32(t)), f32(acc),
                                  (f32(post.smooth), f32(post.agc_ref)))),
                   "load_state")
        self._t = int(state["t"])
        self._next_frame = int(state["next_frame"])
        self._window_ready = self._t > 0


def stream_signal(x: np.ndarray, settings: Settings, device="cuda",
                  chunk: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """Push a whole signal through a Stream in ``chunk``-sample pushes →
    (vis (T, ..., rows), rgba (T, ..., rows, 4)) host arrays."""
    st = Stream(settings, device)
    x = np.asarray(x, np.float32)
    cols = []
    for i in range(0, x.shape[-1], chunk):
        cols.extend(st.push(x[..., i:i + chunk]))
    cols.extend(st.flush())
    if not cols:
        raise ValueError(
            f"signal too short: need at least {st.pipe.n_max} samples for "
            f"one analysis window, got {x.shape[-1]}")
    cols.sort(key=lambda c: c.index)
    vis = torch.stack([c.vis for c in cols]).cpu().numpy()
    rgba = torch.stack([c.rgba for c in cols]).cpu().numpy()
    return vis, rgba
