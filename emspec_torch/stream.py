"""Streaming: the live hop→raster loop (``emspec.stream``).

Samples arrive in a host ring (``emspec_torch.io.ring.RingBuffer``); each
hop stages only the ``hop`` new samples to the device (the analysis
window of ``n_max`` samples — the largest bank's — is device carry state,
``Pipeline._stream_step_rolling``), one step adds the frame's deposits
(enhanced) or merged column (natural) to the pending ring and emits one
display column.
Staging is a plain synchronous ``.to(device)`` copy of one hop at a time;
pinned buffers, a copy stream that overlaps hop t+1's copy with step t,
and CUDA graphs are later work (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emspec_torch.config import Settings
from emspec_torch.device import as_device
from emspec_torch.io.ring import RingBuffer
from emspec_torch.pipeline import Pipeline, PipelineParams, get_pipeline
from emspec_torch.post.chain import PostState


class Column(NamedTuple):
    """One emitted display column (device tensors until read).
    ``index`` is the absolute hop number, frames skipped on overrun
    included, so the time axis stays aligned with the audio."""
    index: int
    vis: torch.Tensor      # (..., rows) float32 in [0, 1]
    rgba: torch.Tensor     # (..., rows, 4) uint8


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().to("cpu", copy=True).numpy()


class Stream:
    """Stateful stream over one Pipeline on ``device`` (the card unless
    the caller asks for the CPU).

    >>> stream = Stream(Settings(multires=False, fft_size=8192))
    >>> cols = stream.push(samples)     # list[Column] ready so far
    >>> cols += stream.flush()          # drain the pending ring
    """

    def __init__(self, settings: Settings, device="cuda",
                 params: PipelineParams | None = None,
                 ring_seconds: float = 4.0):
        self.device = as_device(device)
        self.pipe: Pipeline = get_pipeline(settings, self.device)
        self.settings = settings
        s = settings
        self.channels = s.channels
        self._lead = (s.channels,) if s.channels > 1 else ()
        # the pipeline is cached by structural projection; params come
        # from THIS stream's settings (sliders live here)
        self.params = params or self.pipe.params(settings)
        capacity = max(int(ring_seconds * s.sample_rate),
                       self.pipe.n_max + 8 * self.pipe.hop)
        self.ring = RingBuffer(capacity, s.channels)
        self.dropped_frames = 0
        self._carry = self.pipe.init_roll_carry(self._lead)
        self._window_ready = False  # device window primed for _next_frame?
        self._t = 0                 # host mirror of the carry's hop counter
        self._last_col = None
        self._next_frame = 0        # next hop index to analyze
        self._paused = False
        self._finished = False

    # ------------------------------------------------------------------ API
    @property
    def reach(self) -> int:
        return self.pipe.reach

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
        window, inner = self._carry
        self._carry = (torch.zeros_like(window), inner)
        zero = np.zeros(self._lead + (self.pipe.hop,), np.float32)
        out = []
        for _ in range(self.pipe.reach):
            out.extend(self._dispatch(self._to_device(zero),
                                      self.dropped_frames))
        return out

    # ------------------------------------------------------------- internals
    def _to_device(self, block: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(block, np.float32)).to(self.device)

    def _stage_one(self):
        """Stage the next hop's new samples (plus, at stream start or after
        an overrun skip-ahead, the window prefix that re-primes the device
        window) → (device block, drop count, window prefix or None); None
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
            return self._to_device(block), self.dropped_frames, w_init

    def _drain(self) -> list[Column]:
        out = []
        while (staged := self._stage_one()) is not None:
            out.extend(self._dispatch(*staged))
        return out

    def _dispatch(self, dev, dropped: int, w_init=None) -> list[Column]:
        if w_init is not None:
            self._carry = (self._to_device(w_init), self._carry[1])
        self._carry, (vis, rgba, _) = self.pipe._stream_step_rolling(
            self._carry, dev, self.params)
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
        ring, rolling window, hop counter) — the layout of
        ``emspec.stream.Stream.state_pytree``."""
        window, (t, acc, post) = self._carry
        carry = (_host(window),
                 (np.int32(t), _host(acc),
                  PostState(smooth=_host(post.smooth),
                            agc_ref=_host(post.agc_ref))))
        return {"carry": carry, "t": self._t, "next_frame": self._next_frame}

    def load_state(self, state) -> None:
        """Resume from :meth:`state_dict` (or a converted JAX snapshot,
        ``emspec_torch.convert.stream_state_from_jax``)."""
        window, (t, acc, post) = state["carry"]
        dev = lambda a: torch.as_tensor(np.array(a, np.float32),
                                        device=self.device)
        self._carry = (dev(window),
                       (int(t), dev(acc),
                        PostState(smooth=dev(post.smooth),
                                  agc_ref=dev(post.agc_ref))))
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
