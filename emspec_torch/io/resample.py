"""Streaming sample-rate conversion for live capture (L1).

The reference taps *system audio* (reference: README.md:36) — whatever
rate the OS mixer runs at (44.1 kHz consumer devices are common) — while
the analysis pipeline is specialized to ``Settings.sample_rate`` (a
structural field; recompiling the pipeline to chase the device is the
wrong trade).  This module adapts the device rate to the pipeline rate in
the capture callback with a classic polyphase windowed-sinc rational
resampler: upsample by L, lowpass, downsample by M, evaluated directly in
its polyphase form so each output sample is one ``taps``-point dot
product against the input history.

Host-side by design (like the ring buffer): the producer thread owns it,
the chunks are ~10 ms of audio, and the cost (taps MACs per output
sample, ~1.5 M MAC/s/channel at 48 kHz × 32 taps) is host noise.  The
streaming contract is exact: feeding any chunking of a signal produces
the identical sample stream as one batch call (carry = the last
``taps−1`` input samples), which the tests pin.
"""

from __future__ import annotations

import math

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def design_polyphase(up: int, down: int, taps_per_phase: int = 32,
                     rolloff: float = 0.945, beta: float = 8.6):
    """Kaiser-windowed-sinc prototype, reversed polyphase layout.

    Returns ``h_rev`` of shape (up, taps_per_phase) with
    ``h_rev[p, i] = h[p + up*(taps_per_phase-1-i)] * up`` so that output
    ``n`` (at phase ``p = (n*down) % up``, base ``b = (n*down) // up``)
    is ``dot(h_rev[p], x[b-taps_per_phase+1 : b+1])``.

    Cutoff sits at ``rolloff × min(f_in, f_out)/2`` of the upsampled
    Nyquist: anti-imaging for upsampling, anti-aliasing for downsampling,
    one filter does both.  beta=8.6 ≈ 90 dB stopband.
    """
    n_taps = taps_per_phase * up
    # normalized cutoff in the upsampled domain: 1/up is the input
    # Nyquist, down/up the output Nyquist (both as a fraction of
    # up·rate/2); take the smaller, backed off by the rolloff margin
    cutoff = rolloff * min(1.0 / up, 1.0 / max(down, 1))
    k = np.arange(n_taps, dtype=np.float64)
    center = (n_taps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * (k - center)) * np.kaiser(n_taps, beta)
    h *= up / np.sum(h)                 # unity DC gain after zero-stuffing
    # polyphase split + reverse each phase for a contiguous forward dot
    h_poly = h.reshape(taps_per_phase, up).T    # (up, taps_per_phase)
    return np.ascontiguousarray(h_poly[:, ::-1])


class StreamingResampler:
    """Rational-rate streaming resampler with chunking-invariant output.

    ``process(chunk)`` consumes float32 samples shaped ``(k,)`` or
    ``(channels, k)`` and returns the output samples that are fully
    determined so far (same leading shape); ``flush()`` drains the
    filter tail.  The stream introduces the filter's causal latency of
    ``(taps_per_phase−1)/2`` input samples (``delay_seconds``) — for a
    live display that is sub-millisecond and irrelevant; offline users
    can trim it.
    """

    def __init__(self, in_rate: int, out_rate: int,
                 taps_per_phase: int = 32, rolloff: float = 0.945):
        if in_rate <= 0 or out_rate <= 0:
            raise ValueError("rates must be positive")
        g = math.gcd(int(in_rate), int(out_rate))
        self.in_rate = int(in_rate)
        self.out_rate = int(out_rate)
        self.up = int(out_rate) // g
        self.down = int(in_rate) // g
        self.taps = int(taps_per_phase)
        self.identity = self.up == self.down == 1
        if not self.identity:
            self._h_rev = design_polyphase(self.up, self.down,
                                           self.taps, rolloff)
        # carry: the last taps-1 input samples (starts as silence), plus
        # absolute counters so chunk boundaries are invisible
        self._tail: np.ndarray | None = None
        self._in_count = 0       # absolute input samples consumed
        self._next_out = 0       # absolute next output index
        self._mono: bool | None = None   # 1-D vs (channels, k) feeding
        self._channels = 1

    @property
    def delay_seconds(self) -> float:
        """Causal group delay introduced at the input rate."""
        if self.identity:
            return 0.0
        return (self.taps * self.up - 1) / 2.0 / (self.up * self.in_rate)

    def _norm(self, chunk: np.ndarray) -> tuple[np.ndarray, bool]:
        x = np.asarray(chunk, dtype=np.float32)
        if x.ndim == 1:
            return x[None, :], True
        if x.ndim == 2:
            return x, False
        raise ValueError(f"expected (k,) or (channels, k), got {x.shape}")

    def process(self, chunk: np.ndarray) -> np.ndarray:
        x, mono = self._norm(chunk)
        self._mono = mono                # flush() mirrors the fed shape
        self._channels = x.shape[0]
        if self.identity:
            # normalized (float32, fed rank) — NOT the raw chunk object:
            # a float64 array or list input must still honor the output
            # contract (round-3 advisor finding)
            return x[0] if mono else x
        c, k = x.shape
        if self._tail is None:
            self._tail = np.zeros((c, self.taps - 1), np.float32)
        if self._tail.shape[0] != c:
            raise ValueError(f"channel count changed mid-stream: "
                             f"{self._tail.shape[0]} -> {c}")
        buf = np.concatenate([self._tail, x], axis=-1)
        chunk_start = self._in_count           # abs index of x[..., 0]
        self._in_count += k
        # outputs whose window end (base) falls inside known data:
        # base(n) = (n·down)//up ≤ in_count−1  ⟺  n ≤ ((in_count−1)·up
        # + up−1)//down, so the first *invalid* n is one past that
        n_hi = ((self._in_count - 1) * self.up + self.up - 1) \
            // self.down + 1 if self._in_count > 0 else 0
        n = np.arange(self._next_out, max(n_hi, self._next_out),
                      dtype=np.int64)
        self._next_out = n_hi
        # keep the last taps-1 samples for the next chunk
        self._tail = np.ascontiguousarray(buf[:, -(self.taps - 1):]) \
            if self.taps > 1 else np.zeros((c, 0), np.float32)
        if n.size == 0:
            out = np.zeros((c, 0), np.float32)
            return out[0] if mono else out
        j = n * self.down
        base = j // self.up
        phase = (j % self.up).astype(np.int64)
        # buf[0] is absolute sample chunk_start-(taps-1); a window for
        # output n starts at absolute base-taps+1 → buf row index
        s = (base - chunk_start + 0).astype(np.int64)   # = start index
        windows = sliding_window_view(buf, self.taps, axis=-1)  # (c,S,taps)
        coeffs = self._h_rev[phase]                     # (n_out, taps)
        out = np.einsum("cnt,nt->cn", windows[:, s, :], coeffs,
                        optimize=True).astype(np.float32)
        return out[0] if mono else out

    def flush(self) -> np.ndarray:
        """Drain the filter: pads with taps−1 zeros so every output whose
        window overlaps real input is emitted.  The result has the same
        leading shape ``process`` returned — ``(k,)`` for a 1-D-fed
        stream, ``(channels, k)`` otherwise — so callers can concatenate."""
        mono = self._mono is None or self._mono
        if self.identity or self._tail is None:
            return (np.zeros(0, np.float32) if mono
                    else np.zeros((self._channels, 0), np.float32))
        c = self._tail.shape[0]
        pad = np.zeros((c, self.taps - 1), np.float32)
        out = self.process(pad[0] if mono else pad)
        self._tail = None
        return out
