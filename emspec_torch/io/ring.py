"""Host ring buffer: the ingest seam of the live stream (a copy of the
numpy ``RingBuffer`` of ``emspec.io.ring``).

Any producer (a WAV reader, a synthetic generator, a capture callback)
pushes samples; ``Stream`` pulls fixed-size analysis windows.  Single
writer, single reader.  The JAX package's lock-free native ring
(``emspec/native``) is not ported: ``tests/test_torch_copies.py`` holds
this copy to the numpy original on random push sequences.
"""

from __future__ import annotations

import numpy as np


class RingBuffer:
    """Multichannel sample ring. Writes never block; the ring keeps the most
    recent ``capacity`` samples and tracks the absolute sample count so the
    reader can detect underrun/overrun."""

    def __init__(self, capacity: int, channels: int = 1, dtype=np.float32):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.channels = int(channels)
        self._buf = np.zeros((self.channels, self.capacity), dtype)
        self._write_pos = 0          # next write index (mod capacity)
        self.total_written = 0       # absolute samples pushed since creation

    def push(self, samples: np.ndarray) -> None:
        """Append (channels, k) or (k,) samples."""
        x = np.asarray(samples)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {x.shape[0]}")
        k = x.shape[1]
        if k >= self.capacity:
            # keep only the newest window, preserving the invariant that
            # absolute sample i lives at buf[:, i % capacity]
            total_after = self.total_written + k
            newest = x[:, -self.capacity:]
            off = (total_after - self.capacity) % self.capacity
            self._buf[:, off:] = newest[:, :self.capacity - off]
            self._buf[:, :off] = newest[:, self.capacity - off:]
            self._write_pos = total_after % self.capacity
            self.total_written = total_after
            return
        end = self._write_pos + k
        if end <= self.capacity:
            self._buf[:, self._write_pos:end] = x
        else:
            first = self.capacity - self._write_pos
            self._buf[:, self._write_pos:] = x[:, :first]
            self._buf[:, :end - self.capacity] = x[:, first:]
        self._write_pos = end % self.capacity
        self.total_written += k

    def window_at(self, start_abs: int, n: int) -> np.ndarray:
        """(channels, n) copy of absolute samples [start_abs, start_abs+n).

        Raises if the span is not fully available (future) or already
        overwritten (underrun — SURVEY.md §5.3 failure contract)."""
        if start_abs + n > self.total_written:
            raise ValueError("window extends past the last written sample")
        if start_abs < self.total_written - self.capacity or start_abs < 0:
            raise ValueError("window no longer in the ring (overrun)")
        lo = start_abs % self.capacity
        hi = lo + n
        if hi <= self.capacity:
            out = self._buf[:, lo:hi].copy()
        else:
            out = np.empty((self.channels, n), self._buf.dtype)
            first = self.capacity - lo
            out[:, :first] = self._buf[:, lo:]
            out[:, first:] = self._buf[:, :hi - self.capacity]
        # seqlock-style re-validation: if a concurrent producer lapped us
        # mid-copy the data is torn — detect it rather than return garbage
        # (same contract as the C++ ring)
        if start_abs < self.total_written - self.capacity:
            raise ValueError("window no longer in the ring (overrun)")
        return out

    def latest(self, n: int) -> np.ndarray:
        """(channels, n) copy of the most recent n samples."""
        return self.window_at(max(self.total_written - n, 0), min(n, self.total_written))
