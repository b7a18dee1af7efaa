"""Host ring buffer: the ingest seam of the live stream.

Any producer (a WAV reader, a synthetic generator, a capture callback)
pushes samples; ``Stream`` pulls fixed-size analysis windows.  Single
writer, single reader.  ``make_ring`` gives the lock-free C++ ring of
``emspec_torch.native`` (the same contract, wait-free for a capture
callback) where the library builds, else this numpy ring.  Both keep the
read contract of the numpy ``RingBuffer`` of ``emspec.io.ring`` and the
same seqlock: a window that a push overwrote while it was copied raises
the overrun, never comes back torn.
"""

from __future__ import annotations

import numpy as np


class RingBuffer:
    """Multichannel sample ring. Writes never block; the ring keeps the most
    recent ``capacity`` samples and tracks the absolute sample count so the
    reader can detect underrun/overrun.

    A reader on another thread than the writer is safe by a seqlock: a
    push stores the end it is about to write (``_write_end``) before its
    first copy, and stores ``total_written`` after its last; a read checks
    its span against ``total_written`` before it copies and against
    ``_write_end`` after.  CPython orders attribute stores and loads under
    the GIL, and numpy releases the GIL only inside a copy, so a push whose
    copy overlapped the read's stored its end before the read's copy
    ended, and the read's load after that copy sees it."""

    def __init__(self, capacity: int, channels: int = 1, dtype=np.float32):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = int(capacity)
        self.channels = int(channels)
        self._buf = np.zeros((self.channels, self.capacity), dtype)
        self._write_pos = 0          # next write index (mod capacity)
        self.total_written = 0       # absolute samples pushed since creation
        self._write_end = 0          # the end the push in progress writes to

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
            self._write_end = total_after     # published before any copy
            newest = x[:, -self.capacity:]
            off = (total_after - self.capacity) % self.capacity
            self._buf[:, off:] = newest[:, :self.capacity - off]
            self._buf[:, :off] = newest[:, self.capacity - off:]
            self._write_pos = total_after % self.capacity
            self.total_written = total_after
            return
        self._write_end = self.total_written + k   # published before any copy
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
        # the seqlock's recheck: a push that overlapped the copy published
        # its end before its own copy began, so this load, after ours, sees
        # it; one that laps the span may have torn it (the C++ ring's rule)
        if start_abs < self._write_end - self.capacity:
            raise ValueError("window no longer in the ring (overrun)")
        return out

    def latest(self, n: int) -> np.ndarray:
        """(channels, n) copy of the most recent n samples."""
        total = self.total_written            # one total: start and length
        return self.window_at(max(total - n, 0), min(n, total))


def make_ring(capacity: int, channels: int = 1, prefer_native: bool = True):
    """Ring factory: the lock-free C++ SPSC ring when the native library is
    available (real capture callbacks need the wait-free producer), else
    the numpy implementation — identical contract either way."""
    if prefer_native:
        try:
            from emspec_torch.native import lib as native
            if native.available():
                return native.NativeRingBuffer(capacity, channels)
        except Exception:
            pass
    return RingBuffer(capacity, channels)
