"""The numpy ring's seqlock under a lapping producer thread.

``emspec_torch.io.ring.RingBuffer`` is the host ring of a ``Stream`` built
with ``native_ring=False`` and of any ``Stream`` on a host where the C++
library does not build; the web shell's feed thread and a capture callback
push into it while the drain reads.  numpy releases the GIL inside a copy,
so a push's copy and a read's copy really overlap.

:func:`race` runs a producer thread that pushes unpaced, each value
encoding its absolute index and channel, while the calling thread reads a
window at (or just past) the overwrite horizon as fast as it can and
checks every value.  A window returned as valid with a wrong value is
torn: none may be.  Once a lap the producer waits on an ``Event`` for one
read that no push overlaps, which must come back valid, so a ring that
reported every read as an overrun would fail too.  ``chip_smoke.py`` runs
the same race on the card machine's host.

Tolerances: none — every value is compared exactly.
"""

import sys
import threading
import time

import numpy as np
import pytest

from emspec_torch.io.ring import RingBuffer


def encoded(pos: int, k: int, channels: int) -> np.ndarray:
    """(channels, k) float32 values of absolute samples [pos, pos + k):
    20 bits of index and 4 of channel, exact in float32; a lapped sample
    is off by a multiple of the capacity, which is below 2^20."""
    idx = (np.arange(pos, pos + k, dtype=np.int64) & ((1 << 20) - 1)) << 4
    return (idx[None, :] + np.arange(channels)[:, None]).astype(np.float32)


def race(ring, chunks, window: int, offset: int, laps: int,
         seconds: float) -> dict:
    """A producer thread laps ``ring`` in pushes whose sizes cycle through
    ``chunks`` (a mono ring gets every other push 1-D) until ``laps``
    capacities are in or ``seconds`` have passed; the calling thread reads
    ``window`` samples ``offset`` past the overwrite horizon meanwhile →
    counts: valid (returned and exact), torn (returned with a wrong
    value), overrun, future, quiet (reads that no push overlapped), waits
    (the producer's waits for them), quiet_valid, seconds."""
    cap, ch = ring.capacity, ring.channels
    assert 0 <= offset and window + offset <= cap
    asked, answered, done = (threading.Event(), threading.Event(),
                             threading.Event())
    made = {"waits": 0, "stalled": False}

    def produce():
        pos = lap = i = 0
        stop = time.perf_counter() + seconds
        try:
            while pos < laps * cap and time.perf_counter() < stop:
                k = chunks[i % len(chunks)]
                x = encoded(pos, k, ch)
                ring.push(x[0] if ch == 1 and i % 2 else x)
                pos, i = pos + k, i + 1
                if pos // cap > lap:        # a lap: one read overlaps no push
                    lap = pos // cap
                    answered.clear()
                    asked.set()
                    made["waits"] += 1
                    if not answered.wait(60):
                        made["stalled"] = True
                        return
        finally:
            done.set()

    c = dict(valid=0, torn=0, overrun=0, future=0, quiet=0, quiet_valid=0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.perf_counter()
    producer = threading.Thread(target=produce)
    producer.start()
    try:
        while not done.is_set():
            calm = asked.is_set()       # the producer waits: nothing pushes
            start = max(ring.total_written - cap + offset, 0)
            try:
                got = ring.window_at(start, window)
            except ValueError as e:
                c["overrun" if "overrun" in str(e) else "future"] += 1
            else:
                ok = np.array_equal(got, encoded(start, window, ch))
                c["valid" if ok else "torn"] += 1
                c["quiet_valid"] += calm and ok
            if calm:
                c["quiet"] += 1
                asked.clear()
                answered.set()
    finally:
        producer.join(timeout=120)
        sys.setswitchinterval(switch)
    assert not producer.is_alive() and not made["stalled"]
    c["waits"] = made["waits"]
    c["seconds"] = time.perf_counter() - t0
    return c


CAPACITY = 1 << 16
GIANT = 1 << 14
# (channels, capacity, push sizes, window, offset): chunks below the
# capacity with the window 64 past the horizon and at it; pushes of
# capacity + 1 and more, which take the oversized branch
CASES = {
    "1ch_below": (1, CAPACITY, (4099,), 16384, 64),
    "3ch_below": (3, CAPACITY, (4099,), 16384, 64),
    "1ch_horizon": (1, CAPACITY, (4099,), 16384, 0),
    "3ch_horizon": (3, CAPACITY, (4099,), 16384, 0),
    "1ch_past_capacity": (1, GIANT, (GIANT + 1, 2 * GIANT + 3), 4096, 64),
    "3ch_past_capacity": (3, GIANT, (GIANT + 1, 2 * GIANT + 3), 4096, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_ring_returns_no_torn_window(case):
    ch, cap, chunks, window, offset = CASES[case]
    c = race(RingBuffer(cap, ch), chunks, window, offset, laps=4000,
             seconds=1.5)
    assert c["torn"] == 0, c
    assert c["quiet"] == c["waits"] == c["quiet_valid"] >= 1, c


def test_race_counts_a_torn_window():
    """The race's own check: a ring whose reads come back shifted by a
    lap is counted torn, not valid."""
    class Lapped(RingBuffer):
        def window_at(self, start_abs, n):
            out = super().window_at(start_abs, n)
            return out + np.float32(16 * self.capacity)

    c = race(Lapped(1024, 1), (257,), 256, 0, laps=20, seconds=5.0)
    assert c["valid"] == c["quiet_valid"] == 0 and c["torn"] >= c["quiet"]
    assert c["quiet"] == c["waits"] >= 1
