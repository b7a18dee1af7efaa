"""Checkpoint and resume of streaming state (``emspec.utils.checkpoint``).

A live session is saved mid-stream and resumed: the post chain's
carries, the pending ring, the rolling window, the hop counters and the
host ring's samples.  The format is the JAX package's, so a file written
by either package loads into the other: one ``.npz`` with the carry's
leaves as ``carry_{i}`` in the JAX leaf order (window, t, acc, smooth,
agc_ref), then ``t``, ``next_frame``, ``ring_data``, ``ring_total`` and
``dropped`` (a ``Stream``; ``needs_window_prime`` too where its window
must be re-primed), or ``t`` and ``needs_window_prime`` (a
``parallel.ShardedStream``).  It is read with ``allow_pickle=False``: the
structure comes from the stream's own fresh carry, so a hostile file runs
nothing.  Loading copies into the stream's own tensors, so a graphed
stream on the card resumes without a new capture.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from emspec_torch.post.chain import PostState


def _flat(tree) -> list:
    """The leaves of a nested tuple of arrays and tensors, in order."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flat(sub)]
    return [tree]


def _carry_payload(carry) -> dict:
    """The ``carry_{i}`` keys of a host carry (window, (t, acc, PostState))."""
    return {f"carry_{i}": np.asarray(leaf)
            for i, leaf in enumerate(_flat(carry))}


def _inner(leaves: list):
    t, acc, smooth, agc_ref = leaves
    return (t, acc, PostState(smooth=smooth, agc_ref=agc_ref))


def _roll_carry_from(z, pipe, lead: tuple):
    """(window, (t, acc, PostState)) from a snapshot → (carry, migrated).

    A snapshot from before the rolling window holds only the four inner
    leaves: its window comes back as zeros and ``migrated`` is True, and
    the caller re-primes the window (``Stream`` from its replayed ring, a
    ``ShardedStream`` by its caller's ``reset_window``)."""
    fresh = _flat(pipe.init_roll_carry(lead))
    n = len(fresh)                                       # 5
    if f"carry_{n - 1}" in z:                            # current layout
        leaves = [z[f"carry_{i}"] for i in range(n)]
        if leaves[0].shape[-1:] != tuple(fresh[0].shape[-1:]):
            # the JAX package's Stream at a hop past n_max rolls a
            # hop-long window and streams other columns than its batch:
            # its post state cannot continue this stream's
            raise ValueError(
                f"checkpoint window holds {leaves[0].shape[-1]} samples, "
                f"this stream's {fresh[0].shape[-1]} (n_max): a file saved "
                f"by a stream that rolled a hop-long window at a hop past "
                f"the largest frame, or by other settings, cannot resume")
        return (leaves[0], _inner(leaves[1:])), False
    if f"carry_{n - 2}" in z:                            # before the window
        window = np.zeros(tuple(fresh[0].shape), np.float32)
        return (window, _inner([z[f"carry_{i}"] for i in range(n - 1)])), True
    have = sum(1 for k in z.files if k.startswith("carry_"))
    raise ValueError(
        f"checkpoint has {have} carry leaves but this build expects {n} — "
        f"the file was probably saved by an older emspec (pre-rolling-"
        f"window carry layout)")


def _npz_path(path) -> Path:
    """``np.savez`` appends '.npz' to a path without it; so do loads, so
    ``save_stream(p)``/``load_stream(p)`` round-trip for any ``p``."""
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(p.suffix + ".npz")


def _ring_span(stream, next_frame: int) -> tuple[np.ndarray, int]:
    """The host ring's samples a file keeps → (ring_data, ring_total):
    exactly the absolute samples [ring_total − kept, ring_total), read
    against one total while a producer may push.

    The whole ring first, what the JAX package's ``save_stream`` stores.
    A push during that read overwrites its start (the overwrite horizon),
    and the ring reports the overrun; the span read again then starts at
    the stream's first unread sample (the next hop's block, or the window
    a prime reads), seconds inside the horizon while the stream keeps
    up; at a hop past ``n_max`` that sample may not be written yet, and
    the span is then empty.  Only when that span is lapped too, the
    stream itself has lost samples, and the overrun is raised."""
    ring = stream.ring
    total = int(ring.total_written)
    keep = min(total, ring.capacity)
    if not keep:
        return np.zeros((stream.channels, 0), np.float32), total
    try:
        return ring.window_at(total - keep, keep), total
    except ValueError:
        pass
    pipe = stream.pipe
    first = next_frame * pipe.hop
    if stream._window_ready:
        first += pipe.n_max - pipe.roll
    total = int(ring.total_written)
    if first >= total:
        return np.zeros((stream.channels, 0), np.float32), total
    return ring.window_at(first, total - first), total


def save_stream(path, stream) -> None:
    """A ``Stream``'s whole resumable state → ``path`` (.npz).  Called on
    the thread that drains the stream; a producer may push into its ring
    meanwhile (:func:`_ring_span`).  A stream past its first hop that
    must still re-prime its window (a migrated load that has not run a
    hop yet) says so in ``needs_window_prime``, a key the JAX package's
    ``load_stream`` does not read; ``t > 0`` alone would have its load
    roll the zeroed window on."""
    state = stream.state_dict()
    ring_data, total = _ring_span(stream, state["next_frame"])
    payload = _carry_payload(state["carry"])
    payload["t"] = np.int64(state["t"])
    payload["next_frame"] = np.int64(state["next_frame"])
    payload["ring_data"] = ring_data
    payload["ring_total"] = np.int64(total)
    payload["dropped"] = np.int64(stream.dropped_frames)
    if state["t"] > 0 and not stream._window_ready:
        payload["needs_window_prime"] = np.bool_(True)
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **payload)


def load_stream(path, stream) -> None:
    """Restore :func:`save_stream` state (or the JAX package's) into a
    freshly built ``Stream`` of the same Settings."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        carry, migrated = _roll_carry_from(
            z, stream.pipe, (stream.channels,) if stream.channels > 1 else ())
        total = int(z["ring_total"])
        ring_data = z["ring_data"]
        # replay the kept samples at their absolute position: the
        # (total − kept) samples before them go in as zeros, the last
        # ``capacity`` of those in one push at most
        kept = ring_data.shape[-1]
        skip = total - kept
        cap = stream.ring.capacity
        if skip > 0:
            stream.ring.push(np.zeros((stream.channels, min(skip, cap + 1)),
                                      np.float32))
            remaining = skip - min(skip, cap + 1)
            while remaining > 0:
                chunk = min(remaining, cap)
                stream.ring.push(np.zeros((stream.channels, chunk),
                                          np.float32))
                remaining -= chunk
        if kept:
            stream.ring.push(ring_data)
        stream.load_state({"carry": carry, "t": int(z["t"]),
                           "next_frame": int(z["next_frame"])})
        stream.dropped_frames = int(z["dropped"])
        if "needs_window_prime" in z.files:
            migrated = migrated or bool(z["needs_window_prime"])
    if migrated:
        # a zeroed or stale window cannot continue the roll: re-prime it
        # from the replayed ring at the next hop
        stream._window_ready = False


def save_sharded_stream(path, stream) -> None:
    """A ``parallel.ShardedStream``'s state → ``path`` (.npz): its carry
    gathered from every rank (a collective: every rank calls this; the
    mesh's first rank writes), so it loads onto any number of ranks that
    divides the channels.  A sharded stream owns no ring, so the file is the carry
    and the hop counter, and the ``needs_window_prime`` guard, which a
    migrated stream that was never re-primed passes on to its file."""
    import torch.distributed as dist

    state = stream.state_dict()
    if stream.axis.index == 0:
        payload = _carry_payload(state["carry"])
        payload["t"] = np.int64(state["t"])
        payload["needs_window_prime"] = np.bool_(stream.needs_window_prime)
        p = _npz_path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, **payload)
    dist.barrier(group=stream.axis.group)


def load_sharded_stream(path, stream) -> bool:
    """Restore :func:`save_sharded_stream` state into a freshly built
    ``ShardedStream`` of the same Settings on any number of ranks.

    Returns True when the stream still needs its window: a snapshot from
    before the rolling window (migrated with a zeroed window) or one whose
    guard was set.  The stream then refuses to ``step`` until
    ``reset_window(window_at_resume_point)``; a healthy load clears the
    guard."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        carry, migrated = _roll_carry_from(
            z, stream.pipe, (stream.settings.channels,))
        if "needs_window_prime" in z.files:
            migrated = migrated or bool(z["needs_window_prime"])
        stream.load_state({"carry": carry, "t": int(z["t"])})
    stream.needs_window_prime = migrated
    return migrated
