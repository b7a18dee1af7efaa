"""Tracing and stage timing (``emspec.utils.tracing``).

``trace`` records the enclosed block with ``torch.profiler`` — the host's
operators, and the card's kernels and copies when a card is present —
and writes a Chrome/Perfetto trace into ``log_dir``; ``annotation`` is a
named span on that timeline; ``StageTimer`` times stages on the host's
clock, waiting for the card where asked.  The hot path calls none of
them: each wait would stall the queue of launches.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block and write its trace to ``log_dir``
    (``trace_<pid>_<ns>.json``; open it in Perfetto or chrome://tracing).
    No schedule, and events accumulate: every event of the block is kept
    until the export."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, acc_events=True) as prof:
        yield prof
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotation(name: str):
    """A named span on the trace's timeline (a context manager)."""
    return torch.profiler.record_function(name)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


class StageTimer:
    """Host-clock time per stage.  ``stop(name, *block_on)`` first waits
    for the cards that hold the given tensors (nested tuples too); CPU
    tensors need no wait.  For measuring only: each wait drains the
    card's queue."""

    def __init__(self):
        self.stages: dict[str, float] = {}
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, name: str, *block_on) -> float:
        for dev in {t.device for t in _tensors(block_on)
                    if t.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.stages[name] = self.stages.get(name, 0.0) + dt
        self._t0 = time.perf_counter()
        return dt

    def report_us(self) -> dict[str, float]:
        return {k: round(v * 1e6, 1) for k, v in self.stages.items()}
