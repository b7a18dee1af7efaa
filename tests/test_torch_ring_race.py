"""The native ring's seqlock under a lapping producer, in native code.

``tests/torch_ring_race.cpp`` is built here with the port's compiler and
flags (``native._cxx()``, ``native.CXXFLAGS``, ``-pthread``) against
``emspec_torch/native/src/emspec_native.cpp``.  Its producer thread
pushes unpaced, each value encoding its absolute index and channel; its
reader thread reads the window at the overwrite horizon as fast as it
can and checks every value.  Both threads run in C++, so no GIL keeps
them apart.  A window returned as valid with a wrong value is torn: none
may be.  Once a lap the producer waits for one read that no push
overlaps, which must come back valid, so a ring that reported every read
as an overrun would fail too.

Tolerances: none — every value is compared exactly.  The tests skip only
where no C++ compiler is found, as ``tests/test_torch_native.py`` does.
"""

import json
import shutil
import subprocess
from pathlib import Path

import pytest

from emspec_torch.native import lib as native

PROGRAM = Path(__file__).resolve().parent / "torch_ring_race.cpp"
CAPACITY, WINDOW, LAPS = 1024, 256, 2000


@pytest.fixture(scope="module")
def race(tmp_path_factory) -> Path:
    if shutil.which(native._cxx()) is None:
        pytest.skip("no C++ compiler (CXX, default g++)")
    assert native.available(), native.build_error()
    out = tmp_path_factory.mktemp("race") / "torch_ring_race"
    r = subprocess.run([native._cxx(), *native.CXXFLAGS, "-pthread", "-o",
                        str(out), str(PROGRAM), str(native.SOURCE)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return out


# (channels, chunk, push form): a chunk of 257 laps the 1024-sample ring
# every 4 pushes; 1500 > the capacity takes the oversized branches
CASES = [(1, 257, "planar"), (3, 257, "planar"),
         (1, 257, "interleaved"), (3, 257, "interleaved"),
         (3, 1500, "planar"), (1, 1500, "interleaved")]


def lap_waits(chunk: int) -> int:
    """How many times the race program's producer waits for a quiet read."""
    pos = lap = waits = 0
    while pos < LAPS * CAPACITY:
        pos += chunk
        if pos // CAPACITY > lap:
            lap, waits = pos // CAPACITY, waits + 1
    return waits


@pytest.mark.parametrize("channels,chunk,push", CASES,
                         ids=[f"{p}-{c}ch-chunk{k}" for c, k, p in CASES])
def test_no_torn_window_is_returned_as_valid(race, channels, chunk, push):
    r = subprocess.run([str(race), str(channels), str(CAPACITY), str(chunk),
                        str(WINDOW), str(LAPS), push], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout)
    assert got["torn"] == 0, got
    assert got["quiet"] == lap_waits(chunk), got
    assert got["quiet_valid"] == got["quiet"], got    # the valid-read floor
