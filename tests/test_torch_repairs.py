"""Repairs of the port, on the CPU.

* The CPU live step keeps up when processes share the host: six
  processes at once, as a test run on six workers has, each drive
  200 natural live hops at the shell tests' settings (1024 points, hop
  256: 5.33 ms of audio a hop), and each one's median hop must take
  below half of that.  The ring's one-row update was an ``index_add_``,
  which starts every intra-op thread for a few hundred floats; with six
  processes on the host each hop waited ~140 ms for its threads.
* The step leaves the process's intra-op thread count as it found it.
* A structural ``EmSpecApp.apply_settings`` whose colormap lookup fails
  leaves the app on its old settings, stream and waterfall.
* The web shell's drain tick holds the app lock for a bounded batch of
  hops, then steps aside: with a backlog of 3 s of audio and each hop
  taking 20 ms (a loaded host: the six-process load above once took a
  hop 140 ms), a settings POST and ``/api/frame`` each answer within
  ``SHELL_BOUND_S``.  The tick used to drain every pending hop under the
  lock, and the load keeps hops pending, so neither request answered.

``python tests/test_torch_repairs.py [processes]`` prints each process's
median hop (ms) for that many processes at once (default six).
"""

import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from emspec_torch.app import EmSpecApp
from emspec_torch.config import Settings
from emspec_torch.io import synth
from emspec_torch.shell import ShellServer
from emspec_torch.stream import Stream

ROOT = Path(__file__).resolve().parents[1]
KW = dict(mode="natural", multires=False, fft_size=1024, raster_height=128,
          raster_width=256, hop=256)
PROCESSES = 6
HOPS = 200

# one process of the load: import, build the stream, wait until every
# process is ready (a file each), then time each hop's push
_LOAD = r"""
import json, sys, time
from pathlib import Path
import numpy as np
from emspec_torch.config import Settings
from emspec_torch.stream import Stream
kw, hops, me, n, d = json.loads(sys.argv[1])
st = Stream(Settings(**kw), "cpu")
n_fft, hop = kw["fft_size"], kw["hop"]
x = (np.random.default_rng(me).standard_normal(hop * (hops + 10) + n_fft)
     * 0.1).astype(np.float32)
st.push(x[:n_fft - hop])
(Path(d) / f"ready{me}").touch()
end = time.monotonic() + 120
while len(list(Path(d).glob("ready*"))) < n and time.monotonic() < end:
    time.sleep(0.01)
lat = []
for i in range(hops + 10):
    block = x[n_fft - hop + i * hop: n_fft + i * hop]
    t0 = time.perf_counter()
    cols = st.push(block)
    lat.append(time.perf_counter() - t0)
    assert len(cols) == 1
print(json.dumps(float(np.median(lat[10:])) * 1e3))
"""


def concurrent_p50(processes: int, folder) -> list:
    """Median ms a hop of each of ``processes`` live streams run at once."""
    arg = lambda me: json.dumps([KW, HOPS, me, processes, str(folder)])
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, arg(me)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for me in range(processes)]
    p50 = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err
        p50.append(json.loads(out.strip().splitlines()[-1]))
    return p50


def test_six_concurrent_cpu_live_streams_keep_up(tmp_path):
    p50 = concurrent_p50(PROCESSES, tmp_path)
    hop_ms = KW["hop"] / Settings(**KW).sample_rate * 1e3
    assert max(p50) < hop_ms / 2, (p50, hop_ms)


def test_cpu_step_leaves_the_thread_count_unchanged():
    before = torch.get_num_threads()
    for mode in ("natural", "enhanced"):
        st = Stream(Settings(**{**KW, "mode": mode}), "cpu")
        assert st.push(synth.tone(440.0, 0.1, 48_000))
        assert torch.get_num_threads() == before


def test_structural_change_with_a_failing_colormap_changes_nothing(
        tmp_path, monkeypatch):
    from emspec_torch import app as app_module

    app = EmSpecApp(Settings(multires=True, multires_sizes=(1024, 512),
                             raster_height=64, raster_width=32, hop=256),
                    user_dir=tmp_path, device="cpu")
    app.push_audio(synth.tone(440.0, 0.2, 48_000))
    before = (app.settings, app.stream, app.waterfall,
              app.waterfall.lut_table)
    image = np.array(app.image())

    def broken(name):
        raise RuntimeError(f"no table {name}")

    monkeypatch.setattr(app_module, "lut", broken)
    for change in (dict(fft_size=2048, multires=False, colormap="magma"),
                   dict(raster_height=32, colormap="magma")):
        with pytest.raises(RuntimeError, match="no table"):
            app.set(**change)
        after = (app.settings, app.stream, app.waterfall,
                 app.waterfall.lut_table)
        assert all(a is b for a, b in zip(after, before))
        assert not app.stream._finished
        np.testing.assert_array_equal(np.array(app.image()), image)


HOP_LOAD_S = 0.020           # a hop's wall on the loaded host
BACKLOG_S = 3.0              # audio waiting in the ring when the drain starts
SHELL_BOUND_S = 1.0          # a request's answer, backlog or not


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def test_shell_requests_answer_while_the_drain_has_a_backlog(tmp_path):
    srv = ShellServer(Settings(**KW), port=0, source="synthetic",
                      user_dir=tmp_path / "userdir", device="cpu")
    st = srv.app.stream
    dispatch = st._dispatch

    def loaded(*args):
        time.sleep(HOP_LOAD_S)
        return dispatch(*args)

    st._dispatch = loaded
    st.ring.push(synth.tone(440.0, BACKLOG_S, 48_000))
    base = f"http://127.0.0.1:{srv.port}"

    def post(gain):
        req = urllib.request.Request(
            base + "/api/settings", data=json.dumps({"gain": gain}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())["kind"]

    def frame():
        with urllib.request.urlopen(base + "/api/frame", timeout=10) as r:
            return len(r.read())

    srv.start()
    try:
        time.sleep(0.3)                       # the drain is into the backlog
        walls = []
        for gain in (2.0, 3.0, 4.0):
            kind, wall = _timed(lambda: post(gain))
            assert kind == "continuous"
            walls.append(wall)
            size, wall = _timed(frame)
            assert size == KW["raster_height"] * KW["raster_width"] * 4 + 8
            walls.append(wall)
        assert st.hop_pending()               # the backlog is still there
        assert srv.columns_emitted > 0        # and the drain is painting it
        assert max(walls) < SHELL_BOUND_S, walls
    finally:
        srv.stop()


if __name__ == "__main__":
    # python tests/test_torch_repairs.py [processes]: the CPU live step's
    # median ms a hop in each process, the processes run at once
    import tempfile
    n = int(sys.argv[1]) if len(sys.argv) > 1 else PROCESSES
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps({"processes": n, "p50_ms": concurrent_p50(n, tmp),
                          "torch_threads": torch.get_num_threads()}))
