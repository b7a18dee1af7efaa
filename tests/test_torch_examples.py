"""The port's examples (``emspec_torch/examples``, a counterpart of each
of ``examples/*.py``) run on the CPU as ``python -m
emspec_torch.examples.<name> --device cpu``, each in a subprocess at its
own size, and print what their JAX twins print; the sharded two also
under ``torch.distributed.run`` at world size 2.  The lines expected
below are the JAX examples' own output on the CPU (``tests/test_examples.py``
runs those, under ``slow``); where the JAX example counts its virtual
devices, the port counts its ranks.  And the Max for Live device copied
into the port keeps ``tests/test_examples.py``'s source contract."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ENV_PATH = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}

# name → (extra arguments, the lines it must print, as regular expressions)
EXAMPLES = {
    "offline_render": (["out.png"], [r"raster: \(512, 687, 4\) uint8",
                                     r"wrote out\.png"]),
    "streaming": ([], [r"90 columns; first rgba \(512, 4\), vis range "
                       r"\[0\.000, 0\.717\]"]),
    "animate": (["anim.png"], [r"wrote anim\.png: 60 frames \(512, 1024, 4\)"
                               r" @ 30 fps",
                               r"open it in any browser — APNG plays like "
                               r"the live window"]),
    "export_arrays": ([], [r"vis \(512, 687\) \(rows x columns\), 20-24000 "
                           r"Hz, 1\.91 s, mode=enhanced",
                           r"  t= 0\.27 s  ridge= 1249\.4 Hz",
                           r"  t= 1\.00 s  ridge= 4120\.4 Hz",
                           r"  t= 1\.73 s  ridge= 6981\.0 Hz",
                           r"ridge tracks the chirp: OK"]),
    "multichip_sharded": ([], [r"devices: 1 \| vis \(12, 8, 512\) \| "
                               r"sharded over 1 devices"]),
    "time_parallel_render": ([], [r"devices: 1 \| columns: 372 \| sharded "
                                  r"over 1 devices \| max \|Δvis\| vs "
                                  r"single-device: (?P<d1>\S+)",
                                  r"2-D mesh: \{'ch': 1, 't': 1\} \| max "
                                  r"\|Δvis\| vs single-device: (?P<d2>\S+)"]),
}


def _run(args, tmp_path, timeout=300):
    env = dict(os.environ, **ENV_PATH)
    r = subprocess.run(args, capture_output=True, text=True, timeout=timeout,
                       cwd=tmp_path, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip()
    return r.stdout


def _expect(out: str, patterns) -> dict:
    found = {}
    for pat in patterns:
        m = re.search(f"^{pat}$", out, re.M)
        assert m, (pat, out)
        found.update(m.groupdict())
    return found


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    extra, patterns = EXAMPLES[name]
    out = _run([sys.executable, "-m", f"emspec_torch.examples.{name}",
                *extra, "--device", "cpu"], tmp_path)
    found = _expect(out, patterns)
    for key in ("d1", "d2"):               # the sharded render ≡ one device
        if key in found:
            assert float(found[key]) <= 1e-5, found
    for f in extra:
        assert (tmp_path / f).stat().st_size > 0


@pytest.mark.parametrize("name", ["multichip_sharded", "time_parallel_render"])
def test_sharded_example_under_torchrun(name, tmp_path):
    """World size 2 on the CPU (gloo): rank 0 prints, once."""
    out = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", "-m",
                f"emspec_torch.examples.{name}", "--device", "cpu"], tmp_path)
    lines = [ln for ln in out.splitlines() if ln.startswith("devices:")]
    assert len(lines) == 1 and lines[0].startswith("devices: 2 |"), out
    if name == "time_parallel_render":
        found = _expect(out, [r".*single-device: (?P<d1>\S+)",
                              r"2-D mesh: \{'ch': 2, 't': 1\} \| max "
                              r"\|Δvis\| vs single-device: (?P<d2>\S+)"])
        assert max(float(v) for v in found.values()) <= 1e-5, found
    else:
        assert "vis (12, 8, 512) | sharded over 2 devices" in lines[0]


def test_example_without_a_card_says_so(tmp_path):
    """The default device is the card: without one, one line and exit 2."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "emspec_torch.examples.streaming"],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path, env=dict(os.environ, **ENV_PATH))
    assert r.returncode == 2 and "Traceback" not in r.stderr
    assert "no CUDA device is available" in r.stderr and not r.stdout


def test_m4l_patch_source_contract():
    """The port's copy of the M4L companion device (the Ableton side of
    the ``live_state.json`` contract) stays a loadable Max patch: valid
    JSON, js dependency present and wired, and the js implements exactly
    the documented states + file name (``tests/test_examples.py``, on
    ``emspec_torch/integrations/m4l``)."""
    d = ROOT / "emspec_torch" / "integrations" / "m4l"
    patch = json.loads((d / "EM-Spec.maxpat").read_text())
    boxes = [b["box"] for b in patch["patcher"]["boxes"]]
    texts = [b.get("text", "") for b in boxes]
    assert any("js emspec_state.js" in t for t in texts)
    assert any(t.startswith("metro") for t in texts)
    # every patchline endpoint refers to an existing box
    ids = {b["id"] for b in boxes}
    for ln in patch["patcher"]["lines"]:
        pl = ln["patchline"]
        assert pl["source"][0] in ids and pl["destination"][0] in ids

    js = (d / "emspec_state.js").read_text()
    assert '"minimized"' in js and '"restored"' in js
    assert "live_state.json" in js
    assert "is_view_visible" in js          # LOM Info View poll
    # the js writes the same JSON shape live_state.py reads
    assert '{"state": "' in js


def test_m4l_state_file_is_what_live_state_reads(tmp_path):
    """The file the device's js writes (by its own template) is read by
    the port's ``integrations.live_state`` as the state it names."""
    from emspec_torch.integrations import live_state
    js = (ROOT / "emspec_torch/integrations/m4l/emspec_state.js").read_text()
    m = re.search(r"f\.writestring\('(.*)' \+ state \+ '(.*)'\);", js)
    assert m, "the js's JSON template moved"
    for state in (live_state.STATE_MINIMIZED, live_state.STATE_RESTORED):
        path = tmp_path / "live_state.json"
        path.write_text(m.group(1) + state + m.group(2))
        assert live_state.read_state(path) == state
