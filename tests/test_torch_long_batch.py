"""B2's bounded batch forms past 2^31 deposits a lane, on the CPU, by
shape: no large allocation.

A lane of T frames of K deposits holds T·K deposits.  At the north star
(32768 points, hop 800, 48 kHz: K = 16,385) T·K passes 2^31 at 131,065
frames, 36.4 minutes of audio; at wide (8192, hop 64: K = 4,097) at
524,161 frames, 11.7 minutes.  Both forms' kernels index a lane's
deposits in 64 bits, so past that limit:

* ``sorted_form`` still names the batch form and ``batch_plan`` fits, with
  the plan it has just below the limit;
* every refusal of each launcher (``emspec_histogram_batch`` in
  ``histogram_batch.cu``, ``emspec_histogram_tiles`` in ``histogram.cu``),
  read from the ``.cu`` and evaluated at the plan's arguments, passes;
* a lane's cells T·C stay below 2^31 (the ids are int32): the plan, both
  launchers and ``Pipeline.process`` refuse more, ``process`` with a
  ``ValueError`` before any work (wide at 4,096 rows and 11.7 minutes).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from emspec_torch import kernels_build
from emspec_torch.config import Settings
from emspec_torch.dsp.kernels.scatter import (
    batch_plan, sorted_form, tile_plan)
from emspec_torch.pipeline import Pipeline

CSRC = Path(kernels_build.__file__).parent / "csrc"
LIMIT = 2**31
NORTH = Settings(mode="enhanced", multires=False, fft_size=32768, hop=800)
WIDE = Settings(mode="enhanced", multires=False, fft_size=8192, hop=64)


def _frames_at(s: Settings, minutes: float) -> int:
    return Pipeline(s, "cpu").num_columns(int(minutes * 60 * s.sample_rate))


def _first_past(k: int) -> int:
    return -(-LIMIT // k)


# (T frames, K deposits a frame, reach R, C rows, lanes): at and past the
# limit, at the cells' own K and R
PAST = {
    "north at the limit": (_first_past(16385), 16385, 20, 512, 1),
    "north 37 min": (_frames_at(NORTH, 37.0), 16385, 20, 512, 1),
    "north 60 min": (_frames_at(NORTH, 60.0), 16385, 20, 512, 1),
    "wide at the limit": (_first_past(4097), 4097, 64, 512, 1),
    "wide 11.7 min": (_frames_at(WIDE, 11.7), 4097, 64, 512, 1),
    "wide 2^20 frames": (1 << 20, 4097, 64, 512, 1),
    "16384 hop 128": (_first_past(8193), 8193, 64, 512, 1),
    "8192 default hop": (_first_past(4097), 4097, 2, 512, 1),
    "32768 default hop, 16 lanes": (_first_past(16385), 16385, 2, 512, 16),
    "262144 default hop": (_first_past(131073), 131073, 2, 512, 1),
    "north 1024 rows": (_frames_at(NORTH, 40.0), 16385, 20, 1024, 1),
}


def _c_to_py(expr: str) -> str:
    """A C integer expression of the launchers as Python."""
    expr = " ".join(expr.split())
    expr = expr.replace("(long long)", "").replace("||", " or ")
    expr = expr.replace("&&", " and ").replace("a.", "a_")
    expr = re.sub(r"(\d+)LL\b", r"\1", expr)
    return re.sub(r"(?<![/])/(?![/])", "//", expr)


def _constants(text: str) -> dict:
    """The ``constexpr int`` constants of a ``.cu``, evaluated in order."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        env[name] = eval(_c_to_py(expr), {}, dict(env))
    return env


def _launcher(text: str, name: str) -> str:
    start = text.index(f'extern "C" int {name}(')
    return text[start:text.index("\n}\n", start)]


def _refusals(body: str) -> list:
    return [_c_to_py(c) for c in re.findall(
        r"if \((.*?)\)\s*return \(int\)cudaErrorInvalidValue;", body, re.S)]


def _assigned(body: str, lhs: str) -> str:
    return _c_to_py(re.search(rf"{re.escape(lhs)} = (.*?);", body,
                              re.S).group(1))


def _batch_refused(T, K, R, C, lanes, plan, text=None) -> list:
    """The batch launcher's refusals that hold at ``plan``'s arguments
    (``text``: the ``.cu``'s, read by default)."""
    text = text or (CSRC / "histogram_batch.cu").read_text()
    body = _launcher(text, "emspec_histogram_batch")
    env = _constants(text)
    log_b = plan["bands"].bit_length() - 1
    env.update(lanes=lanes, T=T, K=K, C=C, R=R, TT=plan["cols"],
               log_b=log_b, shift=plan["row_shift"], cap=plan["cap"],
               packed=int(plan["packed"]), add=0)
    assert "a.TT = TT < T ? TT : T;" in body
    env["a_TT"] = min(plan["cols"], T)
    for lhs in ("a.col_tiles", "a.rb"):
        env[lhs.replace(".", "_")] = eval(_assigned(body, lhs), {}, env)
    env["cells"] = eval(_assigned(body, "const long long cells"), {}, env)
    env["smem"] = eval(_assigned(body, "const long long smem"), {}, env)
    assert (env["a_rb"], env["cells"], env["smem"]) == (
        plan["rb"], plan["cells"], plan["smem"])
    return [c for c in _refusals(body) if eval(c, {}, env)]


def _tiles_refused(T, K, R, C, lanes, plan) -> list:
    """The tiles launcher's refusals that hold at ``plan``'s arguments."""
    text = (CSRC / "histogram.cu").read_text()
    body = _launcher(text, "emspec_histogram_tiles")
    env = _constants(text)
    env.update(rows=lanes, T=T, K=K, C=C, R=R, TT=plan["cols"],
               FF=plan["cells"], pc=plan["piece_chunks"],
               fp=plan["frames_per_piece"], add=0)
    env["smem"] = eval(_assigned(body, "const long long smem"), {}, env)
    assert env["smem"] == plan["smem"]
    return [c for c in _refusals(body) if eval(c, {}, env)]


def test_the_launchers_refusals_are_read():
    """The reading finds each launcher's refusals, the T·C bound among
    them, and evaluates the batch plan of a 16 s cell as accepted."""
    for path, fn in (("histogram_batch.cu", "emspec_histogram_batch"),
                     ("histogram.cu", "emspec_histogram_tiles")):
        conds = _refusals(_launcher((CSRC / path).read_text(), fn))
        assert len(conds) >= 2 and any("T * C >= (1 << 31)" in c
                                       for c in conds), conds
    assert _batch_refused(372, 4097, 2, 512, 1,
                          batch_plan(372, 4097, 2, 512)) == []


@pytest.mark.parametrize("case", sorted(PAST))
def test_past_the_limit_the_batch_form_fits_and_its_launcher_takes_it(case):
    T, K, R, C, lanes = PAST[case]
    assert T * K >= LIMIT > T * C
    assert sorted_form(T, K, R, C, lanes) == "batch"
    plan = batch_plan(T, K, R, C, lanes)
    assert plan["fits"], plan
    assert _batch_refused(T, K, R, C, lanes, plan) == []


@pytest.mark.parametrize("case", sorted(PAST))
def test_past_the_limit_the_plan_is_the_one_below_it(case):
    """A lane's deposits no longer enter the plan: the frames just below
    T·K = 2^31 and past it give one form and one CTA's plan (only the
    count of tiles grows with the frames)."""
    T, K, R, C, lanes = PAST[case]
    below = (LIMIT - 1) // K
    assert below * K < LIMIT

    def cta(plan):
        return {k: v for k, v in plan.items() if k not in ("col_tiles",
                                                           "ctas")}
    assert cta(batch_plan(below, K, R, C, lanes)) == cta(
        batch_plan(T, K, R, C, lanes))
    assert sorted_form(below, K, R, C, lanes) == sorted_form(
        T, K, R, C, lanes)


@pytest.mark.parametrize("case", sorted(PAST))
def test_past_the_limit_the_tiles_launcher_takes_its_plan(case):
    """The tiles form (forced, for timing; the fallback where the batch
    form's plan does not fit) takes the same shapes."""
    T, K, R, C, lanes = PAST[case]
    assert _tiles_refused(T, K, R, C, lanes,
                          tile_plan(T, K, R, column=C)) == []


@pytest.mark.parametrize("rows", [512, 4096])
def test_a_lanes_cells_stay_below_2_31(rows):
    """T·C ≥ 2^31 (int32 ids) is refused by the plan and by both
    launchers, whichever form ``sorted_form`` would name."""
    T = -(-LIMIT // rows)
    K = 4097
    plan = batch_plan(T, K, 64, rows)
    assert not plan["fits"]
    assert any("T * C" in c for c in _batch_refused(T, K, 64, rows, 1,
                                                     plan))
    assert any("T * C" in c for c in _tiles_refused(
        T, K, 64, rows, 1, tile_plan(T, K, 64, column=rows)))
    assert batch_plan(T - 1, K, 64, rows)["fits"]


def test_process_refuses_a_grid_of_2_31_cells_before_any_work(monkeypatch):
    """Wide with 4,096 rows at 11.7 minutes: T·rows ≥ 2^31 would wrap the
    int32 absolute ids.  ``process`` raises a ValueError naming the limit
    from the signal's length alone: no frame is analysed (the signal is a
    broadcast view, no memory)."""
    s = WIDE.replace(raster_height=4096)
    pipe = Pipeline(s, "cpu")
    n = int(11.7 * 60 * s.sample_rate)
    t = pipe.num_columns(n)
    assert t * pipe.rows >= LIMIT

    def work(*a, **k):
        raise AssertionError("process began work past the grid's limit")
    monkeypatch.setattr(Pipeline, "_batch_vis", work)
    monkeypatch.setattr(Pipeline, "to_device", work)
    x = torch.zeros(1).expand(n)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        pipe.process(x)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        pipe.process(np.broadcast_to(np.float32(0), (2, n)))
    with pytest.raises(ValueError, match=r"2\*\*31"):
        pipe._absolute_ids(torch.zeros((1, 3), dtype=torch.int32), t,
                           pipe.reach)


def test_the_grid_limit_is_by_mode_and_cells():
    """Just below 2^31 cells ``check_grid`` passes; natural mode holds no
    ids and has no such limit."""
    s = WIDE.replace(raster_height=4096)
    pipe = Pipeline(s, "cpu")
    pipe.check_grid((LIMIT - 1) // 4096)
    with pytest.raises(ValueError, match="int32"):
        pipe.check_grid(-(-LIMIT // 4096))
    Pipeline(s.replace(mode="natural"), "cpu").check_grid(
        -(-LIMIT // 4096))


def test_the_defaults_never_reach_the_grid_limit_at_an_hour():
    """An hour at the north star and at wide's 512 rows is below the
    cells' limit: only the deposits' limit was in the way."""
    for s in (NORTH, WIDE):
        pipe = Pipeline(s, "cpu")
        t = _frames_at(s, 60.0)
        pipe.check_grid(t)
        assert t * pipe.rows < LIMIT


def test_the_reading_sees_a_deposit_bound():
    """A launcher that refuses T·K ≥ 2^31 (as both did) is seen refusing
    the north star at 37 minutes."""
    T, K, R, C, lanes = PAST["north 37 min"]
    text = (CSRC / "histogram_batch.cu").read_text()
    old = "|| (long long)T * C >= (1LL << 31))"
    assert old in text
    broken = text.replace(old, "|| (long long)T * K >= (1LL << 31) " + old)
    assert _batch_refused(T, K, R, C, lanes, batch_plan(T, K, R, C, lanes),
                          broken)


def test_the_long_cells_lie_past_the_limit():
    """The table's minutes: 36.4 at the north star, 11.7 at wide."""
    for s, k, minutes in ((NORTH, 16385, 36.4), (WIDE, 4097, 11.7)):
        hop = s.hop_samples
        t = _first_past(k)
        got = ((t - 1) * hop + s.fft_size) / s.sample_rate / 60.0
        assert abs(got - minutes) < 0.05, (s, got)
