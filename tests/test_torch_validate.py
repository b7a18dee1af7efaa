"""The port's kernel self-check (``emspec_torch/dsp/kernels/validate.py``:
``python -m emspec_torch doctor --kernels`` and the first step of every
bench run) on the CPU, where each wrapper runs its plain version through
the same checks.

* Coverage: the quick set reaches every kernel form a default path
  launches — B2's sorted route with its reach bound in the batch and
  the tiles form, forced and by shape; its ring form at a hop where
  ``ring_plan`` takes the local kernel, at one where it takes the
  clustered kernel, at one it stages in windows and at one whose ring it
  cuts into bands; B1 with the display default's bin window and band
  weight — and B2's atomic routes, each forced.  The full set reaches
  the batch form's packed entries, row bands and 16 lanes, the ring form
  at 16 lanes and every bank of the display default.
* The checks bite: inside ``validate.perturbed`` (one form a broken
  stand-in: its largest cell one ulp up, the sum in reverse deposit
  order, an output's old values dropped, a NaN behind a dropped id
  landed; the ring's windows walked last to first, one band of the ring
  left as it was; B1's ids moved a row or its band weight left out; the
  real FFT with one ulp on frame 1 of a batch, or its power form without
  the non-finite scrub) the form's
  validator raises ``AssertionError`` from that form's check; on the
  untouched kernels each validator passes.

Signals are cut to ``SECONDS`` (the card runs each case's own length).
"""

from __future__ import annotations

import functools

import pytest
import torch

from emspec_torch.config import Settings
from emspec_torch.dsp.kernels import deposits, rfft, scatter, validate
from emspec_torch.pipeline import Pipeline

CPU = torch.device("cpu")
SECONDS = 2.0
FULL_SECONDS = 3.0      # ext262144 needs 262,144 samples at 96 kHz
KW = {"validate_sorted": dict(seconds=SECONDS), "validate_ring": {},
      "validate_deposits_windowed": dict(seconds=SECONDS),
      "validate_rfft": dict(seconds=SECONDS)}
# the check each broken stand-in must trip
TRIPS = {"ulp": "deposit order", "reversed": "deposit order",
         "out": "added into an output", "nan": "NaN or Inf",
         "order": "deposit order", "dropped": "deposit order",
         "moved": "ids equal", "unweighted": "ids equal",
         "batch": "frame alone", "unscrubbed": "not scrubbed",
         "mirror": "differ from route"}
# each new check's form, its validator and its broken stand-ins
FORMS = {"sorted batch": ("validate_sorted", ("ulp", "reversed", "out", "nan")),
         "sorted tiles": ("validate_sorted", ("ulp", "reversed", "out", "nan")),
         "ring local": ("validate_ring", ("ulp", "reversed", "nan")),
         "ring cluster": ("validate_ring", ("ulp", "reversed", "nan")),
         "ring windows": ("validate_ring", ("order",)),
         "ring bands": ("validate_ring", ("dropped",)),
         "B1 windowed": ("validate_deposits_windowed", ("moved",
                                                        "unweighted")),
         "rfft": ("validate_rfft", ("batch", "unscrubbed")),
         "rfft cluster": ("validate_rfft", ("mirror",))}
BITES = [(form, how) for form, (_, hows) in FORMS.items() for how in hows]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the ring-in-bands case's ring holds a million
    cells, and a CPU op that starts every OpenMP thread on it waits long
    under the suite's parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record(calls: dict, module, name: str):
    """A wrapper of ``module.name`` that records each call's shapes and
    keywords (tensors as their shapes) and delegates to the real one."""
    real = getattr(module, name)

    @functools.wraps(real)
    def wrapper(*a, **kw):
        calls[name].append((
            [tuple(x.shape) if isinstance(x, torch.Tensor) else x
             for x in a],
            {k: tuple(v.shape) if isinstance(v, torch.Tensor) else v
             for k, v in kw.items()}))
        return real(*a, **kw)
    return wrapper


def _recorded(quick: bool, seconds: float):
    calls = {"histogram": [], "histogram_ring": [], "deposits_ids": []}
    with pytest.MonkeyPatch.context() as mp:
        for module, name in ((scatter, "histogram"),
                             (scatter, "histogram_ring"),
                             (deposits, "deposits_ids")):
            mp.setattr(module, name, _record(calls, module, name))
        checked = (validate.validate_histogram(CPU, ((4, 2048, 4608),))
                   + validate.validate_sorted(CPU, quick, seconds)
                   + validate.validate_ring(CPU, quick)
                   + validate.validate_deposits(CPU)
                   + validate.validate_deposits_windowed(CPU, quick,
                                                         seconds))
    return calls, checked


@pytest.fixture(scope="module")
def quick_calls():
    """The kernel wrappers' calls of the validators' quick sets."""
    return _recorded(True, SECONDS)


def _sorted_calls(calls: dict) -> list:
    """(form forced or None, form by shape) of each bounded sorted call."""
    out = []
    for (ids, _, num_bins, *_), kw in calls["histogram"]:
        if kw.get("route") == scatter.SORTED and kw.get("reach") is not None:
            c_len = kw.get("column_len") or kw["frame_len"]
            rows = 1
            for d in ids[:-1]:
                rows *= d
            out.append((kw.get("form"), scatter.sorted_form(
                num_bins // c_len, kw["frame_len"], kw["reach"], c_len,
                rows)))
    return out


@pytest.mark.parametrize("form", ["batch", "tiles"])
def test_the_quick_set_sums_in_each_ordered_form(quick_calls, form):
    """B2's sorted route with its reach bound, in ``form``: forced, and
    where ``sorted_form`` picks it by shape."""
    calls, checked = quick_calls
    got = _sorted_calls(calls)
    assert (form, form) in got and (None, form) in got, got
    assert any(c.startswith(f"B2 · sorted {form} · ") for c in checked)


@pytest.mark.parametrize("local", [True, False], ids=["local", "cluster"])
def test_the_quick_set_adds_a_hop_in_each_ring_kernel(quick_calls, local):
    """``histogram_ring`` at a hop where ``ring_plan`` takes the local
    kernel, and at one where it takes the clustered kernel."""
    calls, checked = quick_calls
    plans = []
    for (ids, _, ring, _), kw in calls["histogram_ring"]:
        lanes = 1
        for d in ids[:-1]:
            lanes *= d
        plans.append(scatter.ring_plan(ids[-1], ring[0], ring[-1],
                                       lanes=lanes, **kw))
    assert any(p["fits"] and p["local"] == local for p in plans), plans
    form = "local" if local else "cluster"
    assert any(c.startswith(f"B2 · ring {form} · ") for c in checked)


@pytest.mark.parametrize("form", ["windows", "bands"])
def test_the_quick_set_adds_a_hop_in_windows_and_in_bands(quick_calls, form):
    """``histogram_ring`` at a hop that ``ring_plan`` stages in several
    windows (131072 at 96 kHz) and at one whose ring it cuts into several
    bands (8192 at hop 16, 2,048 rows): the plan the wrapper launches."""
    calls, checked = quick_calls
    plans = []
    for (ids, _, ring, _), kw in calls["histogram_ring"]:
        lanes = 1
        for d in ids[:-1]:
            lanes *= d
        plans.append(scatter.ring_plan(ids[-1], ring[0], ring[-1],
                                       lanes=lanes, **kw))
    assert any(p["fits"] and scatter.ring_form(p) == form
               and p[form] >= 2 for p in plans), plans
    assert any(c.startswith(f"B2 · ring {form} · ") and f" {form} of " in c
               for c in checked)


def test_the_quick_set_runs_b1_windowed_at_the_display_default(quick_calls):
    """B1 with the 8192 bank's bin window and band weight of
    ``Settings()``, and over the whole spectrum."""
    calls, checked = quick_calls
    pipe = Pipeline(Settings(), CPU)
    k_lo, k_hi = pipe.k_slices[0]
    windowed = [kw for _, kw in calls["deposits_ids"]
                if kw.get("band") is not None]
    assert windowed and all(
        (kw["n"], kw["k_lo"], kw["k_hi"], kw["band"])
        == (8192, k_lo, k_hi, (k_hi - k_lo,)) for kw in windowed)
    assert any(kw.get("band") is None and kw.get("k_hi") is None
               for _, kw in calls["deposits_ids"])
    assert any(c.startswith("B1 · windowed · ") for c in checked)


def test_the_quick_set_checks_the_real_fft():
    """The real FFT's quick set: natural 4096's power form with Hann, the
    direct method's triple at 8192 and at 65536 (route "cluster", held to
    the three-launch route), each a line of ``"checked"``."""
    checked = validate.validate_rfft(CPU, True, SECONDS)
    assert [c.split(" · ")[:2] for c in checked] == [
        ["rfft", "power"], ["rfft", "spectrum"], ["rfft", "spectrum"]]
    assert checked[0].split(" · ")[2].startswith("natural 4096: (")
    assert checked[1].split(" · ")[2].startswith("direct 8192: (3, ")
    assert checked[2].split(" · ")[2].startswith("direct 65536: (3, ")
    assert checked[2].endswith("route cluster ≡ large")
    full = validate.validate_rfft(CPU, False, SECONDS)
    assert [c.split(" · ")[2].split(":")[0] for c in full] == [
        label for label, *_ in validate.RFFT_CASES]


@pytest.mark.parametrize("route", scatter.ROUTES)
def test_the_quick_set_forces_each_atomic_route(quick_calls, route):
    calls, _ = quick_calls
    assert any(kw.get("route") == route for _, kw in calls["histogram"])


def test_the_checked_list_names_every_form(quick_calls):
    """``forms_of`` (doctor's row) names each form the quick set held."""
    _, checked = quick_calls
    row = validate.forms_of(checked)
    assert row.startswith("B2 row, global, sorted batch, sorted tiles, "
                          "ring local, ring cluster, ring windows, "
                          "ring bands; ")
    assert "B1 whole, windowed" in row
    assert all(len(c.split(" · ")) == 3 for c in checked)


def test_the_full_set_reaches_each_batch_regime():
    """Unless quick: the batch form with packed entries (north), with row
    bands (ext262144) and at 16 lanes (batch16); the ring form at 16
    lanes in clusters of 4; every bank of the display default."""
    _, checked = _recorded(False, FULL_SECONDS)
    sorted_ = [c for c in checked if c.startswith("B2 · sorted batch · ")]
    assert any(c.split(" · ")[2].startswith("north:")
               and c.endswith("packed entries") for c in sorted_)
    assert any(c.split(" · ")[2].startswith("ext262144:")
               and "16 row bands" in c for c in sorted_)
    assert any(c.split(" · ")[2].startswith("batch16: 16 × ")
               for c in sorted_)
    assert any(c.startswith("B2 · ring cluster · stress live: 16 × ")
               and "4 CTAs" in c for c in checked)
    banks = [c for c in checked if c.startswith("B1 · windowed · ")]
    assert [b.split(" × ")[1].split(",")[0] for b in banks] == [
        "8192", "2048", "512"]


@pytest.mark.parametrize("name", sorted(KW))
def test_each_validator_passes_the_untouched_kernels(name):
    assert getattr(validate, name)(CPU, **KW[name])


@pytest.mark.parametrize("form,how", BITES,
                         ids=[f"{f}-{h}".replace(" ", "_") for f, h in BITES])
def test_each_check_refuses_a_broken_form(form, how):
    name = FORMS[form][0]
    where = form if form.startswith(("B1", "rfft")) else f"B2 {form}"
    with validate.perturbed(form, how):
        with pytest.raises(AssertionError, match=rf"^{where} .*"
                           rf"{TRIPS[how]}"):
            getattr(validate, name)(CPU, **KW[name])


def test_perturbed_puts_the_real_kernels_back():
    assert validate.PERTURBATIONS == FORMS
    def kernels():
        return (scatter.histogram, scatter.histogram_ring,
                deposits.deposits_ids, rfft.rfft_frames)
    real = kernels()
    for form, how in BITES:
        with validate.perturbed(form, how):
            assert kernels() != real
        assert kernels() == real
    with pytest.raises(ValueError, match="no perturbation"):
        with validate.perturbed("ring local", "out"):
            pass
