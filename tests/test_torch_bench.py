"""The port's bench (``emspec_torch.bench``, ``python -m emspec_torch
bench``) on the CPU (``device="cpu"``), held to the JAX package's bench
(``emspec.bench``) where the two can agree: the signal bit for bit, the
deposits a column and the stage breakdown's shape exactly, the reports'
keys, the CLI's options; and to PERF.md's kernel table: B1's roofline
bound at 372 × 8192 within 1% of its 0.0046 ms, from the one formula the
bench and ``chip_smoke.py`` share.  Times from these runs are CPU times:
nothing here is a device figure.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from emspec.bench import harness as jax_harness
from emspec.bench import roofline as jax_roofline
from emspec.config import Settings as JaxSettings
from emspec.pipeline import Pipeline as JaxPipeline
from emspec_torch.bench import harness, measure, roofline, soak, stages
from emspec_torch.config import Settings
from emspec_torch.dsp.frame import frame_signal
from emspec_torch.pipeline import Pipeline

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(mode="natural", multires=False, fft_size=1024,
             raster_height=64, raster_width=128, hop=512)
H100 = roofline.data_sheet("NVIDIA H100 80GB HBM3")
B1_BOUND_MS = 0.0046            # PERF.md §6, B1 at 372 × 8192 (bytes)


@pytest.mark.parametrize("channels", [1, 16])
def test_signal_bit_equal_to_jax(channels):
    got = harness._signal(0.25, 48000, channels)
    want = jax_harness._signal(0.25, 48000, channels)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_latency_drives_the_stream_staging(monkeypatch):
    """``_latency`` times the real ``Stream`` protocol (``_stage_one``,
    then ``_dispatch``), with its device sub-measurements stubbed."""
    from emspec_torch.stream import Stream

    staged = []
    real = Stream._stage_one
    monkeypatch.setattr(Stream, "_stage_one",
                        lambda self: staged.append(1) or real(self))
    monkeypatch.setattr(harness, "_device_scan_ms_per_hop",
                        lambda settings, **kw: 0.01)
    monkeypatch.setattr(harness, "_fetch_throughput_gbs", lambda **kw: 1.0)
    rep = harness._latency(
        Settings(mode="enhanced", multires=False, fft_size=1024), hops=6,
        device="cpu")
    assert rep["p50_ms"] > 0 and rep["pipelined_ms_per_hop"] > 0
    assert rep["derived_local_host"]["local_host_p50_ms"] > 0
    assert rep["derived_local_host"]["column_bytes"] == 512 * 4
    assert rep["hops"] == 6 and len(staged) >= 6 + 8
    assert set(rep) >= {"p50_ms", "p99_ms", "mean_ms", "pipelined_ms_per_hop",
                        "device_scan_ms_per_hop", "derived_local_host"}


SETTINGS_CASES = [dict(mode="enhanced", multires=False, fft_size=8192),
                  dict(mode="enhanced", multires=True),
                  dict(mode="natural", multires=True),
                  dict(mode="enhanced", multires=False, fft_size=32768,
                       sample_rate=96_000, channels=16)]


@pytest.mark.parametrize("kw", SETTINGS_CASES,
                         ids=["8192", "multires", "natural", "stress"])
def test_deposits_per_column_match_jax(kw):
    pipe = Pipeline(Settings(**kw), "cpu")
    jpipe = JaxPipeline(JaxSettings(**kw))
    assert [tuple(k) for k in pipe.k_slices] == \
        [tuple(k) for k in jpipe.k_slices]
    got = roofline.estimate_column_cost(pipe)
    want = jax_roofline.estimate_column_cost(jpipe)
    assert got["deposits_per_col"] == want["deposits_per_col"]
    assert got["flops_per_col"] > 0 and got["bytes_per_col"] > 0


@pytest.mark.parametrize("kw", [dict(mode="enhanced", multires=False,
                                     fft_size=1024, raster_height=64),
                                dict(mode="natural", multires=True,
                                     raster_height=64)],
                         ids=["enhanced", "natural-multires"])
def test_stage_breakdown_matches_jax_t_count_and_keys(monkeypatch, kw):
    """The JAX breakdown's timer is stubbed (it would compile a scan a
    prefix); its t_count and keys are what the port must give."""
    import emspec.bench.measure as jax_measure
    from emspec.bench.stages import stage_breakdown as jax_breakdown

    monkeypatch.setattr(jax_measure, "chain_marginal_ms",
                        lambda *a, **k: 1.0)
    want = jax_breakdown(JaxSettings(**kw), seconds=0.5)
    got = stages.stage_breakdown(Settings(**kw), seconds=0.5, device="cpu")
    assert got["t_count"] == want["t_count"]
    assert list(got) == list(want)
    for key in ("prefix_us", "stage_us"):
        assert list(got[key]) == list(want[key])
    assert all(v >= 0 for v in got["stage_us"].values())
    assert got["prefix_us"]["lut"] > 0


def test_roofline_estimates():
    """Costs positive, ×16 at 16 channels, natural < enhanced, shares of
    the H100's data sheet in [0, 100]; on the CPU no share is given."""
    p1 = Pipeline(Settings(mode="enhanced", multires=False, fft_size=8192),
                  "cpu")
    p16 = Pipeline(Settings(mode="enhanced", multires=False, fft_size=8192,
                            channels=16), "cpu")
    pn = Pipeline(Settings(mode="natural", multires=False, fft_size=8192),
                  "cpu")
    e1, e16, en = (roofline.estimate_column_cost(p) for p in (p1, p16, pn))
    assert e1["flops_per_col"] > 0 and e1["bytes_per_col"] > 0
    assert e16["flops_per_col"] == 16 * e1["flops_per_col"]
    assert e16["bytes_per_col"] == 16 * e1["bytes_per_col"]
    assert en["flops_per_col"] < e1["flops_per_col"]
    assert en["bytes_per_col"] < e1["bytes_per_col"]
    r = roofline.roofline_report(p1, 100_000.0, pk=H100)
    assert r["achieved_tflops"] > 0
    for key in ("pct_h100_f32_peak", "pct_h100_hbm_peak"):
        assert 0 < r[key] <= 100
    cpu = roofline.roofline_report(p1, 100_000.0)
    assert cpu["peaks"]["source"] is None
    assert cpu["pct_h100_f32_peak"] is None and cpu["pct_h100_hbm_peak"] is None


def test_roofline_report_keys_are_the_jax_reports():
    """The JAX report's keys, ``pct_v5e_*`` as ``pct_h100_*`` (the TPU's
    bf16 GEMM share has no counterpart: nothing runs in bf16), plus the
    peaks."""
    kw = dict(mode="enhanced", multires=True)
    want = jax_roofline.roofline_report(JaxPipeline(JaxSettings(**kw)), 1e5)
    got = roofline.roofline_report(Pipeline(Settings(**kw), "cpu"), 1e5,
                                   pk=H100)
    renamed = {k.replace("v5e", "h100") for k in want
               if k != "pct_v5e_bf16_peak"}
    assert set(got) == renamed | {"peaks"}
    assert set(got["stages"]) == set(want["stages"])
    for st in got["stages"].values():
        assert set(st) == {"mflop_per_col", "kb_per_col", "validation"}


def test_b1_bound_at_the_batch_shape_is_perf_md_and_the_bench_s():
    """B1's bound at 372 × 8192 (hop 2048) is PERF.md §6's within 1%, and
    the bench's analysis stage over the same 372 frames is that count."""
    frames = frame_signal(torch.zeros(16 * 48000), 8192, 2048)
    assert tuple(frames.shape) == (372, 8192)
    b = roofline.b1_bound(frames)
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] - B1_BOUND_MS) <= 0.01 * B1_BOUND_MS
    pipe = Pipeline(Settings(mode="enhanced", multires=False, fft_size=8192),
                    "cpu")
    an = roofline.stage_costs(pipe, t_count=372)["analysis"]
    nbytes, ops = roofline.b1_counts(roofline.frame_bytes(frames), 372, 8192,
                                     4097, band=False)
    assert an["bytes"] * 372 == pytest.approx(nbytes, rel=1e-12)
    assert an["flops"] * 372 == pytest.approx(ops, rel=1e-12)
    assert roofline.bound(nbytes, ops) == b


def test_window_bound_counts_the_band_table():
    frames = frame_signal(torch.zeros(48000), 2048, 128)
    whole = roofline.b1_bound(frames)["bound_ms"]
    window = roofline.b1_window_bound(frames, 1025)["bound_ms"]
    assert window == pytest.approx(
        whole + 4 * 1025 / roofline.PEAK_BYTES_S * 1e3, rel=1e-12)


def test_data_sheet_names():
    assert roofline.data_sheet("NVIDIA H100 80GB HBM3") == {
        "hbm_bytes_s": 3.35e12, "f32_flops_s": 67e12}
    assert roofline.data_sheet("NVIDIA H100 PCIe")["hbm_bytes_s"] == 2.0e12
    assert roofline.data_sheet("NVIDIA A100-SXM4-80GB") is None
    assert roofline.peaks("cpu")["source"] is None


def test_cpu_timers_are_finite_and_positive():
    a = torch.rand(64, 64)
    ms = measure.chain_marginal_ms(lambda c: c @ a / 64.0,
                                   lambda: torch.ones(64, 64), 1, reps=3,
                                   long=12, short=3, device="cpu")
    assert np.isfinite(ms) and ms > 0
    assert measure.device_ms(lambda: a @ a, calls=5, device="cpu") > 0
    assert harness._fetch_throughput_gbs(device="cpu") is None


def test_throughput_report_on_the_cpu():
    rep = harness._throughput(Settings(**SMALL), 0.5, 2, device="cpu")
    want = {"columns_per_sec", "frames_per_sec_total", "t_count", "iters",
            "ms_per_call_marginal", "device_ms_per_call",
            "device_columns_per_sec", "realtime_factor", "roofline"}
    assert set(rep) == want
    assert rep["t_count"] == JaxPipeline(JaxSettings(**SMALL)).num_columns(
        24000)
    assert rep["columns_per_sec"] > 0 and rep["device_ms_per_call"] > 0
    assert rep["roofline"]["peaks"]["source"] is None


def _stub_measurements(monkeypatch, mod, calls):
    def thr(settings, seconds, iters, *a, **k):
        calls.append(("throughput", settings.fft_size, seconds))
        return {"columns_per_sec": 10.0, "device_columns_per_sec": 20.0,
                "t_count": 372}

    def lat(settings, hops, *a, **k):
        calls.append(("latency", settings.multires, hops))
        return {"p50_ms": 1.0}
    monkeypatch.setattr(mod, "_throughput", thr)
    monkeypatch.setattr(mod, "_latency", lat)


@pytest.mark.parametrize("quick", [True, False])
def test_run_benchmarks_covers_the_jax_configurations(monkeypatch, quick):
    import emspec.dsp.pallas.validate as jax_validate

    monkeypatch.setattr(jax_validate, "validate_kernels",
                        lambda quick=False: {})
    jax_calls, calls = [], []
    _stub_measurements(monkeypatch, jax_harness, jax_calls)
    _stub_measurements(monkeypatch, harness, calls)
    want = jax_harness.run_benchmarks(quick=quick)
    got = harness.run_benchmarks(quick=quick, device="cpu")
    assert set(got) == set(want)
    assert list(got["configs"]) == list(want["configs"])
    assert set(got["primary"]) >= set(want["primary"])
    assert got["primary"]["metric"] == want["primary"]["metric"]
    assert got["device"] == "cpu" and got["kernels"].startswith("not run")
    # the same configurations at the same signal lengths; the primary at
    # its 16 s batch, quick or not
    assert [c for c in calls if c[1] != 8192 or c[0] == "latency"] == \
        [c for c in jax_calls if c[1] != 8192 or c[0] == "latency"]
    assert ("throughput", 8192, 16.0) in calls


def test_sustained_display_keeps_up(tmp_path):
    rep = harness.sustained_display(Settings(**SMALL), seconds=1.5,
                                    user_dir=tmp_path, device="cpu")
    assert rep["emitted_cols"] > 0
    assert rep["keepup_ratio"] > 0.5, rep
    assert rep["p99_drain_gap_ms"] < 1000.0, rep


def test_soak_short_with_churn(tmp_path):
    """The soak end to end at CPU test scale: the live shell and the churn
    thread run, counters advance, the slopes and keep-up are finite, the
    churn meets no HTTP error, and the non-finite injection flows through
    with the display still rendering."""
    rep = soak.soak(Settings(**SMALL), seconds=2.0, sample_every=0.5,
                    user_dir=tmp_path, inject_nonfinite=True, inject_every=3,
                    device="cpu")
    assert rep["samples"] >= 4 and rep["columns_emitted"] > 0
    assert rep["churn"]["settings"] > 0 and rep["churn"]["errors"] == 0, rep
    assert np.isfinite(rep["rss_slope_mb_per_min"])
    assert np.isfinite(rep["keepup_second_half"])
    assert rep["device_mem_available"] is False
    assert rep["device_slope_mb_per_min"] is None
    assert rep["nonfinite_injected"] > 0 and rep["final_frame_nonblack"]


def _options(parser) -> set:
    return {o for a in parser._actions for o in a.option_strings} - {
        "-h", "--help"}


def test_bench_parser_takes_every_jax_option_and_device(capsys):
    """Every option of ``python -m emspec bench`` plus ``--device``."""
    from emspec.__main__ import main as jax_main
    from emspec_torch.__main__ import _parser

    with pytest.raises(SystemExit):
        jax_main(["bench", "--help"])
    jax_help = capsys.readouterr().out
    sub = next(a for a in _parser()._actions
               if hasattr(a, "choices") and isinstance(a.choices, dict))
    got = _options(sub.choices["bench"])
    usage = jax_help.split("options:")[0]
    want = set(re.findall(r"\[(--[\w-]+)", usage)) - {"--help"}
    assert got == want | {"--device"}
    args = _parser().parse_args(
        ["bench", "--quick", "--stages", "--trace", "d", "--sustained",
         "--soak", "--duration", "3", "--soak-mode", "natural",
         "--soak-inject-nonfinite", "--device", "cpu"])
    assert (args.quick, args.trace, args.duration, args.soak_mode,
            args.device) == (True, "d", 3.0, "natural", "cpu")


@pytest.mark.parametrize("flags,fn,module", [
    (["--stages"], "stage_breakdown", stages),
    (["--soak", "--duration", "2", "--quick"], "soak", soak),
    (["--sustained", "--duration", "2"], "sustained_display", harness),
    ([], "run_benchmarks", harness)], ids=["stages", "soak", "sustained",
                                            "report"])
def test_cmd_bench_runs_each_mode_on_the_asked_device(monkeypatch, capsys,
                                                      flags, fn, module):
    from emspec_torch.__main__ import main

    seen = []

    def fake(*a, **k):
        seen.append(k)
        return {"raw": [1], "ok": 1}
    monkeypatch.setattr(module, fn, fake)
    assert main(["bench", *flags, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert seen and all(k["device"] == "cpu" for k in seen)
    if fn == "soak":
        assert out == {"ok": 1} and seen[0]["seconds"] == 2.0
    if fn == "stages":
        assert set(out) == {"8192_enhanced", "multires", "stress_16ch"}


def test_bench_without_a_card_exits_2(monkeypatch, capsys):
    from emspec_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["bench", "--quick"]) == 2
    err = capsys.readouterr().err
    assert len(err.strip().splitlines()) == 1 and "--device cpu" in err


def test_bench_trace_cli_writes_a_trace(tmp_path):
    """``python -m emspec_torch bench --trace DIR --device cpu`` as a user
    runs it: exit 0, its JSON line, one Chrome trace with the step's
    operators."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "emspec_torch", "bench",
                        "--trace", str(tmp_path / "t"), "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=tmp_path,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout) == {"profiler_trace": str(tmp_path / "t")}
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)
