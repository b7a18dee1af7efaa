"""Roofline accounting of the port (``emspec.bench.roofline``): the work
of the *function* each stage computes, the same whatever implements it,
against the card's own peaks.

The JAX model counted the work of its TPU implementation (the Pallas
four-step GEMMs, the one-hot GEMM scatter's ``2·passes·m·S_hi·128``
flops) and divided by TPU v5e peaks.  On the H100 the analysis is a
radix FFT in shared memory and the scatter is atomics, so here each
stage counts what any implementation must do, from the shapes alone:

* analysis, enhanced, per bank and frame: the distinct samples read
  (frames overlap at a hop below N) and ids + contrib written for the
  bank's K bins, plus the t·h and twiddle tables (and the band weight of
  a windowed bank) once a call; one complex N-point DFT, ``5·N·log2 N``,
  for the two packed real transforms, plus ``N + 40·K`` operations for
  the window, stencils, corrections and quantization — exactly
  :func:`b1_bound` and :func:`b1_window_bound`, kernel B1's bounds in
  ``chip_smoke.py``;
* analysis, natural: the samples read and the K-bin power written; one
  real DFT (half a complex one), the window and ``3·K`` for |X|²;
* scatter: ``8·m`` bytes read (ids and contrib), ``4·rows`` written a
  column (the display grid) and ``m`` additions — B2's function, whatever
  its route and whether the pipeline sums a relative histogram and
  folds it or sums the absolute grid;
* merge (natural), post chain and LUT: the JAX model's bytes; post ≈ 25
  operations a row.

Peaks: :func:`peaks` gives the data sheet's figures for the card's name
beside figures measured on the card (a device-to-device ``copy_`` of
1 GiB counted as read + write bytes, a float32 ``torch.matmul`` at
8192³ with TF32 off — a yardstick of the peak, not a port of anything).
Shares divide by the data sheet where the card has an entry, else by
the measured figures (``peaks["source"]``).  :func:`bound` always uses
the H100 SXM data sheet, the rates of ``chip_smoke.py``'s kernel line.
"""

from __future__ import annotations

import functools
import math

import torch

PEAK_BYTES_S = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_S = 67e12              # H100 SXM float32 outside the tensor cores

# (words the card's name holds, HBM bytes/s, float32 FLOP/s outside the
# tensor cores), NVIDIA's data sheets; the first match wins
DATA_SHEET = (
    (("H100", "PCIe"), 2.0e12, 51e12),
    (("H100", "HBM3"), PEAK_BYTES_S, PEAK_FP32_S),     # the SXM part
    (("H100", "SXM"), PEAK_BYTES_S, PEAK_FP32_S),
)


def bound(nbytes: float, ops: float) -> dict:
    """Roofline bound: the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def dft_ops(n: int) -> float:
    """A complex n-point DFT counted as 5·n·log2 n, however it runs."""
    return 5.0 * n * math.log2(n)


def _distinct_bytes(lead: int, t: int, step: int, n: int) -> float:
    """Float32 bytes of ``lead`` signals' ``t`` frames of ``n`` samples
    ``step`` apart, each sample counted once."""
    return 4.0 * lead * ((t - 1) * min(step, n) + n)


def frame_bytes(frames) -> float:
    """Bytes of the distinct float32 samples a framing view covers: its
    frames overlap where the hop is below N, and each input byte counts
    once."""
    n = frames.shape[-1]
    f = frames.reshape((-1,) + tuple(frames.shape[-2:]) if frames.dim() > 1
                       else (1, 1, n))
    return _distinct_bytes(f.shape[0], f.shape[1], f.stride(1), n)


def b1_counts(samples_bytes: float, b: int, n: int, width: int,
              band: bool) -> tuple:
    """(bytes, operations) of B1's function on ``b`` frames of ``n``
    points whose distinct samples are ``samples_bytes``: ids and contrib
    written for ``width`` bins, the t·h and twiddle tables (and the band
    weight where ``band``) read once; two real n-point DFTs (half a
    complex one each), the t·h window and ~40 operations a bin for
    stencils, corrections and quantization."""
    nbytes = samples_bytes + 8 * b * width + 8 * n + 12
    if band:
        nbytes += 4 * width
    return nbytes, b * (dft_ops(n) + n + 40 * width)


def b1_bound(frames) -> dict:
    """B1's roofline bound on these frames, the whole spectrum."""
    n = frames.shape[-1]
    return bound(*b1_counts(frame_bytes(frames), frames.numel() // n, n,
                            n // 2 + 1, band=False))


def b1_window_bound(frames, width: int) -> dict:
    """B1's roofline bound with a window of ``width`` bins and its band
    weight: the window does not shrink the FFT."""
    n = frames.shape[-1]
    return bound(*b1_counts(frame_bytes(frames), frames.numel() // n, n,
                            width, band=True))


def _per_column(counts, t_count) -> tuple:
    """``counts(t)`` → (bytes, ops) of t columns, as a cost a column: at
    ``t_count`` columns a call, or, with None, the marginal column of an
    unbounded batch (each frame reads its hop of new samples; what a call
    reads once drops out)."""
    if t_count is None:
        (b1, o1), (b0, o0) = counts(2), counts(1)
        return b1 - b0, o1 - o0
    nbytes, ops = counts(t_count)
    return nbytes / t_count, ops / t_count


def stage_costs(pipe, t_count: int | None = None) -> dict:
    """Per-stage {flops, bytes, validation} per emitted display column
    (see the module docstring).  ``validation``: ``"function"`` where
    the count is the function's own least work, the same formula as the
    kernel bounds of ``chip_smoke.py``; ``"model"`` where it is the JAX
    package's estimate."""
    s = pipe.settings
    C = max(s.channels, 1)
    rows, hop = pipe.rows, pipe.hop
    enhanced = s.mode == "enhanced"
    band = len(pipe.sizes) > 1
    widths = [k_hi - k_lo for k_lo, k_hi in pipe.k_slices]
    stages: dict = {}

    def analysis(t):
        nbytes = ops = 0.0
        for n, K in zip(pipe.sizes, widths):
            samples = _distinct_bytes(C, t, hop, n)
            if enhanced:
                b, o = b1_counts(samples, C * t, n, K, band)
            else:
                b = samples + 4 * C * t * K + 4 * n
                o = C * t * (dft_ops(n) / 2 + n + 3 * K)
            nbytes, ops = nbytes + b, ops + o
        return nbytes, ops

    an_bytes, an_ops = _per_column(analysis, t_count)
    stages["analysis"] = {"flops": float(an_ops), "bytes": float(an_bytes),
                          "validation": "function"}
    m = C * sum(widths)
    if enhanced:
        stages["scatter"] = {"flops": float(m),
                             "bytes": float(8 * m + 4 * C * rows),
                             "validation": "function"}
    else:
        stages["merge"] = {"flops": float(C * 6 * rows * len(pipe.sizes)),
                           "bytes": float(C * 4 * rows * len(pipe.sizes) * 3),
                           "validation": "model"}
    stages["post"] = {"flops": float(C * 25 * rows),
                      "bytes": float(C * (4 * rows * 3 + 4 * rows)),
                      "validation": "model"}
    return stages


def estimate_column_cost(pipe, stages: dict | None = None,
                         t_count: int | None = None) -> dict:
    """Summed FLOPs + HBM bytes per emitted display column."""
    if stages is None:
        stages = stage_costs(pipe, t_count)
    flops = sum(st["flops"] for st in stages.values())
    bytes_ = sum(st["bytes"] for st in stages.values())
    m_total = sum(k_hi - k_lo for (k_lo, k_hi) in pipe.k_slices)
    return {"flops_per_col": flops, "bytes_per_col": bytes_,
            "deposits_per_col": int(max(pipe.settings.channels, 1) * m_total)}


def data_sheet(name: str) -> dict | None:
    """The data sheet's HBM and float32 rates for a card's name, or None."""
    for words, hbm, f32 in DATA_SHEET:
        if all(w in name for w in words):
            return {"hbm_bytes_s": hbm, "f32_flops_s": f32}
    return None


@functools.lru_cache(maxsize=None)
def _measured(device: str) -> tuple:
    """(bytes/s of a 1 GiB device-to-device ``copy_``, read + write;
    FLOP/s of a float32 8192³ ``torch.matmul`` with TF32 off)."""
    from emspec_torch.bench.measure import cuda_ms
    from emspec_torch.device import apply_precision_policy

    apply_precision_policy()
    dev = torch.device(device)
    n = 1 << 28                                       # 1 GiB of float32
    a = torch.ones(n, device=dev)
    b = torch.empty_like(a)
    copy_ms = cuda_ms(lambda: b.copy_(a), iters=10, warmup=2)
    del a, b
    m = 8192
    x = torch.rand((m, m), device=dev)
    y = torch.rand((m, m), device=dev)
    mm_ms = cuda_ms(lambda: torch.matmul(x, y), iters=5, warmup=2)
    del x, y
    torch.cuda.empty_cache()
    return 2 * 4 * n / (copy_ms / 1e3), 2.0 * m ** 3 / (mm_ms / 1e3)


def peaks(device="cuda") -> dict:
    """The card's peaks: the data sheet's (where its name has an entry)
    and the measured ones, and the pair the shares divide by
    (``hbm_bytes_s``, ``f32_flops_s``, named by ``source``).  On the CPU
    every figure is None: no CPU rate is a share of a card's peak."""
    from emspec_torch.device import as_device

    dev = as_device(device)
    if dev.type != "cuda":
        return {"name": str(dev), "source": None, "hbm_bytes_s": None,
                "f32_flops_s": None}
    name = torch.cuda.get_device_name(dev)
    sheet = data_sheet(name)
    hbm, f32 = _measured(str(dev))
    use = sheet or {"hbm_bytes_s": hbm, "f32_flops_s": f32}
    return {"name": name,
            "source": "data sheet" if sheet else "measured",
            **use,
            "data_sheet": sheet,
            "measured_hbm_bytes_s": hbm, "measured_f32_flops_s": f32}


def roofline_report(pipe, cols_per_sec: float, pk: dict | None = None,
                    t_count: int | None = None) -> dict:
    """Achieved rates and shares of the card's peaks (``pk``, default
    :func:`peaks` of the pipeline's device) for a measured throughput,
    with the per-stage counts labeled by where they come from."""
    stages = stage_costs(pipe, t_count)  # once: headline sums and the
    est = estimate_column_cost(pipe, stages)   # breakdown always reconcile
    pk = peaks(pipe.device) if pk is None else pk
    tflops = est["flops_per_col"] * cols_per_sec / 1e12
    gbs = est["bytes_per_col"] * cols_per_sec / 1e9

    def pct(rate, peak):
        return None if peak is None else round(100 * rate / peak, 4)
    return {
        "est_flops_per_col": round(est["flops_per_col"] / 1e6, 3),  # MFLOP
        "est_mb_per_col": round(est["bytes_per_col"] / 1e6, 4),
        "achieved_tflops": round(tflops, 3),
        "achieved_gbs": round(gbs, 2),
        "pct_h100_f32_peak": pct(tflops * 1e12, pk["f32_flops_s"]),
        "pct_h100_hbm_peak": pct(gbs * 1e9, pk["hbm_bytes_s"]),
        "arith_intensity_flops_per_byte": round(
            est["flops_per_col"] / max(est["bytes_per_col"], 1.0), 2),
        "peaks": pk,
        "stages": {
            name: {"mflop_per_col": round(st["flops"] / 1e6, 3),
                   "kb_per_col": round(st["bytes"] / 1e3, 2),
                   "validation": st["validation"]}
            for name, st in stages.items()
        },
    }
