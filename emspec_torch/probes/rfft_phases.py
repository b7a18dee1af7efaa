"""Where the real FFT kernel's time goes, phase by phase, on one card.

Builds the real FFT's one-launch kernels a second time with
``EMSPEC_RFFT_STAMPS`` (``csrc/rfft.cu``: the block and full routes;
``csrc/rfft_cluster.cu``, the cluster route, where the checkout has it;
one ``nvcc`` each, into a library of their own in a temporary
directory): thread 0 of every block writes ``clock64()`` once the whole
block has ended each phase — the table and sample load, each FFT pass
(and the cluster's exchange), the unpack and store.  Each phase's cycles
are read block by block (SM clocks are not synchronized, so only
differences within a block mean anything), the median over blocks is
kept, and cycles turn into µs at the SM clock measured with
``torch.cuda._sleep`` against CUDA events.  The three-launch route
(pack, B4's large route, unpack) is split launch by launch instead: each
launch timed alone by ``bench.measure.device_ms`` on buffers of the
route's shapes.

    python3 -P emspec_torch/probes/rfft_phases.py [--root DIR] [--label NAME]

Cases: b = 1 at every size 256–262144 on the route ``route_of`` gives,
and the shapes ``chip_smoke.py`` times (372 × 8192, 688 × 32768, 184 ×
65536, 8 × 262144), on a normal-random signal framed at hop N/4 (a
strided view); ``--routes`` adds the forced routes a checkout keeps.  A
stamp costs a ``__syncthreads``, so a stamped call runs a little longer
than the kernel's own device ms (printed beside it).  ``split`` serves
``chip_smoke.py``.  Prints one JSON line.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

SLOTS = 16                                  # kStampSlots in the .cu files
SHAPES = ((1, 256), (1, 512), (1, 1024), (1, 2048), (1, 4096), (1, 8192),
          (1, 16384), (1, 32768), (1, 65536), (1, 131072), (1, 262144),
          (372, 8192), (688, 32768), (184, 65536), (8, 262144))


def passes(log2m: int) -> int:
    """Radix-16 passes of an m-point line (the last one the remainder)."""
    return (log2m + 3) // 4


def sm_hz(torch) -> float:
    """The SM clock while busy: ``torch.cuda._sleep`` spins a known count
    of clock64 cycles, timed by CUDA events."""
    cycles = 200_000_000
    torch.cuda._sleep(cycles // 10)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / (a.elapsed_time(b) * 1e-3)


def labels(route: str, n: int, written: int, factors) -> list:
    """The stamped phases of a one-launch route, in order."""
    n1, n2 = factors(n)
    p1, p2 = passes(n1.bit_length() - 1), passes(n2.bit_length() - 1)
    fft = ([f"column pass {i + 1}" for i in range(p1)]
           + (["exchange"] if route == "cluster" else [])
           + [f"row pass {i + 1}" for i in range(p2)])
    loads = written - 1 - len(fft) - 1
    head = (["table", "samples"] if loads == 2 else
            ["table and samples"] if loads == 1 else
            [f"load {i + 1}" for i in range(loads)])
    return head + fft + ["unpack and store"]


def stamped_phases(torch, lib, setter: str, call, blocks: int, hz: float,
                   route: str, n: int, factors) -> dict:
    """One stamped call → each phase's median cycles and µs over the
    blocks, and the block's median span."""
    rows = torch.full((blocks, SLOTS), -1, dtype=torch.int64, device="cuda")
    getattr(lib, setter)(ctypes.c_void_p(rows.data_ptr()))
    call()
    torch.cuda.synchronize()
    getattr(lib, setter)(ctypes.c_void_p(0))
    st = rows.cpu().numpy()
    written = int((st[0] >= 0).sum())
    d = np.diff(st[:, :written], axis=1)
    med = np.median(d, axis=0)
    span = float(np.median(st[:, written - 1] - st[:, 0]))
    names = labels(route, n, written, factors)
    return dict(blocks=blocks, span_cycles=span, span_us=span / hz * 1e6,
                phases={k: dict(cycles=float(c), us=float(c) / hz * 1e6,
                                share=float(c) / span if span else 0.0)
                        for k, c in zip(names, med)})


class StampedBuild:
    """The stamped build of the real FFT's one-launch kernels, started
    at once (one ``nvcc`` a source, all running together, so a caller may
    start it beside its own build); ``library()`` waits for it and loads
    it, the C entry points bound as ``kernels_build`` binds them, and the
    stamp setters."""

    def __init__(self, kernels_build):
        import tempfile

        self.kb = kernels_build
        self.nvcc = kernels_build._nvcc()
        self.flags = (*kernels_build.NVCC_FLAGS, "-DEMSPEC_RFFT_STAMPS")
        self.tmp = Path(tempfile.mkdtemp(prefix="rfft_phases_"))
        self.srcs = [kernels_build.SRC_DIR / f
                     for f in ("rfft.cu", "rfft_cluster.cu")
                     if (kernels_build.SRC_DIR / f).exists()]
        self.procs = [subprocess.Popen(
            [self.nvcc, *self.flags, "-c", "-o",
             str(self.tmp / f"{src.stem}.o"), str(src)])
            for src in self.srcs]
        self.lib = None

    def library(self):
        if self.lib is not None:
            return self.lib
        if any(proc.wait() != 0 for proc in self.procs):
            shutil.rmtree(self.tmp, ignore_errors=True)
            raise RuntimeError("rfft_phases: nvcc failed")
        lib_path = self.tmp / "librfft_stamped.so"
        subprocess.run([self.nvcc, *self.flags, "-shared", "-o",
                        str(lib_path), *(str(self.tmp / f"{src.stem}.o")
                                         for src in self.srcs)],
                       check=True)
        lib = ctypes.CDLL(str(lib_path))
        shutil.rmtree(self.tmp)             # loaded: the files may go
        for name, argtypes in self.kb._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        for name in ("emspec_rfft_stamps", "emspec_rfft_cluster_stamps"):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [ctypes.c_void_p]
                getattr(lib, name).restype = ctypes.c_int
        self.lib = lib
        return lib

    def close(self) -> None:
        """Stop any ``nvcc`` still running and drop its files (a caller
        that ends before it needs the library)."""
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def split(shapes, with_routes: bool = False, build=None) -> list:
    """Each shape (frames, N): its default route (and with
    ``with_routes`` every other that holds N) → device ms and the phase
    split (the one-launch routes) or the launches' device ms (route
    "large").  ``build``: a ``StampedBuild`` already started, or None
    (one is started here)."""
    import torch

    from emspec_torch import kernels_build
    from emspec_torch.bench.measure import device_ms
    from emspec_torch.dsp.frame import frame_signal
    from emspec_torch.dsp.kernels import rfft
    from emspec_torch.dsp.kernels.fourstep import fft4_steps123

    plain = kernels_build.library()
    lib = (build or StampedBuild(kernels_build)).library()
    setters = {route: name for route, name in (
        ("block", "emspec_rfft_stamps"), ("full", "emspec_rfft_stamps"),
        ("cluster", "emspec_rfft_cluster_stamps")) if hasattr(lib, name)}
    hz = sm_hz(torch)
    forced = getattr(rfft, "routes_of", None)
    cases = []
    rng = np.random.default_rng(29)
    for b, n in shapes:
        x = torch.from_numpy(rng.standard_normal((b - 1) * (n // 4) + n)
                             .astype(np.float32)).cuda()
        fr = frame_signal(x, n, n // 4)
        fr = fr[0] if b == 1 else fr
        routes = [rfft.route_of(n)]
        if with_routes and forced is not None:
            routes += [r for r in forced(n) if r not in routes]
        for route in routes:
            kw = {} if route == rfft.route_of(n) else {"route": route}
            case = dict(at=f"{b} × {n}", route=route, sm_hz=hz)
            case["device_ms"] = device_ms(
                lambda: rfft.rfft_frames(fr, **kw), calls=20)
            if route == "large":
                case["launches"] = large_split(torch, plain, rfft,
                                               fft4_steps123, device_ms, fr)
            elif route in setters:
                with stamped(kernels_build, lib):
                    rfft.rfft_frames(fr, **kw)
                    case.update(stamped_phases(
                        torch, lib, setters[route],
                        lambda: rfft.rfft_frames(fr, **kw),
                        blocks_of(rfft, route, b, n), hz, route, n,
                        rfft.factors))
            cases.append(case)
        del x, fr
    return cases


def run(root: Path, label: str, with_routes: bool) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rfft_phases: needs a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"label": label, "root": str(root), "card": card,
            "cases": split(SHAPES, with_routes)}


def blocks_of(rfft, route: str, b: int, n: int) -> int:
    """The blocks a one-launch route runs for b frames of n points."""
    if route == "cluster":
        return b << rfft.cluster_plan(n)["log2c"]
    m = n if route == "full" else n // 2
    log2f = max(0, 11 - (m.bit_length() - 1))
    return -(-b // (1 << log2f))


class stamped:
    """Route ``kernels_build.library()`` to the stamped build for the
    block."""

    def __init__(self, kb, lib):
        self.kb, self.lib = kb, lib

    def __enter__(self):
        self.real = self.kb.library
        self.kb.library = lambda: self.lib
        return self

    def __exit__(self, *exc):
        self.kb.library = self.real


def large_split(torch, lib, rfft, fft4_steps123, device_ms, fr) -> dict:
    """The three-launch route's launches, each alone (device ms): pack,
    B4's large route on the planes, unpack."""
    from emspec_torch.dsp.kernels import launch_stream

    n = fr.shape[-1]
    f3 = fr.reshape(1, 1, n) if fr.dim() == 1 else fr[None]
    b = f3.shape[0] * f3.shape[1]
    n1, n2 = rfft.factors(n)
    planes = torch.empty((2, b, n1, n2), dtype=torch.float32, device="cuda")
    xr, xi = fft4_steps123(planes[0], planes[1])
    out = torch.empty((b, n // 2 + 1), dtype=torch.complex64, device="cuda")
    tw = rfft.unpack_twiddles(n, "cuda")
    st = launch_stream(fr)
    lead = (f3.data_ptr(), f3.shape[0], f3.shape[1], f3.stride(0),
            f3.stride(1), None)
    return dict(
        pack=device_ms(lambda: lib.emspec_rfft_pack(
            *lead, planes[0].data_ptr(), planes[1].data_ptr(), n, st)),
        b4=device_ms(lambda: fft4_steps123(planes[0], planes[1])),
        unpack=device_ms(lambda: lib.emspec_rfft_unpack(
            xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), out.data_ptr(),
            None, b, n, n1, n2, st)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="change")
    ap.add_argument("--routes", action="store_true",
                    help="also every forced route the checkout keeps")
    args = ap.parse_args(argv)
    print(json.dumps(run(Path(args.root), args.label, args.routes)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
