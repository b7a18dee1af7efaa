"""Command-line surface of the port: ``python -m emspec_torch <cmd>``
(``emspec.__main__``).

Subcommands: ``render`` (a WAV to a PNG spectrogram: the single-bank
linear-frequency raster, ``--multires`` the log-frequency display,
``--channel all`` every channel tiled; ``--time-parallel`` shards the
display render over time across the ranks of the process group, one a
card under ``torchrun``, world size 1 alone), ``export`` (the pre-colormap
display values and their axes to ``.npz``), ``stream`` (the WAV through
the live path into a scrolling waterfall, snapshotted to PNG),
``animate`` (that waterfall as an animated PNG), ``live`` (the live
terminal waterfall of a WAV or of captured audio), ``gui`` (the web
shell, or ``--native`` the desktop window), ``presets`` (preset CRUD),
``doctor`` (an environment self-check; ``--kernels`` validates the CUDA
kernels on the card), ``bench`` (the performance harness,
``emspec_torch.bench``) and ``note`` (frequency → musical note).  A bare
``python -m emspec_torch`` opens ``gui``.  Each command that analyses
audio runs on the card; ``--device cpu`` asks for the CPU.  Without a
card and without it, the command prints one line and exits 2: it never
carries on on the CPU.  (``live``'s capture input is ``--capture-device``:
``--device`` is where the analysis runs.)

A user mistake (a missing or unreadable file, a bad flag value, a file
too short for one window) is one line on stderr and exit code 2.
"""

from __future__ import annotations

import argparse
import json
import sys


class UsageError(ValueError):
    """A user-input mistake that surfaces as one stderr line and rc 2.

    Only this type is caught at ``main``'s boundary: any other
    ValueError from inside the pipeline keeps its traceback."""


def _add_settings_args(p: argparse.ArgumentParser) -> None:
    from emspec_torch.config import COLORMAPS, FFT_SIZES
    p.add_argument("--fft-size", type=int, default=4096, choices=FFT_SIZES)
    p.add_argument("--mode", choices=["enhanced", "natural"], default="enhanced")
    p.add_argument("--colormap", choices=COLORMAPS, default="inferno")
    p.add_argument("--db-range", type=float, default=58.0)
    p.add_argument("--gain", type=float, default=3.5)
    p.add_argument("--brightness", type=float, default=0.44)
    p.add_argument("--noise-gate-db", type=float, default=-65.0)
    p.add_argument("--agc-strength", type=float, default=1.0)
    p.add_argument("--no-auto-gain", action="store_true")
    p.add_argument("--smoothing", type=float, default=0.0)
    p.add_argument("--low-end-boost", type=float, default=3.9)
    p.add_argument("--freq-scale", type=float, default=1.0)
    p.add_argument("--multires", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="enhanced low-end: 8192/2048/512 banks on a "
                        "log-frequency axis (default: off for render, on "
                        "for stream; --no-multires to force off)")
    p.add_argument("--hop", type=int, default=0, help="hop in samples (0 = fft_size/4)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the analysis runs (default: the card)")


def _device(args) -> str:
    """The command's device; the card is checked, never replaced."""
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise UsageError("no CUDA device is available — run on a machine "
                         "with an NVIDIA GPU, or pass --device cpu")
    return args.device


def _read_wav_cli(path):
    """Decode a CLI-supplied WAV; a decoder's rejection (not a RIFF/WAVE
    file, an unsupported bit depth, truncated data) is user input, so it
    becomes a UsageError."""
    from emspec_torch.io.wav import read_wav
    try:
        return read_wav(path)
    except ValueError as e:
        raise UsageError(str(e)) from None


def _pick_channel(audio, channel) -> int:
    """Validate a --channel index against the decoded audio."""
    try:
        c = int(channel)
    except ValueError:
        raise UsageError(
            f"--channel must be an integer or 'all', got {channel!r}") \
            from None
    if not 0 <= c < audio.shape[0]:
        raise UsageError(
            f"--channel {c} out of range: the file has {audio.shape[0]} "
            f"channel(s) (0..{audio.shape[0] - 1}, or 'all')")
    return c


def _settings_from(args, sample_rate: int, channels: int = 1,
                   multires_default: bool = False):
    from emspec_torch.config import Settings
    multires = (args.multires if args.multires is not None
                else multires_default)
    try:
        return Settings(
            fft_size=args.fft_size, mode=args.mode, colormap=args.colormap,
            db_range=args.db_range, gain=args.gain, brightness=args.brightness,
            noise_gate_db=args.noise_gate_db, agc_strength=args.agc_strength,
            auto_gain=not args.no_auto_gain, smoothing=args.smoothing,
            low_end_boost=args.low_end_boost, freq_scale=args.freq_scale,
            multires=multires, hop=args.hop,
            sample_rate=sample_rate, channels=channels,
        )
    except ValueError as e:
        raise UsageError(str(e)) from None


def cmd_render(args) -> int:
    from emspec_torch.render.png import tile_images, write_png

    dev = _device(args)
    audio, rate = _read_wav_cli(args.input)
    s = _settings_from(args, rate)
    n_need = max(s.multires_sizes) if s.multires else s.fft_size
    if audio.shape[-1] < n_need:
        fix = ("--no-multires or smaller multires banks" if s.multires
               else "a smaller --fft-size")
        print(f"error: {args.input} has {audio.shape[-1]} samples but one "
              f"{'multires window' if s.multires else 'FFT window'} needs "
              f"{n_need} — use a longer file or {fix}",
              file=sys.stderr)
        return 2
    time_parallel = args.time_parallel
    if time_parallel and not (s.multires or args.channel == "all"):
        raise UsageError(
            "--time-parallel requires the log-frequency display "
            "pipeline (--multires, or --channel all which always uses "
            "it); the linear-axis offline raster is single-device")
    if args.channel == "all":
        # one log-frequency image a channel from one batched pass, tiled
        if time_parallel:
            imgs = _render_time_parallel(
                audio, s.replace(channels=audio.shape[0], display_channel=0),
                dev)
            if imgs is None:
                return 0                        # not rank 0: rank 0 writes
        else:
            from emspec_torch.pipeline import render_images_channels
            imgs = render_images_channels(audio, s, dev)
        img = tile_images(imgs)
        write_png(args.output, img)
        print(f"{args.output}: {img.shape[1]}x{img.shape[0]} px, "
              f"{audio.shape[0]} channels tiled, mode={s.mode}, sr={rate}")
        return 0
    x = audio[_pick_channel(audio, args.channel)]
    if time_parallel:
        imgs = _render_time_parallel(x, s, dev)
        if imgs is None:
            return 0
        img = imgs[0]
    elif s.multires:
        from emspec_torch.pipeline import render_image_multires
        img = render_image_multires(x, s, dev)
    else:
        from emspec_torch.render.raster import render_image
        img = render_image(x, s, dev)
    write_png(args.output, img)
    print(f"{args.output}: {img.shape[1]}x{img.shape[0]} px, mode={s.mode}, "
          f"fft={s.fft_size}, sr={rate}")
    return 0


def _render_time_parallel(audio, s, dev):
    """The log-frequency image of each channel of ``audio`` (samples,) or
    (channels, samples), the render sharded over time across the ranks of
    the process group (``parallel.TimeParallelRenderer``; one process
    alone is world size 1).  With several channels the channel axis takes
    the gcd of the channels and the ranks, time the rest.  Rank 0 gets the
    images, every other rank None."""
    import math

    import torch.distributed as dist

    from emspec_torch.parallel import (
        TimeParallelRenderer, ch_time_mesh, channel_mesh, init_group)

    created = init_group(dev)
    try:
        n_ch = (math.gcd(audio.shape[0], dist.get_world_size())
                if audio.ndim == 2 else 1)
        mesh = (ch_time_mesh(n_ch, device=dev) if n_ch > 1
                else channel_mesh(axis="t", device=dev))
        r = TimeParallelRenderer(s, mesh)
        _, rgba, _ = r.render(audio)
        raster = r.gather(rgba, r.pipe.num_columns(audio.shape[-1]))
        if dist.get_rank() != 0:
            return None
        raster = raster.cpu().numpy()             # (t, [ch,] rows, 4)
        if raster.ndim == 3:
            raster = raster[:, None]
        return [raster[:, c].transpose(1, 0, 2)[::-1]
                for c in range(raster.shape[1])]
    finally:
        if created:
            dist.destroy_process_group()


def cmd_export(args) -> int:
    """The display-ready arrays instead of pixels: a no-pickle ``.npz``
    with the pre-colormap ``vis`` in [0, 1], the frequency of each row in
    Hz, the column (window-centre) times in seconds and the Settings as
    JSON.  ``apply_lut(vis)`` reproduces ``render``'s PNG of the same
    settings pixel for pixel."""
    import numpy as np

    dev = _device(args)
    audio, rate = _read_wav_cli(args.input)
    all_ch = args.channel == "all"
    s = _settings_from(args, rate,
                       channels=audio.shape[0] if all_ch else 1)
    n_need = max(s.multires_sizes) if s.multires else s.fft_size
    if audio.shape[-1] < n_need:
        raise UsageError(
            f"{args.input} has {audio.shape[-1]} samples but one "
            f"analysis window needs {n_need}")
    if s.multires or all_ch:
        # the log-frequency display pipeline, as render --channel all and
        # stream run it
        from emspec_torch.pipeline import get_pipeline
        s = s.replace(display_channel=0)
        x = audio if all_ch else audio[_pick_channel(audio, args.channel)]
        pipe = get_pipeline(s, dev)
        v, _, _ = pipe.process(x, params=pipe.params(s))
        vis = np.moveaxis(v.cpu().numpy(), 0, -1)     # ([ch,] rows, t)
        freq_hz = np.asarray(pipe._axis(s.freq_scale), np.float64)
        hop, n_win = pipe.hop, pipe.n_max
    else:
        # the single-bank linear-frequency raster
        from emspec_torch.render.raster import render_vis
        x = audio[_pick_channel(audio, args.channel)]
        vis = render_vis(x, s, dev)                   # (bins, t)
        n_win = s.fft_size
        hop = s.hop if s.hop > 0 else n_win // 4
        freq_hz = (np.arange(n_win // 2 + 1, dtype=np.float64)
                   * (rate / n_win))
    time_s = (np.arange(vis.shape[-1], dtype=np.float64) * hop
              + n_win / 2) / rate
    np.savez(args.output, vis=vis.astype(np.float32), freq_hz=freq_hz,
             time_s=time_s,
             settings_json=np.asarray(json.dumps(s.to_dict())))
    print(f"{args.output}: vis {'x'.join(map(str, vis.shape))} "
          f"({freq_hz[0]:.1f}-{freq_hz[-1]:.1f} Hz x {time_s[-1]:.2f} s), "
          f"mode={s.mode}, sr={rate}")
    return 0


def cmd_stream(args) -> int:
    """Feed a WAV through the live path into a scrolling waterfall, then
    snapshot it to PNG.  ``--channel all`` streams every channel through
    one multichannel Stream and tiles a waterfall a channel."""
    from emspec_torch.render.png import tile_images, write_png
    from emspec_torch.render.waterfall import Waterfall
    from emspec_torch.stream import Stream
    from emspec_torch.tables import lut

    dev = _device(args)
    audio, rate = _read_wav_cli(args.input)
    tiled = args.channel == "all" and audio.shape[0] > 1
    nch = audio.shape[0] if tiled else 1
    s = _settings_from(args, rate, channels=nch, multires_default=True)
    x = (audio if tiled else
         audio[0 if args.channel == "all"
               else _pick_channel(audio, args.channel)])
    stream = Stream(s, dev)
    wfs = [Waterfall(args.width, s.raster_height, s.scroll_speed,
                     lut_table=lut(s.colormap), device=dev)
           for _ in range(nch)]
    n_cols = 0

    def paint(col):
        one = col.rgba.ndim == 2
        for c, wf in enumerate(wfs):
            wf.add_column(col.rgba if one else col.rgba[c],
                          col.vis if one else col.vis[c])
    for i in range(0, x.shape[-1], args.chunk):
        for col in stream.push(x[..., i:i + args.chunk]):
            paint(col)
            n_cols += 1
    for col in stream.flush():
        paint(col)
        n_cols += 1
    write_png(args.output, tile_images([wf.image() for wf in wfs]))
    print(f"{args.output}: streamed {n_cols} columns x{nch}ch "
          f"(reach={stream.reach} hops), waterfall {args.width}x{s.raster_height}")
    return 0


def cmd_animate(args) -> int:
    """The scrolling display as an animated PNG: frame k is the live
    waterfall after k/fps seconds of audio (``render.animate``); the last
    frame equals ``stream``'s snapshot of the same audio."""
    from emspec_torch.render.animate import animate_frames, frame_count
    from emspec_torch.render.apng import write_apng

    dev = _device(args)
    audio, rate = _read_wav_cli(args.input)
    if not args.fps > 0:
        raise UsageError(f"--fps must be positive, got {args.fps}")
    tiled = args.channel == "all" and audio.shape[0] > 1
    nch = audio.shape[0] if tiled else 1
    s = _settings_from(args, rate, channels=nch, multires_default=True)
    x = (audio if tiled else
         audio[0 if args.channel == "all"
               else _pick_channel(audio, args.channel)])
    n_frames = frame_count(x.shape[-1], rate, args.fps)
    write_apng(args.output,
               animate_frames(x, s, fps=args.fps, width=args.width,
                              device=dev),
               fps=args.fps)
    print(f"{args.output}: {n_frames} frames @ {args.fps:g} fps x{nch}ch, "
          f"waterfall {args.width}x{s.raster_height}")
    return 0


def cmd_live(args) -> int:
    """The live terminal waterfall: a WAV at audio rate (``--fast``: as
    fast as it goes), or ``--capture`` for captured audio; prints the
    columns displayed and, for a capture, the backend it used."""
    if args.capture:
        from emspec_torch.render.terminal import (
            capture_backend, live_capture_view)
        dev = _device(args)
        s = _settings_from(args, args.sample_rate, multires_default=True)
        cap_dev = args.capture_device
        if cap_dev is not None and cap_dev.lstrip("-").isdigit():
            cap_dev = int(cap_dev)
        used = []
        n = live_capture_view(s, backend=args.backend,
                              duration=args.duration, width=args.width,
                              capture_device=cap_dev, device=dev,
                              on_open=lambda cap: used.append(
                                  capture_backend(cap)))
        print(f"\ndisplayed {n} columns ({used[0]} capture, device {dev})")
        return 0
    if not args.input:
        print("live: provide a WAV file or use --capture", file=sys.stderr)
        return 1
    from emspec_torch.render.terminal import live_view

    dev = _device(args)
    audio, rate = _read_wav_cli(args.input)    # decoded once, passed through
    s = _settings_from(args, rate, multires_default=True)
    n = live_view((audio, rate), s, width=args.width, realtime=not args.fast,
                  device=dev)
    print(f"\ndisplayed {n} columns")
    return 0


def cmd_presets(args) -> int:
    """Preset CRUD (Add/Edit/Delete): ``add``/``edit`` build a Settings
    bundle from the same flags as render/stream and persist it.  The file
    is the JAX package's format: either package reads the other's."""
    from emspec_torch.config import PresetStore
    store = PresetStore(args.file)
    if args.action == "list":
        for name in store.names():
            print(name)
    elif args.action == "show":
        try:
            preset = store.get(args.name)
        except KeyError:
            raise UsageError(f"no preset named {args.name!r}") from None
        print(json.dumps(preset.to_dict(), indent=2, sort_keys=True))
    elif args.action == "delete":
        try:
            store.delete(args.name)
        except KeyError:
            raise UsageError(f"no preset named {args.name!r}") from None
        except ValueError as e:           # Default-delete guard
            raise UsageError(str(e)) from None
    elif args.action in ("add", "edit"):
        exists = args.name in store.names()
        if args.action == "add" and exists:
            print(f"preset {args.name!r} already exists (use 'edit')",
                  file=sys.stderr)
            return 1
        if args.action == "edit" and not exists:
            print(f"no preset named {args.name!r} (use 'add')", file=sys.stderr)
            return 1
        s = _settings_from(args, args.sample_rate, args.channels,
                           multires_default=True)
        store.add(args.name, s)
        print(f"{args.action}: {args.name} -> {args.file}")
    return 0


def cmd_gui(args) -> int:
    """Window shell on the card: the live display and the settings panel
    on a local web page, or ``--native`` a frameless always-on-top
    tkinter window (the web page where Tk cannot open one).  Unless
    ``--no-prewarm``, the FFT-size dropdown (≤ 32768) and the multires
    base are warmed in the background."""
    from emspec_torch.config import FFT_SIZES
    from emspec_torch.shell import ShellServer

    dev = _device(args)
    source = "wav" if args.input else args.backend
    s = _settings_from(args, args.sample_rate, multires_default=True)
    warm = (tuple(n for n in FFT_SIZES if n <= 32768)
            if not args.no_prewarm else None)
    if args.native:
        from emspec_torch.shell.native import NativeUnavailable, run_native
        try:
            run_native(s, source=source, wav_path=args.input,
                       user_dir=args.user_dir, prewarm_sizes=warm, device=dev)
            return 0
        except NativeUnavailable as e:
            print(f"native window unavailable ({e}); "
                  f"falling back to the web shell", file=sys.stderr)
    srv = ShellServer(s, port=args.port, source=source, wav_path=args.input,
                      user_dir=args.user_dir, prewarm_sizes=warm, device=dev)
    srv.start()
    print(f"emspec_torch shell: http://127.0.0.1:{srv.port}/  "
          f"(source={srv.feeder.backend}, device={srv.app.device} "
          f"{srv.device_name}, Ctrl-C to quit)", flush=True)
    srv.wait(duration=args.duration)
    print(f"shell stopped: {srv.columns_emitted} columns, "
          f"{srv.app.stream.dropped_frames} dropped frames")
    return 0


def _smi(query: str) -> str | None:
    """One ``nvidia-smi --query-gpu`` answer for the first card, or None."""
    import shutil
    import subprocess
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def cmd_doctor(args) -> int:
    """Environment self-check, one ``ok``/``WARN``/``FAIL`` line a
    subsystem: torch and CUDA versions, the card's name and power limit,
    ``nvcc``, the kernel library, audio capture, the native window and
    the update manifest; ``--kernels`` also validates every CUDA kernel
    against its plain version on the card (``--full``: every shape).
    Exits 1 on any FAIL: on ``--device cuda`` (the default) without a
    card, and ``--kernels`` with ``--device cpu``."""
    import os
    import platform

    import torch

    from emspec_torch import __version__, kernels_build

    fails = 0

    def row(status, name, detail=""):
        nonlocal fails
        fails += status == "FAIL"
        print(f"{status:<5} {name:<16} {detail}")

    row("ok", "emspec_torch", f"{__version__} (python "
        f"{platform.python_version()}, {platform.system().lower()})")
    row("ok", "torch", f"{torch.__version__} (CUDA build "
        f"{torch.version.cuda or 'none'})")
    on_card = args.device == "cuda"
    if torch.cuda.is_available():
        smi = _smi("name,power.limit")
        row("ok", "cuda device", f"{torch.cuda.get_device_name(0)} "
            f"x{torch.cuda.device_count()}"
            + (f" ({smi})" if smi else " (nvidia-smi not found)"))
    elif on_card:
        row("FAIL", "cuda device", "no CUDA device is available — run on a "
            "machine with an NVIDIA GPU, or pass --device cpu")
    else:
        row("ok", "cuda device", "none (--device cpu)")
    try:
        nvcc = kernels_build._nvcc()
    except RuntimeError:
        nvcc = None
    built = kernels_build.library_path()
    if built.exists():
        row("ok", "kernel library", f"built: {built}")
    elif nvcc is not None:
        row("ok", "kernel library",
            f"not built yet; {nvcc} builds it at first use on the card")
    else:
        row("FAIL" if on_card else "WARN", "kernel library",
            "not built, and no nvcc to build it (set CUDA_HOME)")
    row("ok" if nvcc else "WARN", "nvcc", nvcc or "not found")

    try:
        import sounddevice as sd
        n_in = sum(1 for d in sd.query_devices()
                   if d.get("max_input_channels", 0) > 0)
        row("ok", "audio capture", f"sounddevice: {n_in} input device(s)")
    except Exception:
        row("WARN", "audio capture",
            "sounddevice not installed — synthetic/WAV sources only")

    try:
        import tkinter                               # noqa: F401
        row("ok", "native window", "tkinter available (gui --native)")
    except Exception:
        row("WARN", "native window", "no tkinter — web shell only")

    from emspec_torch.utils.update import UPDATE_MANIFEST_ENV, check_for_update
    if os.environ.get(UPDATE_MANIFEST_ENV):
        note = check_for_update()
        row("ok", "update check",
            f"newer version available: {note['latest']}" if note
            else "up to date")
    else:
        row("ok", "update check", "no manifest configured (offline)")

    if args.kernels:
        from emspec_torch.dsp.kernels.validate import validate_kernels
        try:
            report = validate_kernels(quick=not args.full, device=args.device)
            row("ok", "cuda kernels",
                f"B1-B5, the EMA scan, post_head and post_tail match "
                f"their plain versions on "
                f"{report['device']} ({'quick' if report['quick'] else 'full'}"
                f" shapes, {report['library']})")
        except Exception as e:
            row("FAIL", "cuda kernels", f"{type(e).__name__}: {e}")

    print(f"doctor: {'all checks passed' if fails == 0 else f'{fails} FAILURE(S)'}")
    return 1 if fails else 0


def cmd_bench(args) -> int:
    """The performance harness on the card (``emspec_torch.bench``): the
    full throughput and latency report after ``validate_kernels``, or
    ``--stages``, ``--soak``, ``--sustained``, ``--trace DIR``.  A kernel
    that fails validation, a failed ``device_ms`` or a failed graph replay
    ends the command with a traceback and a non-zero code."""
    from emspec_torch.config import Settings

    dev = _device(args)
    if args.trace:
        from emspec_torch.bench.harness import write_profiler_trace
        out = write_profiler_trace(
            Settings(mode="enhanced", multires=False, fft_size=8192),
            args.trace, device=dev)
        print(json.dumps({"profiler_trace": out}))
        return 0
    if args.stages:
        from emspec_torch.bench.stages import stage_breakdown
        report = {
            "8192_enhanced": stage_breakdown(
                Settings(mode="enhanced", multires=False, fft_size=8192),
                device=dev),
            "multires": stage_breakdown(
                Settings(mode="enhanced", multires=True), device=dev),
            "stress_16ch": stage_breakdown(
                Settings(mode="enhanced", multires=False, fft_size=32768,
                         sample_rate=96_000, channels=16), device=dev),
        }
        print(json.dumps(report, indent=2))
        return 0
    if args.soak:
        from emspec_torch.bench.soak import soak
        report = soak(
            settings=Settings(mode=args.soak_mode, multires=True),
            seconds=args.duration or 600.0,
            inject_nonfinite=args.soak_inject_nonfinite, device=dev)
        if args.quick:
            report.pop("raw", None)
        print(json.dumps(report, indent=2))
        return 0
    if args.sustained:
        from emspec_torch.bench.harness import sustained_display
        report = {
            "default_multires": sustained_display(
                seconds=args.duration or 8.0, device=dev),
            "north_star_32768": sustained_display(
                Settings(mode="enhanced", multires=False, fft_size=32768),
                seconds=args.duration or 8.0, device=dev),
        }
        print(json.dumps(report, indent=2))
        return 0
    from emspec_torch.bench.harness import run_benchmarks
    print(json.dumps(run_benchmarks(quick=args.quick, device=dev), indent=2))
    return 0


def cmd_note(args) -> int:
    from emspec_torch.utils.notes import describe_frequency
    try:
        print(describe_frequency(args.freq))
    except ValueError as e:               # e.g. freq ≤ 0: user input
        raise UsageError(str(e)) from None
    return 0


def _parser() -> argparse.ArgumentParser:
    from emspec_torch import __version__
    ap = argparse.ArgumentParser(
        prog="emspec_torch",
        description="streaming spectrogram framework, PyTorch/CUDA port")
    ap.add_argument("--version", action="version",
                    version=f"emspec_torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    channel_help = ("channel index, or 'all' for a tiled per-channel view "
                    "(always the log-frequency display path; a plain "
                    "single-channel render without --multires uses the "
                    "linear-axis single-bank raster)")

    pr = sub.add_parser("render", help="render a WAV file to a PNG spectrogram")
    pr.add_argument("input")
    pr.add_argument("output")
    pr.add_argument("--channel", default="0", help=channel_help)
    pr.add_argument("--time-parallel", action="store_true",
                    help="shard the render over the TIME axis across the "
                         "ranks of the process group (one per card under "
                         "torchrun; alone, one); requires the --multires "
                         "display pipeline or --channel all")
    _add_settings_args(pr)
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser(
        "export",
        help="export analysis arrays to .npz (pre-LUT vis values + "
             "frequency/time axes + settings JSON) instead of pixels")
    pe.add_argument("input")
    pe.add_argument("output")
    pe.add_argument("--channel", default="0", help=channel_help)
    _add_settings_args(pe)
    pe.set_defaults(fn=cmd_export)

    ps = sub.add_parser("stream", help="stream a WAV hop-by-hop into a "
                                       "scrolling waterfall PNG")
    ps.add_argument("input")
    ps.add_argument("output")
    ps.add_argument("--channel", default="0", help=channel_help)
    ps.add_argument("--chunk", type=int, default=1024, help="samples per push")
    ps.add_argument("--width", type=int, default=1024, help="waterfall columns")
    _add_settings_args(ps)
    ps.set_defaults(fn=cmd_stream)

    pa = sub.add_parser(
        "animate",
        help="render the scrolling waterfall itself to an animated PNG "
             "(APNG; frame k = the live display at k/fps seconds)")
    pa.add_argument("input")
    pa.add_argument("output")
    pa.add_argument("--channel", default="0",
                    help="channel index, or 'all' for a tiled per-channel "
                         "animation")
    pa.add_argument("--fps", type=float, default=30.0,
                    help="display frame rate (frames per second of audio)")
    pa.add_argument("--width", type=int, default=1024, help="waterfall columns")
    _add_settings_args(pa)
    pa.set_defaults(fn=cmd_animate)

    pl = sub.add_parser("live", help="live terminal waterfall (ANSI truecolor)")
    pl.add_argument("input", nargs="?", default=None,
                    help="WAV file (omit with --capture)")
    pl.add_argument("--width", type=int, default=512)
    pl.add_argument("--fast", action="store_true",
                    help="render as fast as possible instead of audio-rate")
    pl.add_argument("--capture", action="store_true",
                    help="visualize live captured audio instead of a file")
    pl.add_argument("--backend", choices=["auto", "sounddevice", "synthetic"],
                    default="auto", help="capture backend (auto: real device "
                                         "if sounddevice is installed, else "
                                         "synthetic test source)")
    pl.add_argument("--capture-device", default=None,
                    help="capture input index or PortAudio name (default: "
                         "prefer a loopback/monitor input, else the default "
                         "input)")
    pl.add_argument("--duration", type=float, default=10.0,
                    help="capture run time in seconds")
    pl.add_argument("--sample-rate", type=int, default=48_000)
    _add_settings_args(pl)
    pl.set_defaults(fn=cmd_live)

    pn = sub.add_parser("note", help="frequency → musical note (hover readout)")
    pn.add_argument("freq", type=float)
    pn.set_defaults(fn=cmd_note)

    pp = sub.add_parser("presets", help="preset store CRUD (Add/Edit/Delete)")
    pp.add_argument("action", choices=["list", "show", "add", "edit", "delete"])
    pp.add_argument("--name", default="Default")
    pp.add_argument("--file", default="presets.json")
    pp.add_argument("--sample-rate", type=int, default=48_000)
    pp.add_argument("--channels", type=int, default=1)
    _add_settings_args(pp)
    pp.set_defaults(fn=cmd_presets)

    pg = sub.add_parser("gui", help="window shell: local web page with the "
                                    "live display and the settings panel")
    pg.add_argument("input", nargs="?", default=None,
                    help="WAV file to loop (default: live capture)")
    pg.add_argument("--port", type=int, default=7780)
    pg.add_argument("--backend", choices=["auto", "sounddevice", "synthetic"],
                    default="auto", help="capture backend when no WAV given")
    pg.add_argument("--duration", type=float, default=0.0,
                    help="serve for N seconds (0 = until Ctrl-C)")
    pg.add_argument("--sample-rate", type=int, default=48_000)
    pg.add_argument("--user-dir", default=".emspec",
                    help="presets + live_state.json directory")
    pg.add_argument("--native", action="store_true",
                    help="open a frameless always-on-top desktop window "
                         "(tkinter) instead of the web page; falls back to "
                         "the web shell when headless")
    pg.add_argument("--no-prewarm", action="store_true",
                    help="skip warming the FFT-size dropdown in the "
                         "background (a size change then also builds its "
                         "pipeline)")
    _add_settings_args(pg)
    pg.set_defaults(fn=cmd_gui)

    pd = sub.add_parser(
        "doctor",
        help="environment self-check (torch/CUDA, the card, nvcc, the "
             "kernel library, capture, window shell; --kernels validates "
             "the CUDA kernels)")
    pd.add_argument("--kernels", action="store_true",
                    help="check every CUDA kernel against its plain version "
                         "on the card")
    pd.add_argument("--full", action="store_true",
                    help="with --kernels: every shape, not the quick ones")
    pd.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the checks run (default: the card)")
    pd.set_defaults(fn=cmd_doctor)

    pb = sub.add_parser("bench", help="run the performance harness")
    pb.add_argument("--quick", action="store_true",
                    help="the small report: configurations 0-4, short "
                         "chains, quick kernel validation")
    pb.add_argument("--stages", action="store_true",
                    help="per-stage device-cost breakdown instead of the "
                         "full throughput report")
    pb.add_argument("--trace", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the streaming hot "
                         "loop to DIR instead of running the harness")
    pb.add_argument("--sustained", action="store_true",
                    help="wall-clock sustained-display check: real-time "
                         "capture thread → ring → streaming step → "
                         "waterfall, drained at 60 Hz (the north-star "
                         "'sustain 60 fps' as a product-level measurement)")
    pb.add_argument("--soak", action="store_true",
                    help="long leak soak: live shell + settings/preset "
                         "churn thread, tracking RSS / device memory / "
                         "keep-up drift (default 600 s; see --duration)")
    pb.add_argument("--duration", type=float, default=0.0,
                    help="seconds per --sustained or --soak run "
                         "(defaults 8 / 600)")
    pb.add_argument("--soak-mode", choices=["enhanced", "natural"],
                    default="enhanced",
                    help="display mode for the --soak run")
    pb.add_argument("--soak-inject-nonfinite", action="store_true",
                    help="corrupt every 40th capture block with one "
                         "NaN/Inf sample during the soak — drives the "
                         "non-finite guard at product scale")
    pb.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the harness runs (default: the card)")
    pb.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        # a bare launch opens the window shell on auto capture, as
        # ``python -m emspec`` does
        argv = ["gui"]
    args = _parser().parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
