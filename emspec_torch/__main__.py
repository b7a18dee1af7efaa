"""Command-line surface of the port: ``python -m emspec_torch <cmd>``
(``emspec.__main__``).

Subcommands: ``render`` (a WAV to a PNG spectrogram: the single-bank
linear-frequency raster, ``--multires`` the log-frequency display,
``--channel all`` every channel tiled), ``export`` (the pre-colormap
display values and their axes to ``.npz``), ``stream`` (the WAV through
the live path into a scrolling waterfall, snapshotted to PNG),
``animate`` (that waterfall as an animated PNG) and ``note`` (frequency
→ musical note).  Each command that analyses audio runs on the card;
``--device cpu`` asks for the CPU.  Without a card and without it, the
command prints one line and exits 2: it never carries on on the CPU.

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
    if args.channel == "all":
        # one log-frequency image a channel from one batched pass, tiled
        from emspec_torch.pipeline import render_images_channels
        img = tile_images(render_images_channels(audio, s, dev))
        write_png(args.output, img)
        print(f"{args.output}: {img.shape[1]}x{img.shape[0]} px, "
              f"{audio.shape[0]} channels tiled, mode={s.mode}, sr={rate}")
        return 0
    x = audio[_pick_channel(audio, args.channel)]
    if s.multires:
        from emspec_torch.pipeline import render_image_multires
        img = render_image_multires(x, s, dev)
    else:
        from emspec_torch.render.raster import render_image
        img = render_image(x, s, dev)
    write_png(args.output, img)
    print(f"{args.output}: {img.shape[1]}x{img.shape[0]} px, mode={s.mode}, "
          f"fft={s.fft_size}, sr={rate}")
    return 0


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

    pn = sub.add_parser("note", help="frequency → musical note (hover readout)")
    pn.add_argument("freq", type=float)
    pn.set_defaults(fn=cmd_note)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = _parser()
    if not argv:
        ap.print_usage(sys.stderr)
        return 2
    args = ap.parse_args(argv)
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
