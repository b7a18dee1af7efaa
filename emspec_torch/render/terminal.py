"""Live terminal renderer (``emspec.render.terminal``): the scrolling
waterfall blitted to a terminal in 24-bit ANSI colour with the half-block
trick (▀ paints two vertical pixels a character cell).

The analysis runs on ``device`` through the port's ``Stream`` (one CUDA
graph replay a hop on the card) into the port's ``Waterfall``; reading
the waterfall's image is the one device→host copy a frame.  The ANSI
encoding itself is host-side numpy.
"""

from __future__ import annotations

import shutil
import sys

import numpy as np

_RESET = "\x1b[0m"
_HOME = "\x1b[H"
_CLEAR = "\x1b[2J"
_HIDE = "\x1b[?25l"
_SHOW = "\x1b[?25h"


def _downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, 4) → (out_h, out_w, 3) by nearest sampling (cheap, host)."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h) * h // out_h)
    xs = (np.arange(out_w) * w // out_w)
    return img[ys][:, xs, :3]


_U8_STR = np.array([str(i) for i in range(256)])   # uint8 → decimal text


def frame_to_ansi(img: np.ndarray, cols: int | None = None,
                  rows: int | None = None) -> str:
    """Render an (H, W, 4) uint8 raster as ANSI half-block art (one numpy
    table lookup and join a frame)."""
    term = shutil.get_terminal_size((100, 40))
    cols = cols or min(term.columns, 160)
    rows = rows or min(term.lines - 2, 50)
    px = _downsample(img, rows * 2, cols)           # 2 pixels per text row
    top = px[0::2][:rows]
    bot = px[1::2][:rows]
    t = _U8_STR[top]                                # (rows, cols, 3) strings
    b = _U8_STR[bot]
    add = np.char.add
    parts = ("\x1b[38;2;", t[..., 0], ";", t[..., 1], ";", t[..., 2],
             "m\x1b[48;2;", b[..., 0], ";", b[..., 1], ";", b[..., 2], "m▀")
    cells = parts[0]
    for p in parts[1:]:
        cells = add(cells, p)
    return "\n".join("".join(row) + _RESET for row in cells)


def _waterfall(s, width: int, device):
    from emspec_torch.render.waterfall import Waterfall
    from emspec_torch.tables import lut
    return Waterfall(width, s.raster_height, s.scroll_speed,
                     lut_table=lut(s.colormap), device=device)


def live_view(source, settings, width: int = 512,
              realtime: bool = True, out=None, device="cuda") -> int:
    """Stream audio through the live path on ``device``, painting the
    scrolling waterfall to the terminal at (about) audio rate.

    ``source`` is a WAV path or an already-decoded ``(audio, rate)`` pair;
    ``out`` defaults to the current ``sys.stdout``.  Returns the number
    of columns displayed."""
    import time

    from emspec_torch.io.wav import read_wav
    from emspec_torch.stream import Stream

    out = sys.stdout if out is None else out
    if isinstance(source, tuple):
        audio, rate = source
    else:
        audio, rate = read_wav(source)
    s = settings.replace(sample_rate=rate)
    stream = Stream(s, device)
    wf = _waterfall(s, width, stream.device)
    x = audio[0]
    chunk = max(rate // 30, 1024)                   # ~30 UI updates/sec
    n_cols = 0
    start = time.perf_counter()
    out.write(_CLEAR + _HIDE)
    try:
        for i in range(0, len(x), chunk):
            for col in stream.push(x[i:i + chunk]):
                wf.add_column(col.rgba, col.vis)
                n_cols += 1
            out.write(_HOME + frame_to_ansi(wf.image()) + "\n")
            out.flush()
            if realtime:                            # pace to audio time
                target = start + (i + chunk) / rate
                delay = target - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
        for col in stream.flush():
            wf.add_column(col.rgba, col.vis)
            n_cols += 1
        out.write(_HOME + frame_to_ansi(wf.image()) + "\n")
        out.flush()
    finally:
        out.write(_SHOW + _RESET)
        out.flush()
    return n_cols


def live_capture_view(settings, backend: str = "auto", duration: float = 10.0,
                      width: int = 512, out=None,
                      block: int = 512, capture_device=None, device="cuda",
                      on_open=None) -> int:
    """Live-capture terminal waterfall.

    The capture backend's callback thread is the ring's single producer;
    this thread is the single reader, draining analysis hops on
    ``device`` and painting at ~30 fps.  ``capture_device`` picks the
    audio input (a PortAudio index or name; ``emspec``'s ``device``);
    ``on_open`` is called with the capture source once it is open, so a
    caller can report which backend ``"auto"`` chose.  Returns the number
    of columns displayed."""
    import time

    from emspec_torch.io.capture import open_capture
    from emspec_torch.stream import Stream

    out = sys.stdout if out is None else out
    s = settings
    st = Stream(s, device)
    wf = _waterfall(s, width, st.device)
    ch = s.channels
    cap = open_capture(st.ring.push, backend=backend,
                       sample_rate=s.sample_rate, channels=ch, block=block,
                       device=capture_device)
    if on_open is not None:
        on_open(cap)
    empty = (np.zeros((ch, 0), np.float32) if ch > 1
             else np.zeros(0, np.float32))
    n_cols = 0
    out.write(_CLEAR + _HIDE)
    cap.start()
    try:
        t_end = time.perf_counter() + duration
        while time.perf_counter() < t_end:
            for col in st.push(empty):        # drain whatever has arrived
                one = col.rgba.ndim == 2
                wf.add_column(col.rgba if one else col.rgba[s.display_channel],
                              col.vis if one else col.vis[s.display_channel])
                n_cols += 1
            out.write(_HOME + frame_to_ansi(wf.image()) + "\n")
            out.flush()
            time.sleep(1.0 / 30.0)
    finally:
        cap.stop()
        out.write(_SHOW + _RESET)
        out.flush()
    return n_cols


def capture_backend(cap) -> str:
    """The backend name of an open capture source: ``"sounddevice"`` or
    ``"synthetic"``."""
    from emspec_torch.io.capture import SyntheticCapture
    return "synthetic" if isinstance(cap, SyntheticCapture) else "sounddevice"
