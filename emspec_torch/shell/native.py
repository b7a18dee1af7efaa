"""Native always-on-top desktop window (tkinter, stdlib) over the port's
``EmSpecApp`` (``emspec.shell.native``).

A browser tab can surface the On-Top setting but cannot float above
other windows; this shell can, because tkinter drives a real OS window:

* frameless (``overrideredirect``) with click-drag moving,
* OS always-on-top via ``wm_attributes("-topmost", …)``, bound live to
  the ``on_top`` setting,
* minimize/restore mirrored from ``live_state.json`` through the app's
  window hooks (withdraw/deiconify: an overrideredirect window has no
  taskbar icon to iconify to),
* Shift+hover note/frequency readout in the status bar,
* the same :class:`~emspec_torch.shell.feed.AudioFeeder` producer as the
  web shell.

Keys: ``Esc`` quits, ``t`` toggles On-Top, ``e``/``n`` switch
Enhanced/Natural, ``space`` pauses/resumes.

Everything Tk-facing goes through an injected module handle, so tests
drive the window logic headlessly with a fake.  Where Tk cannot open a
window (no display, no tkinter), ``run_native`` raises
``NativeUnavailable`` and ``python -m emspec_torch gui --native`` falls
back to the web shell: a fallback of the user interface, not of the
device, which stays the caller's.
"""

from __future__ import annotations

import threading
import time

import numpy as np


def rgba_to_ppm(img: np.ndarray) -> bytes:
    """(rows, width, 4) uint8 RGBA → binary PPM (P6) bytes.

    ``tk.PhotoImage(data=…)`` accepts P6 directly, which makes the blit a
    single memcpy-shaped conversion (alpha is dropped; the waterfall is
    opaque).  Pure function so the encoding is testable without Tk."""
    if img.ndim != 3 or img.shape[2] < 3 or img.dtype != np.uint8:
        raise ValueError(f"expected (rows, width, >=3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    header = f"P6 {w} {h} 255\n".encode()
    return header + np.ascontiguousarray(img[..., :3]).tobytes()


def hover_row(y: float, height: float, rows: int) -> int:
    """Window y-coordinate → display row index, matching the web shell's
    orientation (frac = 1 − y/height, top of the window = highest row)."""
    if height <= 0 or rows <= 0:
        return 0
    frac = 1.0 - y / height
    return int(np.clip(round(frac * (rows - 1)), 0, rows - 1))


class NativeWindow:
    """Frameless on-top Tk window over an :class:`EmSpecApp`.

    ``tk`` is the tkinter module; tests inject a fake implementing
    ``Tk``/``Label``/``PhotoImage``.  The Tk event loop is the only
    consumer thread: the periodic ``after`` tick drains analysis hops and
    re-blits, while the feeder thread stays the ring's single producer.
    """

    TICK_MS = 33          # ~30 fps drain/blit cadence

    def __init__(self, app, tk=None, feeder=None):
        if tk is None:
            import tkinter as tk_mod
            tk = tk_mod
        self.tk = tk
        self.app = app
        self.feeder = feeder
        self.root = tk.Tk()
        self.root.title("emspec")
        self.root.overrideredirect(True)
        self._apply_on_top()
        self._photo = None
        self.image_label = tk.Label(self.root, borderwidth=0)
        self.image_label.pack()
        self.status = tk.Label(self.root, anchor="w")
        self.status.pack(fill="x")
        self._drag_origin = None
        self._closed = False
        self._status_text("emspec — Esc quit · t on-top · e/n mode "
                          "· space pause")
        # mirroring the Info View: the app pauses/resumes the stream;
        # the window adds the real window op
        app.on_minimized = self.root.withdraw
        app.on_restored = self.root.deiconify
        # bindings: drag anywhere on the raster, hover with Shift
        self.image_label.bind("<Button-1>", self._on_press)
        self.image_label.bind("<B1-Motion>", self._on_drag)
        self.image_label.bind("<Motion>", self._on_motion)
        self.root.bind("<Escape>", lambda e: self.close())
        self.root.bind("t", lambda e: self._toggle_on_top())
        self.root.bind("e", lambda e: self._set_mode("enhanced"))
        self.root.bind("n", lambda e: self._set_mode("natural"))
        self.root.bind("<space>", lambda e: self._toggle_pause())
        self.root.after(self.TICK_MS, self._tick)

    # ----------------------------------------------------------- internals
    def _status_text(self, text: str) -> None:
        self.status.configure(text=text)

    def _apply_on_top(self) -> None:
        self.root.wm_attributes("-topmost",
                                1 if self.app.settings.on_top else 0)

    def _toggle_on_top(self) -> None:
        self.app.set(on_top=not self.app.settings.on_top)
        self._apply_on_top()
        self._status_text(
            f"On-Top {'on' if self.app.settings.on_top else 'off'}")

    def _set_mode(self, mode: str) -> None:
        kind = self.app.set(mode=mode)
        self._status_text(f"mode = {mode} ({kind})")

    def _toggle_pause(self) -> None:
        st = self.app.stream
        if st._paused:
            st.resume()
            self._status_text("resumed")
        else:
            st.pause()
            self._status_text("paused")

    # drag-to-move: the window is frameless, the raster IS the title bar
    def _on_press(self, event) -> None:
        self._drag_origin = (event.x, event.y)

    def _on_drag(self, event) -> None:
        if self._drag_origin is None:
            return
        dx, dy = self._drag_origin
        self.root.geometry(f"+{event.x_root - dx}+{event.y_root - dy}")

    def _on_motion(self, event) -> None:
        if not (getattr(event, "state", 0) & 0x0001):   # Shift held?
            return
        # the label blits the waterfall 1:1, so the window height in pixels
        # IS the display row count: app.image() here would copy the whole
        # waterfall from the device on every mouse move
        rows = self.app.settings.raster_height
        row = hover_row(event.y, rows, rows)
        self._status_text(self.app.hover(row))

    def _tick(self) -> None:
        if self._closed:
            return
        ch = self.app.settings.channels
        empty = (np.zeros((ch, 0), np.float32) if ch > 1
                 else np.zeros(0, np.float32))
        if self.app.push_audio(empty):
            self.blit()
        self.root.after(self.TICK_MS, self._tick)

    # -------------------------------------------------------------- public
    def blit(self) -> None:
        """Encode the current waterfall and swap it into the label.  The
        PhotoImage reference is pinned on self (Tk only keeps a weak
        association through the widget option)."""
        self._photo = self.tk.PhotoImage(data=rgba_to_ppm(self.app.image()))
        self.image_label.configure(image=self._photo)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.app.close()      # abandon queued prewarm jobs
        if self.feeder is not None:
            self.feeder.stop()
        self.root.destroy()

    def run(self) -> None:
        if self.feeder is not None:
            self.feeder.start()
        self.blit()
        self.root.mainloop()


def run_native(settings=None, source: str = "auto",
               wav_path: str | None = None, user_dir: str = ".emspec",
               prewarm_sizes: tuple | None = None, device="cuda",
               capture_device=None):
    """``gui --native`` entry: build app + feeder + window and run the Tk
    loop, the app on ``device``.  Raises ``NativeUnavailable`` when Tk
    cannot open a display (or is not installed) so the CLI can fall back
    to the web shell."""
    try:
        import tkinter
    except ImportError as e:        # slim installs ship no python3-tk
        raise NativeUnavailable(str(e)) from e
    from emspec_torch.app import EmSpecApp
    from emspec_torch.shell.feed import AudioFeeder

    app = EmSpecApp(settings, user_dir=user_dir,
                    prewarm_sizes=prewarm_sizes, device=device)
    feeder = AudioFeeder(app, source=source, wav_path=wav_path,
                         capture_device=capture_device)
    try:
        win = NativeWindow(app, tk=tkinter, feeder=feeder)
    except tkinter.TclError as e:
        # abandon this app's queued prewarm jobs before the CLI builds the
        # fallback web shell's own app, or they hold interpreter exit
        app.close()
        raise NativeUnavailable(str(e)) from e
    win.run()


class NativeUnavailable(RuntimeError):
    """Tk cannot open a window here (headless / no $DISPLAY)."""
