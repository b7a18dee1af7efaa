"""Window shell: a zero-dependency local web shell over ``EmSpecApp``
(``emspec.shell.server``), with the app on ``device`` (the card unless
the caller asks for the CPU).

``python -m emspec_torch gui`` serves the live display and the full
settings panel at http://127.0.0.1:<port>/; every endpoint is testable
without a browser.  ``/api/meta`` reports the torch device (``"cuda"``
and the card's name, or ``"cpu"``).

Threading model: the capture/WAV feeder thread is the ring's single
producer; one worker thread drains analysis hops (a CUDA graph replay
each on the card) and paints the waterfall; HTTP handler threads only
read snapshots or apply settings — every ``EmSpecApp`` mutation happens
under one lock, so a structural change's new ``Stream`` (its warm-up
hops and graph capture) never overlaps a drain tick.  A tick holds the
lock for the pending hops up to ``DRAIN_HOLD_S`` (one hop at least),
then lets every thread waiting for the lock take it before the next
batch: a backlog (a host that fell behind, a stall) never keeps a
settings POST or ``/api/frame`` waiting for more than one batch.  A prewarm job runs
outside that lock and takes turns with a capture through
``device.CARD_LOCK``.  The drain worker keeps the wall of each tick that
painted (``tick_ms``, the most recent 10,000) and counts the columns it
painted under the lock (``columns_emitted``), so a reader holding the
lock sees them consistent with the stream's ring.
"""

from __future__ import annotations

import collections
import json
import struct
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from emspec_torch.app import EmSpecApp
from emspec_torch.config import COLORMAPS, FFT_SIZES, Settings


class _QuietServer(ThreadingHTTPServer):
    """A client that hangs up mid-response (tab closed, request timeout)
    is normal desktop-app traffic, not a server fault: its connection
    errors are swallowed; every other handler exception still gets the
    default report."""

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return
        super().handle_error(request, client_address)


DRAIN_HOLD_S = 0.004        # a drain batch: hops until 4 ms have passed
STEP_ASIDE_S = 0.05         # ... then the most it waits for waiting threads


class _AppLock:
    """The app lock: a re-entrant lock that counts the threads waiting
    for it, so the drain worker can step aside for them between
    batches (a plain lock may be taken again by the thread that just
    released it, before a waiter wakes)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._count = threading.Lock()
        self.waiting = 0

    def __enter__(self):
        with self._count:
            self.waiting += 1
        try:
            self._lock.acquire()
        finally:
            with self._count:
                self.waiting -= 1
        return self

    def __exit__(self, *exc):
        self._lock.release()


class ShellServer:
    """Owns the app, the feeder, the drain worker, and the HTTP server."""

    def __init__(self, settings: Settings | None = None, port: int = 0,
                 source: str = "auto", wav_path: str | None = None,
                 user_dir: str = ".emspec",
                 prewarm_sizes: tuple | None = None, device="cuda",
                 capture_device=None):
        # prewarm_sizes: warm the FFT-size dropdown in a background worker
        # so a structural change stalls the display as little as it can;
        # the CLI passes the dropdown, tests keep it off
        self.app = EmSpecApp(settings, user_dir=user_dir,
                             prewarm_sizes=prewarm_sizes, device=device)
        dev = self.app.device
        self.device_name = (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")
        self.lock = _AppLock()
        self._stop = threading.Event()
        # frame push: the drain worker bumps the sequence whenever new
        # columns landed; /api/stream connections wait on the condition
        self._frame_seq = 0
        self._frame_cv = threading.Condition()
        self.columns_emitted = 0     # lifetime drain total
        self.tick_ms = collections.deque(maxlen=10_000)
        from emspec_torch.shell.feed import AudioFeeder
        self.feeder = AudioFeeder(self.app, source=source, wav_path=wav_path,
                                  lock=self.lock,
                                  capture_device=capture_device)
        self._worker = None
        # async update check on startup, its notice in the settings
        # header (offline-safe: no manifest configured, no notice)
        from emspec_torch.utils.update import UpdateChecker
        self.update_check = UpdateChecker()
        self.httpd = _QuietServer(("127.0.0.1", port),
                                  self._make_handler())
        self.port = self.httpd.server_address[1]

    # --------------------------------------------------------------- feeding
    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            pending = True
            while pending and not self._stop.is_set():
                with self.lock:
                    t0 = time.perf_counter()
                    emitted, pending = self.app._drain_until(
                        t0 + DRAIN_HOLD_S)
                    if emitted:
                        self.columns_emitted += emitted
                        self.tick_ms.append((time.perf_counter() - t0) * 1e3)
                if emitted:
                    with self._frame_cv:
                        self._frame_seq += 1
                        self._frame_cv.notify_all()
                self._step_aside()
            time.sleep(1.0 / 60.0)

    def _step_aside(self) -> None:
        """Wait (at most ``STEP_ASIDE_S``) until no thread waits for the
        app lock, so a request is served between two drain batches."""
        end = time.perf_counter() + STEP_ASIDE_S
        while self.lock.waiting and time.perf_counter() < end:
            time.sleep(0.0002)

    # --------------------------------------------------------------- control
    def start(self) -> None:
        self.feeder.start()
        self._worker = threading.Thread(target=self._drain_loop, daemon=True)
        self._worker.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        self.app.close()      # abandon queued prewarm jobs
        self.feeder.stop()
        if self._worker is not None:
            # join the drain worker: no daemon thread is left mid-launch
            # on the card at interpreter teardown
            self._worker.join(timeout=5.0)
            self._worker = None
        self.httpd.shutdown()
        self.httpd.server_close()

    def serve_forever(self, duration: float = 0.0) -> None:
        """Blocking run; duration 0 = until KeyboardInterrupt."""
        self.start()
        self.wait(duration)

    def wait(self, duration: float = 0.0) -> None:
        """Block a started server for ``duration`` seconds (0: until
        KeyboardInterrupt), then stop it."""
        try:
            if duration > 0:
                time.sleep(duration)
            else:
                while True:
                    time.sleep(1.0)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # ------------------------------------------------------------------ HTTP
    def _make_handler(self):
        shell = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # quiet
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code: int = 200):
                self._send(json.dumps(obj).encode(), "application/json", code)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                app = shell.app
                if url.path == "/":
                    from emspec_torch.shell.page import PAGE
                    self._send(PAGE.encode(), "text/html; charset=utf-8")
                elif url.path == "/api/meta":
                    from emspec_torch import __version__
                    self._json({"version": __version__,
                                "backend": app.device.type,
                                "device": shell.device_name,
                                "fft_sizes": list(FFT_SIZES),
                                "colormaps": list(COLORMAPS),
                                # a browser tab can't be topmost: only the
                                # native window honors On-Top, so the page
                                # disables the button
                                "on_top_supported": False,
                                "update": shell.update_check.notice})
                elif url.path == "/api/settings":
                    self._json(app.settings.to_dict())
                elif url.path == "/api/frame":
                    with shell.lock:
                        img = app.image()            # (rows, width, 4)
                    body = (struct.pack(">II", img.shape[0], img.shape[1])
                            + np.ascontiguousarray(img).tobytes())
                    self._send(body, "application/octet-stream")
                elif url.path == "/api/state":
                    self._json({"paused": app.stream._paused,
                                "on_top": app.settings.on_top,
                                "dropped_frames": app.stream.dropped_frames,
                                "update": shell.update_check.notice})
                elif url.path == "/api/axis":
                    with shell.lock:
                        self._json(app.axis_ticks())
                elif url.path == "/api/stream":
                    # chunked binary frame push (stdlib analog of a
                    # WebSocket): length-implicit (h, w)-prefixed RGBA
                    # frames until the client disconnects, pushed when
                    # columns land (throttled to ~30 fps)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    last = -1
                    while not shell._stop.is_set():
                        with shell._frame_cv:
                            if shell._frame_seq == last:
                                shell._frame_cv.wait(timeout=0.25)
                            seq = shell._frame_seq
                        if seq == last:
                            continue        # idle wakeup, nothing new
                        last = seq
                        with shell.lock:
                            img = app.image()
                        body = (struct.pack(">II", img.shape[0],
                                            img.shape[1])
                                + np.ascontiguousarray(img).tobytes())
                        try:
                            self.wfile.write(body)
                            self.wfile.flush()
                        except (BrokenPipeError, ConnectionResetError,
                                ConnectionAbortedError):
                            break
                        time.sleep(1.0 / 30.0)
                elif url.path == "/api/record":
                    # the scrolling display recorded to an APNG: frames
                    # snapshotted at fps on this handler thread and
                    # compressed one at a time (render/apng.py
                    # apng_bytes), so a 30 s recording never holds the
                    # raw frame stack
                    from emspec_torch.render.apng import apng_bytes
                    try:
                        seconds = float(q.get("seconds", ["2"])[0])
                        fps = float(q.get("fps", ["15"])[0])
                    except ValueError:
                        self._json({"error": "seconds/fps must be numbers"},
                                   400)
                        return
                    if not (0 < seconds <= 60) or not (0 < fps <= 60):
                        self._json({"error": "need 0 < seconds <= 60 and "
                                             "0 < fps <= 60"}, 400)
                        return
                    n = max(1, round(seconds * fps))
                    t0 = time.monotonic()

                    def snapshots():
                        first_shape = None
                        for k in range(1, n + 1):
                            dt = t0 + k / fps - time.monotonic()
                            if dt > 0:
                                time.sleep(dt)
                            if shell._stop.is_set() and k > 1:
                                return       # truncated but valid APNG
                            with shell.lock:
                                img = app.image()
                            if first_shape is None:
                                first_shape = img.shape
                            elif img.shape != first_shape:
                                # a structural change landed
                                # mid-recording (channels/raster size):
                                # stop at the last matching frame, a
                                # truncated but valid APNG
                                return
                            yield img

                    self._send(apng_bytes(snapshots(), fps=fps),
                               "image/apng")
                elif url.path == "/api/hover":
                    try:
                        frac = float(q.get("frac", ["0"])[0])
                    except ValueError:
                        self._json({"error": "frac must be a number"}, 400)
                        return
                    if not np.isfinite(frac):
                        frac = 0.0
                    rows = app.settings.raster_height
                    row = int(np.clip(round(frac * (rows - 1)), 0, rows - 1))
                    with shell.lock:
                        text = app.hover(row)
                    self._send(text.encode(), "text/plain; charset=utf-8")
                elif url.path == "/api/presets":
                    self._json(app.presets.names())
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                app = shell.app
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b"{}"
                if url.path == "/api/settings":
                    try:
                        changes = json.loads(body)
                        with shell.lock:
                            kind = app.set(**changes)
                    except (ValueError, TypeError) as e:
                        self._json({"error": str(e)}, 400)
                        return
                    except Exception as e:          # noqa: BLE001
                        # a value the Settings validation did not
                        # anticipate: app.set is exception-safe (state
                        # unchanged), so answer with JSON, not a dead
                        # socket
                        self._json({"error": f"{type(e).__name__}: {e}"},
                                   500)
                        return
                    self._json({"kind": kind,
                                "settings": app.settings.to_dict(),
                                "update": shell.update_check.notice})
                elif url.path.startswith("/api/preset/"):
                    op = url.path.rsplit("/", 1)[1]
                    name = q.get("name", ["Default"])[0]
                    try:
                        with shell.lock:
                            if op == "save":
                                app.save_preset(name)
                                kind = "saved"
                            elif op == "load":
                                kind = app.load_preset(name)
                            elif op == "delete":
                                app.delete_preset(name)
                                kind = "deleted"
                            else:
                                self._json({"error": "unknown op"}, 404)
                                return
                    except (KeyError, ValueError) as e:
                        self._json({"error": str(e)}, 400)
                        return
                    self._json({"kind": kind,
                                "settings": app.settings.to_dict()})
                else:
                    self._json({"error": "not found"}, 404)

        return Handler
