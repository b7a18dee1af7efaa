"""Audio feeder: the single ring producer behind both window shells
(``emspec.shell.feed``).

A thread loops a WAV at its real-time rate, or a capture source
(sounddevice, preferring a loopback/monitor input, else the synthetic
source) delivers float32 ``(channels, k)`` blocks; either way they go
into the ring of the app's current stream.  Host-side only: the card
sees the samples when the drain stages a hop.

Thread model: the feeder thread is the ring's single producer; it only
touches ``app.stream.ring`` (seqlock-protected) and — to adopt a WAV's
rate and channel count at startup — ``app.apply_settings`` under the
shared ``lock``.
"""

from __future__ import annotations

import threading
import time

import numpy as np


class AudioFeeder:
    """Feeds ``app``'s ring from a WAV loop or a live capture source.

    ``source`` is ``"wav"`` (requires ``wav_path``), ``"auto"``,
    ``"sounddevice"`` or ``"synthetic"`` — the non-WAV values are capture
    backends for :func:`emspec_torch.io.capture.open_capture`.
    ``capture_device`` picks the audio input (``emspec``'s ``device``).
    After ``start``, ``backend`` names what feeds the ring: ``"wav"``,
    ``"sounddevice"`` or ``"synthetic"`` (what ``"auto"`` chose).
    """

    def __init__(self, app, source: str = "auto", wav_path: str | None = None,
                 lock: threading.RLock | None = None, capture_device=None):
        self.app = app
        self.source = source
        self.wav_path = wav_path
        self.lock = lock if lock is not None else threading.RLock()
        self.capture_device = capture_device
        self.backend: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._capture = None

    # ------------------------------------------------------------- plumbing
    def _ring_push(self, chunk: np.ndarray) -> None:
        # the app's stream is swapped on structural changes: resolve it at
        # call time and adapt the chunk's channel count, so a running
        # capture survives a channels change (a shape mismatch would kill
        # the producer thread silently)
        st = self.app.stream
        if st.channels == 1:
            if chunk.ndim == 2:
                chunk = chunk[0]
        else:
            if chunk.ndim == 1:
                chunk = chunk[None]
            have = chunk.shape[0]
            if have > st.channels:
                chunk = chunk[:st.channels]
            elif have < st.channels:
                reps = -(-st.channels // have)
                chunk = np.tile(chunk, (reps, 1))[:st.channels]
        st.ring.push(chunk)

    def _load_wav(self):
        from emspec_torch.io.wav import read_wav
        audio, rate = read_wav(self.wav_path)
        s = self.app.settings
        if rate != s.sample_rate or audio.shape[0] != s.channels:
            with self.lock:
                self.app.apply_settings(s.replace(
                    sample_rate=rate, channels=audio.shape[0],
                    display_channel=min(s.display_channel,
                                        audio.shape[0] - 1)))
        return audio.astype(np.float32), rate

    def _wav_loop(self, x_all: np.ndarray, rate: int,
                  stop: threading.Event) -> None:
        pos = 0
        block = max(rate // 50, 256)
        t0 = time.perf_counter()
        sent = 0
        total = x_all.shape[-1]
        while not stop.is_set():
            # wrap-around take of exactly `block` samples: a file shorter
            # than a block still loops, and still paces
            idx = (pos + np.arange(block)) % total
            chunk = np.ascontiguousarray(x_all[..., idx])
            self._ring_push(chunk)
            pos = (pos + block) % total
            sent += block
            delay = t0 + sent / rate - time.perf_counter()
            if delay > 0:
                time.sleep(delay)

    # -------------------------------------------------------------- control
    def start(self) -> None:
        # a FRESH stop event each start: a previous thread that outlived
        # stop()'s join keeps its own (set) event and still exits, so two
        # producers never share the single-producer ring
        self._stop = threading.Event()
        if self.source == "wav":
            x_all, rate = self._load_wav()
            self._thread = threading.Thread(
                target=self._wav_loop, args=(x_all, rate, self._stop),
                daemon=True)
            self._thread.start()
            self.backend = "wav"
        else:
            from emspec_torch.io.capture import open_capture
            from emspec_torch.render.terminal import capture_backend
            s = self.app.settings
            self._capture = open_capture(
                self._ring_push, backend=self.source,
                sample_rate=s.sample_rate, channels=s.channels,
                device=self.capture_device)
            self._capture.start()
            self.backend = capture_backend(self._capture)

    def stop(self) -> None:
        self._stop.set()
        if self._capture is not None:
            self._capture.stop()
            self._capture = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
