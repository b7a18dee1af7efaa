"""Live audio capture sources (closes the L1 ingest tail — VERDICT #5).

The reference taps system audio through its desktop shell
(reference: README.md:36 "automatically start visualizing your system
audio"); reproducing an OS loopback driver is out of scope (SURVEY.md
§2.4), but the *callback contract* is not: a capture source is anything
that invokes ``sink(chunk)`` with float32 ``(channels, k)`` sample blocks
at real-time rate from its own thread.  Two backends:

* ``sounddevice`` — a real input via the PortAudio binding, used when
  the optional ``sounddevice`` package is importable (not vendored; the
  CLI and tests skip cleanly without it).  Loopback/monitor inputs (the
  OS *output* tap — what the reference actually visualizes) are
  preferred over microphones where the host API exposes them;
  ``--device`` overrides.  A hardware rate that differs from the
  pipeline's structural ``sample_rate`` (44.1 kHz consumer devices into
  a 48 kHz pipeline) is adapted in the callback by a streaming polyphase
  resampler (``emspec/io/resample.py``) instead of recompiling the
  pipeline.
* ``synthetic`` — a thread that synthesizes a glide-plus-partials test
  signal and delivers it in capture-callback-sized blocks *paced to the
  sample clock*.  This is not just a test double: it exercises the exact
  producer path (thread → push → ring seqlock → overrun skip-ahead) a
  device callback uses, so the contract stays tested on machines with no
  audio hardware (every CI box, and this one).

Usage: ``python -m emspec live --capture [--backend synthetic]``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable

import numpy as np

Sink = Callable[[np.ndarray], None]


class CaptureUnavailable(RuntimeError):
    """Requested capture backend cannot run on this machine."""


class SyntheticCapture:
    """Real-time-paced synthetic capture source (callback producer).

    Generates a slow exponential glide plus two fixed partials and a
    noise floor — enough spectral movement to eyeball the live display —
    in ``block`` sized chunks delivered no faster than the sample clock.
    """

    def __init__(self, sink: Sink, sample_rate: int = 48_000,
                 channels: int = 1, block: int = 512):
        self.sink = sink
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.block = int(block)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        sr = self.sample_rate
        pos = 0
        phase = 0.0
        t0 = time.perf_counter()
        while not self._stop.is_set():
            n = self.block
            t = (pos + np.arange(n)) / sr
            # glide 110 Hz → 1760 Hz over 8 s, wrapped (phase-continuous)
            f = 110.0 * (16.0 ** ((t % 8.0) / 8.0))
            phase_inc = 2 * np.pi * f / sr
            ph = phase + np.cumsum(phase_inc)
            phase = float(ph[-1] % (2 * np.pi))
            x = (0.5 * np.sin(ph)
                 + 0.15 * np.sin(2 * np.pi * 440.0 * t)
                 + 0.1 * np.sin(2 * np.pi * 2500.0 * t)
                 + 0.005 * np.random.default_rng(pos).standard_normal(n))
            chunk = np.broadcast_to(
                x.astype(np.float32), (self.channels, n)).copy()
            if self.channels > 1:
                # distinct per-channel levels so multichannel views and
                # the display-channel switch are visibly different
                chunk *= (1.0 - 0.6 * np.arange(self.channels)
                          / max(self.channels - 1, 1))[:, None]
            self.sink(chunk)
            pos += n
            # pace to the sample clock (a real device callback arrives at
            # exactly this cadence)
            target = t0 + pos / sr
            delay = target - time.perf_counter()
            if delay > 0:
                time.sleep(delay)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def find_loopback_device(sd, channels: int = 1) -> tuple[int, str] | None:
    """Locate an OS *output* tap among PortAudio's input devices.

    The reference visualizes **system audio** (README.md:36), not a
    microphone.  Where the host API exposes the output as a capturable
    input — PulseAudio/PipeWire "Monitor of …" / "….monitor" sources,
    WASAPI "… [Loopback]" endpoints — prefer it.  Only sources that can
    supply the requested ``channels`` qualify (a 1-channel monitor must
    not shadow the default input for a stereo capture).  Returns
    ``(device_index, device_name)`` or None when the platform exposes no
    loopback path (then the default input is the honest fallback)."""
    try:
        devices = sd.query_devices()
    except Exception:
        return None
    for i, d in enumerate(devices):
        try:
            name = str(d["name"])
            if int(d["max_input_channels"]) < max(1, int(channels)):
                continue
        except (KeyError, TypeError, ValueError):
            continue
        low = name.lower()
        if ("monitor of" in low or low.endswith(".monitor")
                or "loopback" in low):
            return i, name
    return None


class SoundDeviceCapture:
    """System-audio / microphone input via the optional ``sounddevice``
    package (PortAudio).  The callback pushes float32 (channels, k)
    blocks into the sink — the same contract as SyntheticCapture.

    With ``device=None`` a loopback/monitor input (the OS output tap —
    what the reference actually visualizes) is preferred when the host
    API exposes one; pass ``device`` (index or PortAudio name substring)
    to override."""

    def __init__(self, sink: Sink, sample_rate: int = 48_000,
                 channels: int = 1, block: int = 512, device=None,
                 prefer_loopback: bool = True):
        try:
            import sounddevice as sd
        except ImportError as e:
            raise CaptureUnavailable(
                "the 'sounddevice' package is not installed; use "
                "--backend synthetic or install sounddevice") from e
        self._sd = sd
        self.sink = sink
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.block = int(block)
        self.device_name: str | None = None
        self.is_loopback = False
        self._auto_loopback = False     # we picked it — allowed to back out
        if device is None and prefer_loopback:
            found = find_loopback_device(sd, self.channels)
            if found is not None:
                device, self.device_name = found
                self.is_loopback = True
                self._auto_loopback = True
        self.device = device
        self.device_rate: int | None = None    # set by start()
        self._resampler = None
        self._stream = None

    def _pick_device_rate(self) -> int:
        """Open at the pipeline rate when the hardware supports it, else
        at the device's native rate with a streaming resampler in the
        callback.  The pipeline rate is a structural (recompiling)
        setting — adapting the audio to the pipeline, not the pipeline to
        the device, keeps the capture-rate question out of the jit
        cache."""
        sd = self._sd
        try:
            sd.check_input_settings(device=self.device,
                                    samplerate=self.sample_rate,
                                    channels=self.channels)
            return self.sample_rate
        except Exception:
            pass
        try:
            info = sd.query_devices(self.device, "input")
            native = int(round(float(info["default_samplerate"])))
            if native > 0:
                return native
        except Exception:
            pass
        return self.sample_rate        # let InputStream surface the error

    def _callback(self, indata, frames, time_info, status) -> None:
        # indata: (frames, channels) float32 → (channels, frames)
        chunk = np.ascontiguousarray(indata.T, dtype=np.float32)
        if self._resampler is not None:
            chunk = self._resampler.process(chunk)
            if chunk.shape[-1] == 0:
                return
        self.sink(chunk)

    def _open(self) -> None:
        self.device_rate = self._pick_device_rate()
        self._resampler = None
        if self.device_rate != self.sample_rate:
            from emspec_torch.io.resample import StreamingResampler
            self._resampler = StreamingResampler(self.device_rate,
                                                 self.sample_rate)
        self._stream = self._sd.InputStream(
            samplerate=self.device_rate, channels=self.channels,
            blocksize=self.block, dtype="float32", device=self.device,
            callback=self._callback)
        self._stream.start()

    def start(self) -> None:
        try:
            self._open()
        except Exception:
            # release a stream that opened but failed to start — on
            # exclusive-access host APIs a leaked open handle can make
            # the fallback open fail too
            if self._stream is not None:
                try:
                    self._stream.close()
                except Exception:
                    pass
                self._stream = None
            if not self._auto_loopback:
                raise
            # the auto-preferred monitor source failed to open (monitor
            # endpoints vary wildly in rate/channel capabilities) — fall
            # back to the default input instead of breaking a capture the
            # pre-preference path would have served
            self.device = None
            self.device_name = None
            self.is_loopback = False
            self._auto_loopback = False
            self._open()

    def stop(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None


def open_capture(sink: Sink, backend: str = "auto", sample_rate: int = 48_000,
                 channels: int = 1, block: int = 512, device=None):
    """Capture factory.  ``auto`` prefers a real device (sounddevice) and
    falls back to the synthetic source so ``emspec live --capture`` always
    shows something.

    Among real devices, a loopback/monitor input — the OS output tap the
    reference visualizes (README.md:36 "your system audio") — is
    preferred where the PortAudio host API exposes one (WASAPI loopback
    endpoints, PulseAudio/PipeWire monitor sources); ``device`` (index or
    name) overrides the selection."""
    if backend not in ("auto", "sounddevice", "synthetic"):
        raise ValueError(f"unknown capture backend: {backend!r}")
    if backend in ("auto", "sounddevice"):
        try:
            return SoundDeviceCapture(sink, sample_rate, channels, block,
                                      device=device)
        except CaptureUnavailable:
            if backend == "sounddevice":
                raise
    return SyntheticCapture(sink, sample_rate, channels, block)
