"""WAV file read/write (L1 ingest boundary).

The reference taps live system audio (reference: README.md:36); the rebuild's
ingest contract is WAV files and synthetic signals fed through the same
ring-buffer interface [NS configs[0]: "Mono 48 kHz WAV"].  Pure stdlib
``wave`` + numpy — supports PCM 8/16/24/32-bit and float32/float64, any
sane channel count; exotic bit depths are rejected with a clear error.
Samples are returned as float32 in [-1, 1), shape (channels, samples).
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file → (samples float32 (channels, n), sample_rate).

    Uses the native C++ decoder when available (proper RIFF chunk walking
    + format-tag handling, emspec/native); falls back to stdlib ``wave``.
    """
    try:
        from emspec_torch.native import lib as native
        if native.available():
            return native.read_wav(path)
    except Exception:
        pass  # any native hiccup falls through to the pure-Python path
    return _read_wav_py(path)


def _fmt_info(path: str | Path) -> tuple[int | None, int | None]:
    """RIFF fmt-chunk walk → (format tag, bits per sample) — tag 1 = PCM,
    3 = IEEE float; WAVE_FORMAT_EXTENSIBLE resolves through the SubFormat
    GUID — or (None, None) if the container can't be parsed.  Mirrors the
    native decoder's chunk walk so 32-bit PCM vs float32 is decided by
    the header, not by value sniffing (a PCM32 file whose bytes decode to
    small finite floats must not be misread as float data), and so exotic
    bit depths (12/20/float16…) are rejected instead of silently decoded
    at the nearest byte width."""
    import struct
    try:
        with open(path, "rb") as f:
            riff, _size, wave_id = struct.unpack("<4sI4s", f.read(12))
            if riff != b"RIFF" or wave_id != b"WAVE":
                return None, None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return None, None
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    body = f.read(min(csize, 40))
                    if len(body) < 16:
                        return None, None
                    tag = struct.unpack("<H", body[:2])[0]
                    bits = struct.unpack("<H", body[14:16])[0]
                    if tag == 0xFFFE and len(body) >= 26:
                        # extensible: real tag = first 2 bytes of SubFormat
                        tag = struct.unpack("<H", body[24:26])[0]
                    return tag, bits
                f.seek(csize + (csize & 1), 1)      # chunks are word-aligned
    except (OSError, struct.error):
        return None, None


def _read_wav_manual(path: str | Path) -> tuple[int, int, int, bytes, int]:
    """Minimal RIFF parse → (rate, channels, sample_width, data, fmt_tag).
    Handles containers stdlib ``wave`` rejects (IEEE float, extensible);
    the returned tag is already resolved through the extensible SubFormat
    GUID (1 = PCM, 3 = IEEE float)."""
    import struct
    # struct.error from short/lying header fields is re-raised as the
    # decoder's documented ValueError (fuzz contract, VERDICT r4 #5)
    try:
        with open(path, "rb") as f:
            riff, _, wave_id = struct.unpack("<4sI4s", f.read(12))
            if riff != b"RIFF" or wave_id != b"WAVE":
                raise ValueError(f"{path}: not a RIFF/WAVE file")
            rate = nch = width = tag = None
            data = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, csize = struct.unpack("<4sI", hdr)
                if cid == b"fmt ":
                    body = f.read(csize + (csize & 1))
                    tag, nch, rate, _bps, _align, bits = struct.unpack(
                        "<HHIIHH", body[:16])
                    if tag == 0xFFFE and len(body) >= 26:
                        tag = struct.unpack("<H", body[24:26])[0]
                    width = bits // 8
                elif cid == b"data":
                    data = f.read(csize)
                    if csize & 1:
                        f.seek(1, 1)          # chunks are word-aligned
                else:
                    f.seek(csize + (csize & 1), 1)
    except struct.error as e:
        raise ValueError(f"{path}: malformed WAV header") from e
    if rate is None or data is None or not nch:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return rate, nch, width, data, tag


def _read_wav_py(path: str | Path) -> tuple[np.ndarray, int]:
    hdr_tag, hdr_bits = _fmt_info(path)
    if hdr_bits is not None:
        # reject depths no decode branch handles BEFORE stdlib wave rounds
        # them to the nearest byte width (a 12-bit or float16 file would
        # otherwise "decode" as garbage int16 PCM)
        if hdr_bits not in (8, 16, 24, 32, 64):
            raise ValueError(f"unsupported WAV bit depth: {hdr_bits}")
        if hdr_tag == 3 and hdr_bits not in (32, 64):
            raise ValueError(
                f"unsupported float WAV bit depth: {hdr_bits} "
                f"(only float32/float64 supported)")
    tag = None
    try:
        with wave.open(str(path), "rb") as w:
            rate = w.getframerate()
            nch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        if not nch:
            raise ValueError(f"{path}: zero-channel WAV")
    except (wave.Error, EOFError, RuntimeError):
        # stdlib wave rejects IEEE-float / extensible containers outright
        # (and raises EOFError on truncated chunk headers, plus a bare
        # RuntimeError from Chunk.seek on lying chunk sizes — fuzz find)
        rate, nch, width, raw, tag = _read_wav_manual(path)

    if not rate:
        # a lying fmt chunk with rate=0 parses fine on both paths but
        # ZeroDivides every downstream consumer (feed.py paces on
        # sent / rate)
        raise ValueError(f"{path}: invalid sample rate 0")

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # PCM32 or IEEE float32: stdlib ``wave`` exposes no format tag, so
        # walk the fmt chunk ourselves (unless the manual parser already
        # resolved it); value sniffing (float32 audio stays within [-4, 4])
        # remains only as a last resort for broken headers.
        if tag is None:
            tag = hdr_tag             # from the walk done at entry
        if tag is None:
            as_f = np.frombuffer(raw, dtype="<f4")
            tag = 3 if (as_f.size and np.all(np.isfinite(as_f))
                        and np.abs(as_f).max() <= 4.0) else 1
        if tag == 3:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        else:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        i32 = np.where(i32 & 0x800000, i32 - 0x1000000, i32)
        data = i32.astype(np.float32) / 8388608.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 8 and (tag or hdr_tag) == 3:
        data = np.frombuffer(raw, dtype="<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")

    return np.ascontiguousarray(data.reshape(-1, nch).T), rate


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int,
              channels_first: bool | None = None) -> None:
    """Write float32 (channels, n) or (n,) samples as 16-bit PCM WAV.

    ``channels_first``: ``None`` (default) keeps the layout heuristic —
    a buffer with more "channels" than samples is rejected as a probably
    transposed (n, channels) array, which otherwise surfaces as a struct
    overflow deep inside the wave module.  A legitimately wide-but-short
    capture (e.g. a (128, 100) mic array) passes ``channels_first=True``
    to assert its layout; ``channels_first=False`` declares the input is
    (n, channels) and transposes it here."""
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 1:
        # 1-D is unambiguous mono: never transposed, whatever the
        # caller declared (a (n,) buffer under channels_first=False
        # would otherwise become an n-channel 1-sample file)
        x = x[None, :]
    elif channels_first is False and x.ndim == 2:
        x = np.ascontiguousarray(x.T)
    if (channels_first is None and x.ndim == 2
            and x.shape[0] > max(64, x.shape[1])):
        # channels ≫ samples: flagged only when the layout is clearly
        # transposed, so ordinary wide mic-array captures still write
        raise ValueError(
            f"write_wav expects (channels, n) or (n,) samples, got shape "
            f"{np.shape(samples)} — transpose a (n, channels) array, or "
            f"pass channels_first=True to assert this layout")
    if x.ndim != 2 or x.shape[0] > 65535:          # wave's real limit
        raise ValueError(
            f"write_wav expects (channels, n) or (n,) samples, got shape "
            f"{np.shape(samples)}")
    # non-finite samples would cast to garbage ints (with a numpy
    # RuntimeWarning): map NaN → 0 and ±Inf → full scale deterministically
    x = np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
    pcm = np.clip(x.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
