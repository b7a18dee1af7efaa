"""Synthetic test signals (tones, chirps, impulses, noise) — the in-repo
fixture generator (SURVEY.md §4.2: "Synthetic WAVs generated in-repo …
no binary fixtures")."""

from __future__ import annotations

import numpy as np


def tone(freq_hz: float, seconds: float, sample_rate: int = 48_000,
         amplitude: float = 0.5, phase: float = 0.0) -> np.ndarray:
    t = np.arange(int(round(seconds * sample_rate)), dtype=np.float64) / sample_rate
    return (amplitude * np.sin(2 * np.pi * freq_hz * t + phase)).astype(np.float32)


def chirp(f0_hz: float, f1_hz: float, seconds: float, sample_rate: int = 48_000,
          amplitude: float = 0.5) -> np.ndarray:
    """Linear chirp: instantaneous frequency f(t) = f0 + (f1-f0)·t/T."""
    num = int(round(seconds * sample_rate))
    t = np.arange(num, dtype=np.float64) / sample_rate
    k = (f1_hz - f0_hz) / seconds
    phase = 2 * np.pi * (f0_hz * t + 0.5 * k * t * t)
    return (amplitude * np.sin(phase)).astype(np.float32)


def impulse(at_sample: int, num_samples: int, amplitude: float = 1.0) -> np.ndarray:
    x = np.zeros(num_samples, dtype=np.float32)
    x[at_sample] = amplitude
    return x


def noise(seconds: float, sample_rate: int = 48_000, amplitude: float = 0.1,
          seed: int = 0) -> np.ndarray:
    num = int(round(seconds * sample_rate))
    rng = np.random.default_rng(seed)
    return (amplitude * rng.standard_normal(num)).astype(np.float32)


def silence(seconds: float, sample_rate: int = 48_000) -> np.ndarray:
    return np.zeros(int(round(seconds * sample_rate)), dtype=np.float32)


def multitone(freqs_hz, seconds: float, sample_rate: int = 48_000,
              amplitude: float = 0.3) -> np.ndarray:
    out = np.zeros(int(round(seconds * sample_rate)), dtype=np.float32)
    for f in freqs_hz:
        out += tone(f, seconds, sample_rate, amplitude / max(len(freqs_hz), 1))
    return out
