"""Frequency → musical note naming: the Shift+hover readout (L4).

Reference: README.md:39 "Shift+hover shows musical note and frequency
information".  12-TET with A4 = 440 Hz; pure host math, no device
involvement (SURVEY.md §3.5).
"""

from __future__ import annotations

import math

NOTE_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")
A4_HZ = 440.0
A4_MIDI = 69


def frequency_to_note(freq_hz: float) -> tuple[str, int, float]:
    """→ (note name, octave, cents offset in [-50, 50))."""
    if freq_hz <= 0:
        raise ValueError("frequency must be positive")
    midi_float = A4_MIDI + 12.0 * math.log2(freq_hz / A4_HZ)
    midi = round(midi_float)
    cents = (midi_float - midi) * 100.0
    return NOTE_NAMES[midi % 12], midi // 12 - 1, cents


def note_to_frequency(name: str, octave: int) -> float:
    midi = NOTE_NAMES.index(name) + (octave + 1) * 12
    return A4_HZ * 2.0 ** ((midi - A4_MIDI) / 12.0)


def describe_frequency(freq_hz: float) -> str:
    """Hover-tooltip string, e.g. '440.0 Hz — A4 +0.0¢'."""
    name, octave, cents = frequency_to_note(freq_hz)
    return f"{freq_hz:.1f} Hz — {name}{octave} {cents:+.1f}¢"
