"""Max-for-Live integration: the ``live_state.json`` contract (L6).

Reference mechanism (docs/MAX-FOR-LIVE.md): the M4L device in Ableton
writes a state file in the app's userData dir containing ``"minimized"``
or ``"restored"``; the app watches the file and minimizes/restores its
window to mirror Ableton's Info View.  The file is auto-created on first
launch, and a missing file is recreated rather than erroring
(MAX-FOR-LIVE.md "Troubleshooting" — the failure contract, SURVEY.md §5.3).

Rebuild equivalent: the watcher pauses/resumes a ``Stream`` on state
change [INF: the display is the only consumer; pausing analysis is the
minimized behavior].  Poll-based (the reference is an FS watcher; polling
keeps this dependency-free and testable).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

STATE_MINIMIZED = "minimized"
STATE_RESTORED = "restored"
_VALID = (STATE_MINIMIZED, STATE_RESTORED)


def ensure_state_file(path: str | Path) -> Path:
    """Create the state file with 'restored' if missing (first-launch
    contract)."""
    p = Path(path)
    if not p.exists():
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"state": STATE_RESTORED}))
    return p


def read_state(path: str | Path) -> str:
    """Current state; malformed/missing file falls back to 'restored'
    (and recreates it), never raises."""
    p = Path(path)
    try:
        raw = json.loads(p.read_text())
        state = raw["state"] if isinstance(raw, dict) else raw
        if state in _VALID:
            return state
    except (OSError, json.JSONDecodeError, KeyError, TypeError):
        pass
    ensure_state_file(p)
    return STATE_RESTORED


def write_state(path: str | Path, state: str) -> None:
    if state not in _VALID:
        raise ValueError(f"state must be one of {_VALID}")
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({"state": state}))


class LiveStateWatcher:
    """Polls the state file; fires callbacks on transitions.

    >>> w = LiveStateWatcher(path, on_minimized=stream.pause,
    ...                      on_restored=stream.resume)
    >>> w.poll()   # call periodically from the app loop
    """

    def __init__(self, path: str | Path,
                 on_minimized: Callable[[], None] | None = None,
                 on_restored: Callable[[], None] | None = None):
        self.path = ensure_state_file(path)
        self.on_minimized = on_minimized
        self.on_restored = on_restored
        self._last = read_state(self.path)

    @property
    def state(self) -> str:
        return self._last

    def poll(self) -> str:
        """Re-read the file; invoke the matching callback if it changed."""
        current = read_state(self.path)
        if current != self._last:
            self._last = current
            cb = (self.on_minimized if current == STATE_MINIMIZED
                  else self.on_restored)
            if cb is not None:
                cb()
        return current
