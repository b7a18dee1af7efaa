"""Auto-update check analog (L6).

The reference checks for updates on startup and shows a notification in
the settings window (reference: README.md:53-55 "EM-Spec automatically
checks for updates when launched… notification will appear in the
settings window").  The rebuild's analog: compare ``emspec.__version__``
against a version **manifest** — a JSON document ``{"latest": "x.y.z",
"url": "…"}`` — named by the ``EMSPEC_UPDATE_MANIFEST`` environment
variable (a file path or an http(s) URL, so packagers can point it at
their release feed).  Offline-safe by construction: no manifest
configured, unreachable URL, missing file, bad JSON, bad version string
— every failure returns None and the app never notices (the reference's
check is likewise fire-and-forget).

The check runs on a daemon thread (``UpdateChecker``) so startup never
blocks on it — same async contract as the reference's launcher.
"""

from __future__ import annotations

import json
import os
import threading

UPDATE_MANIFEST_ENV = "EMSPEC_UPDATE_MANIFEST"


def parse_version(v: str) -> tuple:
    """'1.2.3' → (1, 2, 3); tolerant of a leading 'v' and pre-release
    suffixes ('1.2.3-rc1' → (1, 2, 3)).  Raises ValueError on junk."""
    core = str(v).strip().lstrip("vV").split("-")[0].split("+")[0]
    parts = core.split(".")
    if not parts or not all(p.isdigit() for p in parts):
        raise ValueError(f"unparseable version: {v!r}")
    return tuple(int(p) for p in parts)


def _read_manifest(source: str, timeout: float) -> dict:
    if source.startswith(("http://", "https://")):
        from urllib.request import urlopen
        with urlopen(source, timeout=timeout) as resp:   # noqa: S310
            return json.loads(resp.read().decode("utf-8"))
    with open(source, encoding="utf-8") as f:
        return json.load(f)


def check_for_update(manifest: str | None = None,
                     current: str | None = None,
                     timeout: float = 3.0) -> dict | None:
    """One update check.  Returns ``{"latest", "current", "url"}`` when
    the manifest names a strictly newer version, else None — including
    on *any* failure (offline-safe; the check must never break the app).
    """
    source = manifest or os.environ.get(UPDATE_MANIFEST_ENV)
    if not source:
        return None
    if current is None:
        from emspec_torch import __version__ as current
    try:
        data = _read_manifest(source, timeout)
        latest = data["latest"]
        if parse_version(latest) > parse_version(current):
            return {"latest": str(latest), "current": str(current),
                    "url": str(data.get("url", ""))}
    except Exception:
        return None
    return None


class UpdateChecker:
    """Background startup check: construct, then read ``.notice`` any
    time (None until/unless a newer version is found)."""

    def __init__(self, manifest: str | None = None,
                 current: str | None = None, timeout: float = 3.0):
        self.notice: dict | None = None
        self._done = threading.Event()

        def run():
            self.notice = check_for_update(manifest, current, timeout)
            self._done.set()

        self._thread = threading.Thread(
            target=run, daemon=True, name="emspec-update-check")
        self._thread.start()

    def wait(self, timeout: float | None = None) -> dict | None:
        """Block until the check finished (tests); returns the notice."""
        self._done.wait(timeout)
        return self.notice
