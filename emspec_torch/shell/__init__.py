"""Window shells over the port's ``EmSpecApp`` (``emspec.shell``).

``python -m emspec_torch gui`` serves the live display and the settings
panel at http://127.0.0.1:<port>/ (``server``); ``gui --native`` opens a
frameless always-on-top tkinter window (``native``).
"""

from emspec_torch.shell.server import ShellServer

__all__ = ["ShellServer"]
