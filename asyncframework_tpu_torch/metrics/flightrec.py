"""The flight recorder's hook of the DCN plane.

The JAX package's ``metrics/flightrec.py`` keeps a bounded ring of recent
events that its deploy daemons and live UI install and dump after a
crash.  This package installs no recorder yet (ROADMAP A5b), so it keeps
only :func:`note`, the call the copied modules make at the reference's
breadcrumbs, in its uninstalled form.
"""

from __future__ import annotations


def note(kind: str, **fields) -> None:
    """Record one event into the installed recorder: none is installed,
    so nothing is recorded."""
