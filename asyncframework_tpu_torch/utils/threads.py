"""The repo's thread exception policy for fire-and-forget threads.

``async-lint``'s thread-hygiene rule requires every
``threading.Thread(...)`` site to name the thread, set daemonness
explicitly, and either RETAIN the thread object (someone can
join/reap/health-check it) or wrap its target here.  A fire-and-forget
thread whose target raises otherwise dies with a traceback on stderr at
best and silently at worst -- an unreaped thread, but for errors.

:func:`guarded` is deliberately tiny: log the exception loudly (both the
package logger and stderr -- daemons often run without logging
configured) and swallow it.  Threads that need richer policies (restart,
counters, supervision) should be retained and owned instead.
"""

from __future__ import annotations

import logging
import sys
import threading
from typing import Any, Callable

_log = logging.getLogger("asyncframework_tpu_torch.threads")


def guarded(fn: Callable[..., Any], what: str = "") -> Callable[..., None]:
    """Wrap a thread target so an escaping exception is reported, not
    swallowed by thread teardown.  ``what`` names the work in the report
    (defaults to the function's name)."""
    label = what or getattr(fn, "__name__", "thread target")

    def _run(*args: Any, **kwargs: Any) -> None:
        try:
            fn(*args, **kwargs)
        except Exception:  # noqa: BLE001 - the policy IS catch-everything
            _log.exception("unhandled exception in thread %r "
                           "(thread=%s)", label,
                           threading.current_thread().name)
            print(f"asyncframework_tpu_torch: unhandled exception in thread "
                  f"{label!r} ({threading.current_thread().name})",
                  file=sys.stderr, flush=True)
            import traceback

            traceback.print_exc()

    _run.__name__ = f"guarded_{getattr(fn, '__name__', 'target')}"
    return _run
