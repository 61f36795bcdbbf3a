"""Graceful preemption (counterpart of ``sheeprl_tpu/resilience/preemption.py``):
signal -> emergency snapshot -> a distinct exit code.

:class:`PreemptionGuard` turns SIGTERM/SIGINT into a flag the training loop
polls at its checkpoint boundary (``diag.preempt_due``): the loop then takes
an emergency checkpoint through the normal save path, the facade journals
an fsync'd ``preempted`` event, drains the async writer so the snapshot is
durable, and raises :class:`PreemptedExit`, a ``SystemExit`` carrying
:data:`PREEMPTED_EXIT_CODE` (75), so a supervisor can tell "preempted with a
fresh checkpoint, resume me" from a crash and from completion.  A second
signal restores the previous handler and re-delivers it.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, Optional, Sequence

#: EX_TEMPFAIL — "temporary failure, retry": distinct from clean completion
#: (0) and from crash exits (1 / signal deaths), chosen so shell tooling and
#: the supervisor can branch on it.
PREEMPTED_EXIT_CODE = 75


class PreemptedExit(SystemExit):
    """Raised at the loop boundary after the emergency snapshot landed."""

    def __init__(self, message: str = ""):
        super().__init__(PREEMPTED_EXIT_CODE)
        self.message = message

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.message or f"preempted (exit {PREEMPTED_EXIT_CODE})"


class PreemptionGuard:
    """Installable SIGTERM/SIGINT → preemption-requested flag.

    Handlers can only be installed from the main thread; elsewhere (e.g. a
    test harness driving the loop from a worker thread) :meth:`install`
    returns False and the guard stays inert — the ``inject_preempt_iter``
    drill does not need real signals.
    """

    def __init__(self, signals: Sequence[str] = ("SIGTERM", "SIGINT")):
        self.signal_names = tuple(signals)
        self._requested = False
        self._signum: Optional[int] = None
        self._previous: Dict[int, object] = {}
        self._installed = False

    # -- handler ------------------------------------------------------------
    def _handle(self, signum, frame) -> None:  # noqa: ANN001 - signal API
        if self._requested:
            # second signal: restore the previous disposition and re-deliver —
            # a wedged loop must stay force-killable
            previous = self._previous.get(signum, signal.SIG_DFL)
            try:
                signal.signal(signum, previous)  # type: ignore[arg-type]
            except (ValueError, TypeError):  # pragma: no cover
                pass
            os.kill(os.getpid(), signum)
            return
        self._requested = True
        self._signum = signum

    # -- lifecycle ----------------------------------------------------------
    def install(self) -> bool:
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        for name in self.signal_names:
            signum = getattr(signal, name, None)
            if signum is None:  # pragma: no cover - platform-dependent
                continue
            try:
                self._previous[int(signum)] = signal.signal(signum, self._handle)
            except (ValueError, OSError):  # pragma: no cover - exotic runtimes
                continue
        self._installed = bool(self._previous)
        return self._installed

    def uninstall(self) -> None:
        if not self._installed:
            return
        if threading.current_thread() is threading.main_thread():
            for signum, previous in self._previous.items():
                try:
                    if signal.getsignal(signum) == self._handle:
                        signal.signal(signum, previous)  # type: ignore[arg-type]
                except (ValueError, TypeError):  # pragma: no cover
                    continue
        self._previous.clear()
        self._installed = False

    # -- state --------------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._requested

    @property
    def signal_name(self) -> Optional[str]:
        if self._signum is None:
            return None
        try:
            return signal.Signals(self._signum).name
        except ValueError:  # pragma: no cover
            return str(self._signum)
