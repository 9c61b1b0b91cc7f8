"""Graceful preemption: a copy of the JAX package's
``utils/preemption.py`` (stdlib ``signal`` only).

Preemptible machines receive SIGTERM shortly before shutdown. The guard
turns that signal into a cooperative stop flag the trainer polls at step
granularity, so a final checkpoint lands before the machine goes away.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptionGuard:
    """Converts SIGTERM (or the given signals) into a polled stop flag.

    Usage::

        guard = PreemptionGuard.install()
        ...                      # the trainer polls guard.should_stop
        guard.uninstall()

    Thread-safe; also usable as a plain flag in tests via ``trigger``.
    """

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._prev_handlers: dict[int, object] = {}

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self, reason: str = "manual") -> None:
        if not self._stop.is_set():
            logger.warning("stop requested (%s): finishing step, "
                           "saving checkpoint, exiting", reason)
        self._stop.set()

    def _handler(self, signum, frame):
        del frame
        self.trigger(signal.Signals(signum).name)

    @classmethod
    def install(cls, signals: tuple[int, ...] = (signal.SIGTERM,)
                ) -> "PreemptionGuard":
        """Install handlers (main thread only). SIGTERM is what cloud
        preemption and orchestrators (k8s, slurm, torchrun) deliver
        first."""
        guard = cls()
        for s in signals:
            guard._prev_handlers[s] = signal.getsignal(s)
            signal.signal(s, guard._handler)
        return guard

    def uninstall(self) -> None:
        for s, prev in self._prev_handlers.items():
            signal.signal(s, prev)
        self._prev_handlers.clear()
