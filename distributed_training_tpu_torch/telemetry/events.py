"""Span/event core: the structured ``events.jsonl`` stream.

The port of ``distributed_training_tpu/telemetry/events.py``, with the
same record schema so the JAX package's offline readers parse both:

- ``{"kind": "span", "name": "step", "t": <end unix>, "dur_s": ...,
   "depth": 0, "parent": null, ...attrs}`` — emitted when a span
  closes (start time = ``t - dur_s``). Spans nest per thread.
- ``{"kind": "<event name>", "t": ..., ...fields}`` — point events
  (hbm samples, goodput windows, watchdog firings, run_start, the
  serving engine's ``serving`` step records, ...).

Every ``span()`` also opens a ``torch.profiler.record_function`` range
(the counterpart of ``jax.profiler.TraceAnnotation``), so the same
region names show up in a ``torch.profiler`` trace.

Ambient use (the ``logging`` model): entry points ``install()`` one
``Telemetry``; library code calls the module-level ``span()`` /
``event()``, which no-op (except the profiler range) until something is
installed. A ``GoodputLedger`` attached by the trainer
(``attach_ledger``) takes every depth-0 span's duration into its
buckets.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time

import torch

from distributed_training_tpu_torch.utils.metrics import sanitize_for_json

logger = logging.getLogger(__name__)


class Telemetry:
    """Thread-safe event sink: jsonl file + bounded in-memory tail.

    ``events_jsonl=None`` or ``enabled=False`` keeps the full span API
    (including profiler ranges) but writes nothing — the default for
    library code running outside an instrumented entry point.
    ``fresh=False`` appends, separated by a ``run_start`` marker.

    ``host_id`` (the process index in a world of several processes, or
    under an elastic supervisor) stamps a ``host`` field onto every
    record, so per-host streams stay attributable once the aggregator
    merges them (``telemetry/aggregate.py``); None keeps the
    single-host schema."""

    def __init__(self, events_jsonl: str | None = None,
                 enabled: bool = True, fresh: bool = True,
                 tail_events: int = 256, start_step: int = 0,
                 host_id: int | None = None):
        self.enabled = enabled and events_jsonl is not None
        self.events_jsonl = events_jsonl if self.enabled else None
        self.host_id = host_id
        self.ledger = None  # GoodputLedger, attached by the trainer
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._observers: list = []
        self._tail: collections.deque = collections.deque(
            maxlen=tail_events)
        self._fh = None
        if self.events_jsonl:
            os.makedirs(os.path.dirname(self.events_jsonl) or ".",
                        exist_ok=True)
            # One line-buffered handle for the run: every record is
            # durable on write for tail readers.
            self._fh = open(self.events_jsonl,
                            "w" if fresh else "a", buffering=1)
            start: dict = {"kind": "run_start", "t": time.time(),
                           "step": start_step}
            if host_id is not None:
                start["host"] = host_id
            self._fh.write(json.dumps(start) + "\n")

    def attach_ledger(self, ledger) -> None:
        """Feed depth-0 span durations into a GoodputLedger."""
        self.ledger = ledger

    def add_observer(self, fn) -> None:
        """Register a live consumer of every emitted record, called
        with the sanitized record after it is written, outside the
        lock; an observer that raises is logged and does not disturb
        emission."""
        with self._lock:
            self._observers.append(fn)

    def _emit(self, rec: dict) -> None:
        if not self.enabled:  # cheap fast path; authoritative below
            return
        if self.host_id is not None:
            rec = {**rec, "host": self.host_id}
        safe = sanitize_for_json(rec)
        line = json.dumps(safe, allow_nan=False)
        with self._lock:
            # close() may race an emitting thread past the unlocked
            # check above.
            if self._fh is None:
                return
            self._tail.append(safe)
            self._fh.write(line + "\n")
            observers = list(self._observers)
        for fn in observers:
            try:
                fn(safe)
            except Exception as e:  # noqa: BLE001 — a broken live
                # consumer must not take down the emission path.
                logger.debug("telemetry observer failed: %s: %s",
                             type(e).__name__, e)

    def close(self) -> None:
        """Stop recording and release the stream handle (idempotent).
        The in-memory tail stays readable."""
        with self._lock:
            self.enabled = False
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def tail(self) -> list[dict]:
        """Most recent events, oldest first."""
        with self._lock:
            return list(self._tail)

    def event(self, name: str, **fields) -> None:
        self._emit({"kind": name, "t": time.time(), **fields})

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Timed region: jsonl span record + profiler range. Nesting
        is tracked per thread; only depth-0 spans feed the goodput
        ledger, so a sub-operation never counts twice."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        parent = stack[-1] if stack else None
        stack.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dur = time.perf_counter() - t0
            stack.pop()
            depth = len(stack)
            if self.ledger is not None and depth == 0:
                self.ledger.add(name, dur,
                                steps=1 if name in ("step", "compile")
                                else 0)
            self._emit({"kind": "span", "name": name,
                        "t": time.time(), "dur_s": round(dur, 6),
                        "depth": depth, "parent": parent, **attrs})


# A permanently-disabled instance: the ambient default, so library
# call sites never need a None check.
_NULL = Telemetry(enabled=False)
_current: Telemetry = _NULL


def install(telemetry: Telemetry) -> Telemetry:
    """Make ``telemetry`` the process-ambient sink. Returns it."""
    global _current
    _current = telemetry
    return telemetry


def uninstall() -> None:
    global _current
    _current = _NULL


def current() -> Telemetry:
    return _current


def span(name: str, **attrs):
    """Module-level span against the ambient Telemetry (always a valid
    profiler range; a jsonl record only once ``install()``-ed)."""
    return _current.span(name, **attrs)


def event(name: str, **fields) -> None:
    _current.event(name, **fields)
