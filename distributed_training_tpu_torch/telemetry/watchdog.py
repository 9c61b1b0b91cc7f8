"""Hang watchdog + postmortem bundles (port of ``telemetry/watchdog.py``).

A daemon thread is armed before each step (before its batch is
fetched, so a stalled loader is inside the window) and disarmed after;
if a step stays armed past the timeout it writes a postmortem bundle —
faulthandler stacks of all threads (which works while the main thread
is blocked in a C call, such as a wedged NCCL collective or a CUDA
synchronize), ``torch.cuda.memory_stats``, and the tail of the
telemetry event stream — before optionally aborting the process with
``EXIT_CODE``, the code the restart supervisor classifies as
``watchdog_abort`` (``resilience/supervisor.py``).

``write_postmortem`` is also callable directly, and
``arm_process_watchdog`` arms a faulthandler-only fallback for a
subprocess that may be killed from outside: the stack dump is scheduled
inside the interpreter, so it lands on disk before the external kill.

Dump order: meta and stacks first (host-side, cannot hang), device
memory stats last (they touch the card, which may be what is wedged).
"""

from __future__ import annotations

import atexit
import faulthandler
import itertools
import json
import logging
import os
import threading
import time

logger = logging.getLogger(__name__)

# The abort path's exit code: the one source the restart supervisor's
# classification reads.
EXIT_CODE = 42

# Monotonic per-process suffix: two postmortems in the same second
# (e.g. a watchdog firing while a budget timer also fires) must land
# in distinct bundles, not overwrite each other.
_SEQ = itertools.count()


def write_postmortem(base_dir: str, reason: str,
                     events_tail: list | None = None,
                     extra: dict | None = None) -> str:
    """Write one timestamped postmortem bundle; returns its path.

    A postmortem is an incident bundle of kind ``watchdog``
    (``telemetry.incident.write_incident_bundle``): meta.json,
    stacks.txt, events_tail.jsonl, memory_stats.json, which the offline
    ``--doctor`` reads. Never raises."""
    from distributed_training_tpu_torch.telemetry.incident import (
        write_incident_bundle)
    return write_incident_bundle(base_dir, reason=reason,
                                 kind="watchdog",
                                 events_tail=events_tail, extra=extra)


class HangWatchdog:
    """Per-step hang detector: ``arm()`` before dispatch, ``disarm()``
    after the step's host work completes. A step that stays armed past
    ``timeout_s`` gets a postmortem bundle under ``postmortem_dir``;
    ``abort=True`` then hard-exits (rc 42) — the mode for unattended
    runs where a hung process holding the accelerator is worse than a
    dead one. Re-arming after a firing resets the trigger, so a run
    that recovers can still document a later hang.
    """

    EXIT_CODE = EXIT_CODE

    def __init__(self, timeout_s: float, postmortem_dir: str,
                 telemetry=None, abort: bool = False,
                 poll_s: float | None = None):
        self.timeout_s = timeout_s
        self.postmortem_dir = postmortem_dir
        self.telemetry = telemetry
        self.abort = abort
        self.fired_path: str | None = None
        self._cond = threading.Condition()
        self._armed_at: float | None = None
        self._timeout_cur = timeout_s
        self._info: dict = {}
        self._context: dict = {}
        self._fired = False
        self._stopped = False
        self._poll = poll_s if poll_s is not None else max(
            0.05, min(1.0, timeout_s / 4))
        self._thread = threading.Thread(
            target=self._loop, name="hang-watchdog", daemon=True)
        self._thread.start()

    def arm(self, timeout_s: float | None = None, **info) -> None:
        """Start the countdown for one step. ``timeout_s`` overrides
        the default for this arm only (the trainer gives the first,
        compile-dominated step a larger allowance)."""
        with self._cond:
            self._armed_at = time.monotonic()
            self._timeout_cur = (timeout_s if timeout_s is not None
                                 else self.timeout_s)
            self._info = info
            self._fired = False
            self._cond.notify()

    def disarm(self) -> None:
        with self._cond:
            self._armed_at = None
            self._cond.notify()

    def set_context(self, ctx: dict) -> None:
        """Replace the persistent context merged into every future
        postmortem (on top of the per-arm info). The trainer feeds the
        straggler detector's latest verdicts through here, so a
        postmortem for a collective hang says "host 3 is 2.1x median
        on data_wait" instead of nothing. Pass {} to clear."""
        with self._cond:
            self._context = dict(ctx)

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stopped:
                    return
                armed_at, fired = self._armed_at, self._fired
                timeout = self._timeout_cur
                info = {**self._info, **self._context}
                self._cond.wait(self._poll)
            if (armed_at is None or fired
                    or time.monotonic() - armed_at < timeout):
                continue
            with self._cond:
                # Re-check under the lock: the step may have disarmed
                # (or re-armed a NEWER step) while we were deciding.
                if self._armed_at != armed_at or self._fired:
                    continue
                self._fired = True
            self._fire(info, timeout)

    def _fire(self, info: dict, timeout_s: float) -> None:
        tail = self.telemetry.tail() if self.telemetry else None
        self.fired_path = write_postmortem(
            self.postmortem_dir,
            f"step exceeded watchdog timeout {timeout_s}s",
            events_tail=tail,
            extra={"watchdog_timeout_s": timeout_s, **info})
        if self.telemetry is not None:
            self.telemetry.event("watchdog_fired",
                                 postmortem=self.fired_path,
                                 timeout_s=timeout_s, **info)
        if self.abort:
            # Exit-status sentinel FIRST: the restart supervisor
            # classifies this death as watchdog_abort (vs crash) by
            # reading it — rc 42 alone also classifies, but the
            # sentinel carries the postmortem path into the incident
            # log. Best-effort: the abort must fire regardless.
            try:
                from distributed_training_tpu_torch.resilience.supervisor \
                    import WATCHDOG_ABORT, write_exit_status
                write_exit_status(WATCHDOG_ABORT,
                                  postmortem=self.fired_path)
            except Exception as e:  # noqa: BLE001
                logger.debug("watchdog abort sentinel not written: "
                             "%s: %s", type(e).__name__, e)
            # The stacks are on disk; a process wedged in a C call
            # cannot run atexit handlers anyway.
            os._exit(self.EXIT_CODE)


def arm_process_watchdog(timeout_s: float, postmortem_dir: str,
                         reason: str):
    """Faulthandler-only process watchdog for externally-killed
    subprocesses (the probe loop's ``timeout -k`` children): schedules
    an all-thread stack dump into a postmortem bundle at ``timeout_s``.
    Returns ``cancel()`` — call it on success to cancel the dump and
    remove the (then-empty) bundle. ``cancel`` is idempotent and also
    registered atexit, so an error exit that never reaches the success
    path doesn't litter the postmortem dir with empty decoy bundles; a
    bundle whose dump actually FIRED (non-empty stacks) is always
    kept."""
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    path = os.path.join(
        postmortem_dir, f"{stamp}_pid{os.getpid()}_{next(_SEQ)}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"reason": reason, "armed_at_unix": time.time(),
                   "timeout_s": timeout_s, "pid": os.getpid()}, f,
                  indent=1)
    stacks_path = os.path.join(path, "stacks.txt")
    stacks = open(stacks_path, "w")
    faulthandler.dump_traceback_later(timeout_s, file=stacks)
    done = []

    def cancel() -> None:
        if done:
            return
        done.append(True)
        faulthandler.cancel_dump_traceback_later()
        stacks.close()
        try:
            if os.path.getsize(stacks_path) > 0:
                return  # the dump fired: the bundle is evidence
        except OSError:
            pass
        for name in ("stacks.txt", "meta.json"):
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass
        try:
            os.rmdir(path)
        except OSError:
            pass

    atexit.register(cancel)
    return cancel
