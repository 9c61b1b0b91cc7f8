"""Step-time attribution: where a training step's wall-clock goes (port
of ``telemetry/attribution.py``, its measured half).

The trainer captures a short ``torch.profiler`` trace mid-run — at
configured steps (``train.profile_at``) or on demand (drop a
``profile_now`` file in the run dir) — and decomposes the captured
device timeline (``telemetry/kineto.py``) into compute /
exposed-collective / host+data fractions plus the overlap fraction (the
share of collective time concurrent with compute). It is emitted as an
``attribution`` event with the JAX package's schema, plus ``top_ops``
(the device ops that took the most time) and ``trace`` (the Chrome
trace's path in the run dir). Capture is coordinator-gated and one-shot
across supervisor restarts: the trigger is recorded in a ledger before
the trace starts, so a crash mid-capture cannot re-fire it in every
incarnation. The attribution work runs after the step span closed, so
it lands in the ``idle`` goodput bucket, never in ``step``; the event
carries what the capture cost the run there (``start_s``: starting the
profiler; ``stop_s``: draining the card, stopping, writing and
attributing the trace).

The JAX module's static half (``hlo_overlap_report``,
``overlap_summary``) scores a compiled XLA schedule; it waits for
ROADMAP.md queue A item 17 with ``analysis/``.
"""

from __future__ import annotations

import json
import logging
import os
import time

from distributed_training_tpu_torch.telemetry import kineto

logger = logging.getLogger(__name__)

SCHEMA = 1

# The stable consumer surface of an ``attribution`` event (summarize.py
# and aggregate.py filter through it).
SUMMARY_KEYS = ("schema", "step", "steps_captured", "trace_dir",
                "source", "window_s", "compute_frac",
                "collective_frac", "host_frac", "overlap_frac",
                "compute_s", "collective_s", "overlap_s", "error")

# The same for the JAX trainer's one-shot ``attribution_static`` event
# (the port emits none; a JAX run dir's is still read).
STATIC_SUMMARY_KEYS = ("schema", "step", "scored", "overlapped",
                       "overlap_score", "mean_compute_between",
                       "async_pairs", "expected_comms_s",
                       "expected_compute_s", "sharding_plan",
                       "xla_overlap_flags")


# Device ops named in an ``attribution`` event, busiest first: enough for
# a step's every custom kernel to appear beside the library ones.
TOP_OPS = 64


def summary_of_event(rec: dict, keys=SUMMARY_KEYS) -> dict:
    return {k: rec[k] for k in keys if k in rec}


def attribute_trace_dir(trace_dir: str) -> dict:
    """Attribution report for the newest trace under ``trace_dir``
    (kineto.py arithmetic plus the busiest ops and the trace's path)."""
    path = kineto.find_trace(trace_dir)
    records = kineto.load_trace(path)
    rep = kineto.attribution_of_trace(records)
    rep["top_ops"] = kineto.top_kernels(records, n=TOP_OPS)
    rep["trace"] = path
    return rep


# ---------------------------------------------------------------------------
# in-run capture
# ---------------------------------------------------------------------------

TRIGGER_FILE = "profile_now"


def parse_profile_at(spec: str) -> tuple[int, ...]:
    """``train.profile_at`` grammar: comma-separated global step
    numbers (``"20"`` / ``"20,500"``). The capture begins at that step
    and runs ``train.profile_steps`` steps."""
    steps = []
    for part in str(spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if not part.isdigit():
            raise ValueError(
                f"train.profile_at: {part!r} is not a step number "
                "(grammar: comma-separated ints, e.g. '20,500')")
        steps.append(int(part))
    return tuple(sorted(set(steps)))


class ProfileCapture:
    """State machine for in-run trace capture + attribution.

    The trainer calls ``maybe_start(step)`` before fetching each step's
    batch and ``maybe_stop(step, sync=...)`` after its bookkeeping;
    trigger evaluation (scheduled steps, the drop file), the one-shot
    restart ledger, trace dir naming and the attribution parse live
    here. Failures never propagate: a failed capture or parse returns
    an event payload with an ``error`` field.
    """

    def __init__(self, run_dir: str, at_steps=(), n_steps: int = 2,
                 enabled: bool = True):
        self.run_dir = run_dir
        # The config layer parses `train.profile_at=20` into an int and
        # `=20,500` into a string; accept both plus iterables.
        self.at_steps = (parse_profile_at(str(at_steps))
                         if isinstance(at_steps, (str, int)) else
                         tuple(int(s) for s in at_steps))
        self.n_steps = max(1, int(n_steps))
        self.enabled = enabled
        self.profiles_dir = os.path.join(run_dir, "profiles")
        self.trigger_path = os.path.join(run_dir, TRIGGER_FILE)
        self.ledger_path = os.path.join(self.profiles_dir, "fired.json")
        self._fired: set[str] = set()
        self._active: dict | None = None
        if enabled and os.path.exists(self.ledger_path):
            try:
                with open(self.ledger_path, encoding="utf-8") as f:
                    self._fired = set(json.load(f))
            except (OSError, ValueError) as e:
                logger.warning("profile ledger unreadable (%s); "
                               "treating all triggers as unfired", e)

    # -- trigger ledger (write-before-action) --------------------------

    def _record_fired(self, key: str) -> None:
        self._fired.add(key)
        os.makedirs(self.profiles_dir, exist_ok=True)
        tmp = self.ledger_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(sorted(self._fired), f)
        os.replace(tmp, self.ledger_path)

    def _trigger(self, step: int) -> str | None:
        """The trigger key firing at ``step``, or None. Scheduled steps
        fire at or after (a resume may land past the exact step) and
        are one-shot through the ledger; the drop file is one-shot by
        consumption (dropping it again re-arms it)."""
        due = [s for s in self.at_steps
               if step >= s and f"step_{s}" not in self._fired]
        if due:
            # Every overdue trigger is satisfied by this capture.
            for s in due[1:]:
                self._fired.add(f"step_{s}")
            return f"step_{due[0]}"
        if os.path.exists(self.trigger_path):
            try:
                os.remove(self.trigger_path)
            except OSError:
                return None  # another process consumed it first
            return f"file_at_{step}"
        return None

    # -- capture lifecycle ---------------------------------------------

    @property
    def active(self) -> bool:
        return self._active is not None

    def maybe_start(self, step: int) -> bool:
        """Start a capture if a trigger fires at ``step`` (the step
        about to run). Returns whether a trace is now recording."""
        if not self.enabled or self._active is not None:
            return False
        key = self._trigger(step)
        if key is None:
            return False
        trace_dir = os.path.join(self.profiles_dir, f"step_{step:06d}")
        t0 = time.perf_counter()
        try:
            # Ledger before the trace: a crash mid-capture must not
            # re-fire the trigger in every restarted incarnation.
            self._record_fired(key)
            from distributed_training_tpu_torch.utils import profiler
            prof = profiler.start(trace_dir)
        except Exception:  # noqa: BLE001 — e.g. a profiler already
            # running under train.profile_dir; profiling is best-effort.
            logger.exception("profile capture at step %d failed to "
                             "start; continuing untraced", step)
            return False
        self._active = {"start_step": step, "dir": trace_dir,
                        "remaining": self.n_steps, "trigger": key,
                        "prof": prof, "start_s": time.perf_counter() - t0}
        logger.info("profiling steps %d..%d into %s", step,
                    step + self.n_steps - 1, trace_dir)
        return True

    def maybe_stop(self, step: int, sync=None) -> dict | None:
        """Count down the active capture; when its window completes,
        drain the card (``sync``), stop the trace, attribute it, and
        return the ``attribution`` event payload."""
        if self._active is None:
            return None
        self._active["remaining"] -= 1
        if self._active["remaining"] > 0:
            return None
        active, self._active = self._active, None
        t0 = time.perf_counter()
        payload = {"schema": SCHEMA, "step": step,
                   "steps_captured": step - active["start_step"] + 1,
                   "trace_dir": os.path.relpath(active["dir"],
                                                self.run_dir),
                   "trigger": active["trigger"],
                   "start_s": round(active["start_s"], 6)}
        try:
            from distributed_training_tpu_torch.utils import profiler
            if sync is not None:
                sync()
            profiler.stop(active["prof"], active["dir"])
        except Exception as e:  # noqa: BLE001
            logger.exception("profile capture failed to stop")
            payload["error"] = f"stop_trace: {type(e).__name__}: {e}"
            return payload
        try:
            payload.update(attribute_trace_dir(active["dir"]))
            payload["schema"] = SCHEMA
        except (kineto.KinetoError, OSError) as e:
            payload["error"] = str(e)
        payload["stop_s"] = round(time.perf_counter() - t0, 6)
        return payload

    def abort(self) -> None:
        """Stop an in-flight trace without attributing it (the run
        ended mid-window); the partial trace stays on disk, and the
        ledger already holds the trigger."""
        if self._active is None:
            return
        active, self._active = self._active, None
        try:
            from distributed_training_tpu_torch.utils import profiler
            profiler.stop(active["prof"], active["dir"])
            logger.warning("run ended mid-capture; partial trace left "
                           "at %s", active["dir"])
        except Exception as e:  # noqa: BLE001
            logger.debug("profile capture abort: %s: %s",
                         type(e).__name__, e)
