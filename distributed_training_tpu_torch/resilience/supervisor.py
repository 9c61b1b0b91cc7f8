"""Restart supervision of a serving engine (port, serving part).

The serving half of ``distributed_training_tpu/resilience/supervisor.py``:
``RestartPolicy`` (the retry budget and backoff) and
``supervise_serving``, which restarts a crashed engine in-process and
carries its work across, with the JAX function's budget, refund,
salvage, re-adoption and resubmission order.

At each crash it takes the ``/debug/requests`` snapshot and, with
``incident_dir``, writes an ``engine_crash`` incident bundle (and a
``give_up`` one when the budget runs out), as the JAX function does.
``supervise()`` for training, with its exit sentinels and checkpoint
progress, waits for ROADMAP.md queue A item 14.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass
from typing import Callable

logger = logging.getLogger(__name__)

CRASH = "crash"


@dataclass
class RestartPolicy:
    """Budget and backoff knobs."""

    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    jitter: float = 0.2          # +/- fraction of the backoff
    seed: int = 0                # jitter stream (deterministic tests)

    def backoff_s(self, consecutive_failures: int) -> float:
        """Delay before the next restart after ``consecutive_failures``
        (>= 1) non-advancing failures in a row: exponential, capped, with
        deterministic +/- jitter."""
        n = max(1, consecutive_failures)
        base = min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** (n - 1))
        rng = random.Random(self.seed * 1_000_003 + n)
        return base * (1.0 + self.jitter * rng.uniform(-1.0, 1.0))


def supervise_serving(make_engine: Callable[[], object],
                      run: Callable[[object, int], object],
                      *,
                      policy: RestartPolicy | None = None,
                      incident_dir: str | None = None,
                      sleep: Callable[[float], None] = time.sleep,
                      snapshot: Callable[[], dict] | None = None
                      ) -> dict:
    """Restart a crashed engine in-process, carrying the work across
    incarnations.

    ``make_engine`` returns a fresh, warmed engine (attach one shared
    ``FaultInjector`` there, or one on a shared ledger path, so that a
    one-shot ``engine_crash@N`` cannot fire again when the successor's
    launch count passes N); ``run(engine, incarnation)`` drives it
    (submits on incarnation 0, then steps or drains) and returns the
    result that ends supervision.

    On an exception out of ``run`` the dead engine's host state is
    intact (the step loop died, not the process): in-flight sequences
    with decoded tokens export their exact KV (``export_in_flight``) and
    are re-adopted by the successor, nothing recomputed; never-decoded
    ones and the queue resubmit fresh. The emission state moves whole,
    so a resubmitted stream regenerates its greedy-identical prefix
    without delivering one token twice.

    Budget: an incarnation that finished at least one request refunds it
    to ``max_restarts``; one that did not burns one, and below zero the
    supervisor gives up. At each crash the ``/debug/requests`` body is
    taken (``snapshot()``, or ``debug_requests_snapshot`` of the dead
    engine) and kept in the crash record; with ``incident_dir`` every
    crash, and the give-up, leaves an incident bundle carrying it and the
    last weight-swap provenance."""
    from distributed_training_tpu_torch import telemetry as tel
    from distributed_training_tpu_torch.serving.server import (
        debug_requests_snapshot,
    )

    policy = policy or RestartPolicy()
    engine = make_engine()
    budget = policy.max_restarts
    streak = 0
    incarnation = 0
    crashes: list[dict] = []
    while True:
        base_finished = engine.finished_total
        try:
            result = run(engine, incarnation)
            return {"engine": engine, "result": result,
                    "incarnations": incarnation + 1,
                    "restarts": incarnation, "gave_up": False,
                    "crashes": crashes}
        except KeyboardInterrupt:
            raise
        except Exception as exc:  # noqa: BLE001 — classify, salvage,
            # restart (or give up on the budget).
            err = f"{type(exc).__name__}: {exc}"
            logger.warning("serving engine crashed (incarnation %d, "
                           "launch %d): %s", incarnation,
                           engine.launch_count, err)
            snap = None
            try:
                snap = (snapshot() if snapshot is not None
                        else debug_requests_snapshot(engine))
            except Exception as e:  # noqa: BLE001 — evidence is optional;
                # a broken snapshot must not stop recovery.
                logger.debug("serving snapshot unavailable: %s", e)
            emission = engine.export_emission_state()
            queued = list(engine.queue)
            engine.queue.clear()
            try:
                export = engine.export_in_flight()
            except Exception as e:  # noqa: BLE001 — device state may be
                # gone with the crash; those restart from the prompt.
                logger.warning("in-flight KV salvage failed (%s); "
                               "resubmitting from prompts", e)
                export = {"adoptable": [],
                          "requests": [engine._replay_request(s)
                                       for s in engine.slots
                                       if s is not None]}
            advanced = engine.finished_total > base_finished
            tel.event("serving_engine_crash", incarnation=incarnation,
                      error=err, launches=engine.launch_count,
                      weights_version=engine.weights_version,
                      kv_salvaged=len(export["adoptable"]),
                      resubmitted=len(export["requests"]) + len(queued),
                      finished_this_incarnation=(
                          engine.finished_total - base_finished))
            # After the event, so the bundle's events tail carries it.
            if incident_dir:
                tel.write_incident_bundle(
                    incident_dir, reason=err, kind="engine_crash",
                    events_tail=tel.current().tail(),
                    extra={"incarnation": incarnation,
                           "launch_count": engine.launch_count,
                           "weights_version": engine.weights_version,
                           "weights_provenance": engine.weights_provenance,
                           "swap_stats": dict(engine.swap_stats)},
                    serving=snap)
            crashes.append({"incarnation": incarnation, "error": err,
                            "advanced": advanced,
                            **({"snapshot": snap} if snap is not None
                               else {})})
            if advanced:
                budget = policy.max_restarts
                streak = 0
            else:
                budget -= 1
                streak += 1
            if budget < 0:
                logger.error(
                    "serving supervisor: giving up after %d incarnation(s) "
                    "— no finished request in the last %d attempt(s); "
                    "last error %s", incarnation + 1, streak, err)
                tel.event("supervisor_give_up",
                          incarnations=incarnation + 1, streak=streak,
                          outcome=CRASH, scope="serving", error=err)
                if incident_dir:
                    tel.write_incident_bundle(
                        incident_dir,
                        reason=("serving crash-loop: no finished request "
                                f"in the last {streak} attempt(s); last "
                                f"error {err}"),
                        kind="give_up", events_tail=tel.current().tail(),
                        extra={"incarnations": incarnation + 1,
                               "streak": streak, "scope": "serving"},
                        serving=snap)
                return {"engine": engine, "result": None,
                        "incarnations": incarnation + 1,
                        "restarts": incarnation, "gave_up": True,
                        "crashes": crashes}
            delay = policy.backoff_s(streak) if streak else 0.0
            tel.event("restart", incarnation=incarnation, outcome=CRASH,
                      scope="serving", advanced=advanced,
                      backoff_s=round(delay, 3), budget=budget)
            if delay > 0:
                sleep(delay)
            engine = make_engine()
            engine.import_emission_state(emission)
            if export["adoptable"]:
                try:
                    engine.adopt_batch(export["adoptable"])
                except (RuntimeError, ValueError) as e:
                    # The successor could not place the salvaged KV
                    # (another pool shape, capacity): those restart from
                    # the prompt; the high-water marks still dedup.
                    logger.warning("KV re-adoption refused (%s); "
                                   "resubmitting from prompts", e)
                    for req, _toks, _k, _v in export["adoptable"]:
                        engine.submit(req)
            for req in export["requests"]:
                engine.submit(req)
            for req in queued:
                engine.submit(req)
            incarnation += 1
