"""Restart supervision: training processes and the serving engine (port
of ``resilience/supervisor.py``).

Training (``supervise``, driven by ``launch/local.py --supervise``):

- **Exit classification.** A supervised training process writes an
  exit-status sentinel (``write_exit_status``: "completed",
  "preempted", "host_lost"); the supervisor reads them and falls back to
  the return code (death by SIGTERM is a preemption) when a process died
  too hard to write one. Sentinels left by an earlier supervisor run in
  the same directory are removed before each incarnation.
- **Retry budget refunded by checkpoint progress.** An incarnation that
  commits a NEW checkpoint step refunds the budget to ``max_restarts``;
  one that does not burns one. A new step, not a higher one: a quarantine
  at restore lowers the newest step on disk while the run still
  advances. A crash at the same step every time gives up after
  ``max_restarts + 1`` incarnations.
- **Backoff.** Exponential per consecutive failure without progress,
  capped and jittered (deterministic from the seed); a preemption
  refunds the budget but keeps the backoff growing, so a preemption
  storm never hot-loops. A stop request (the launcher was signalled)
  stands down instead of restarting.
- **Elastic.** With an ``elastic.ElasticPolicy`` a lost or evicted host
  becomes a world resize (``DTT_ELASTIC_WORLD``/``DTT_ELASTIC_EVICTED``
  in the next incarnation's environment) instead of a same-size retry.

Every decision is an event in the supervisor's own ``events.jsonl``
(``restart``, ``elastic``, ``supervisor_give_up``, with an incident
bundle at the give-up).

Serving (``supervise_serving``): restarts a crashed engine in-process
and carries its work across, with the JAX function's budget, refund,
salvage, re-adoption and resubmission order. At each crash it takes the
``/debug/requests`` snapshot and, with ``incident_dir``, writes an
``engine_crash`` incident bundle (and a ``give_up`` one when the budget
runs out).

The training half imports only the standard library and the port's
framework-free resilience modules, so the launcher process does not load
torch for it.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable

from distributed_training_tpu_torch.resilience import elastic as elastic_mod
from distributed_training_tpu_torch.resilience.integrity import (
    checkpoint_steps_on_disk,
)
from distributed_training_tpu_torch.telemetry.watchdog import EXIT_CODE

logger = logging.getLogger(__name__)

# Exit outcomes, worst-first. Sentinel files carry these in "outcome".
COMPLETED = "completed"
PREEMPTED = "preempted"
# One (or a strict subset) of the group's hosts was lost — evicted by
# a straggler verdict (clean exits + host_lost sentinels naming the
# evictee) or reclaimed/crashed under the survivors (launcher group
# report). Under an elastic policy this is the shrink trigger; without
# one it degrades to the crash/preempted budget rules.
HOST_LOST = "host_lost"
WATCHDOG_ABORT = "watchdog_abort"
CRASH = "crash"

# The hang watchdog's abort exit code.
WATCHDOG_EXIT_CODE = EXIT_CODE

ENV_SENTINEL = "DTT_EXIT_SENTINEL"
ENV_RESTART_COUNT = "DTT_RESTART_COUNT"


# ---------------------------------------------------------------------------
# exit-status sentinels (written by the CHILD, read by the supervisor)
# ---------------------------------------------------------------------------


def sentinel_path() -> str | None:
    """This process's own sentinel file, or None when unsupervised.

    The supervisor exports one base path per incarnation; each process
    of a (possibly multi-process) incarnation appends its pid so local
    pod simulations don't clobber each other's verdicts."""
    base = os.environ.get(ENV_SENTINEL)
    if not base:
        return None
    return f"{base}.pid{os.getpid()}.json"


def write_exit_status(outcome: str, **fields) -> str | None:
    """Record how this process is about to exit (atomic; no-op when
    unsupervised). Called by the train CLI on clean exits and by the
    watchdog abort path right before ``os._exit``."""
    path = sentinel_path()
    if path is None:
        return None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"outcome": outcome, "pid": os.getpid(),
                   "t": time.time(), **fields}, f)
    os.replace(tmp, path)
    return path


def read_exit_statuses(base: str) -> list[dict]:
    """All sentinels an incarnation's processes left behind."""
    out = []
    for path in sorted(glob.glob(f"{base}.pid*.json")):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def classify_exit(returncode: int, statuses: list[dict]) -> str:
    """One outcome for the whole incarnation, worst report wins.

    Sentinels are authoritative when present (a preempted process
    exits 0 — only the sentinel distinguishes it from completion);
    return codes cover processes that died too hard to write one
    (SIGKILL, segfault, ``os._exit``)."""
    outcomes = {s.get("outcome") for s in statuses}
    if WATCHDOG_ABORT in outcomes or returncode == WATCHDOG_EXIT_CODE:
        return WATCHDOG_ABORT
    if HOST_LOST in outcomes:
        # A coordinated eviction exits CLEANLY (every host saves and
        # writes the sentinel naming the evictee) — only the sentinel
        # distinguishes it from completion/preemption.
        return HOST_LOST
    if returncode == 0:
        return PREEMPTED if PREEMPTED in outcomes else COMPLETED
    # 143/130: death by SIGTERM/SIGINT (launch.wait encodes signal
    # deaths as 128 + signum) — the external-preemption shape. Any
    # OTHER nonzero rc is a crash even when one process of the group
    # wrote a preempted sentinel: worst report wins, and a crash must
    # burn retry budget — a preemption verdict would refund it.
    if returncode in (143, 130):
        return PREEMPTED
    return CRASH


# ---------------------------------------------------------------------------
# restart policy
# ---------------------------------------------------------------------------


@dataclass
class RestartPolicy:
    """Budget + backoff knobs (CLI: ``--max-restarts``,
    ``--backoff-base-s``)."""

    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    jitter: float = 0.2          # +/- fraction of the backoff
    seed: int = 0                # jitter stream (deterministic tests)

    def backoff_s(self, consecutive_failures: int) -> float:
        """Delay before the next restart after ``consecutive_failures``
        (>=1) non-advancing failures in a row. Exponential, capped,
        with deterministic +/-jitter."""
        n = max(1, consecutive_failures)
        base = min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** (n - 1))
        # Int seed only: tuple seeding raises TypeError on 3.11+.
        rng = random.Random(self.seed * 1_000_003 + n)
        return base * (1.0 + self.jitter * rng.uniform(-1.0, 1.0))


@dataclass
class Incident:
    """One supervised incarnation's outcome (the give-up summary).
    ``world_size``/``evicted`` record the topology the incarnation ran
    at (elastic runs; postmortems want the history), ``lost_hosts``
    which hosts it lost, ``elastic_action`` what the policy decided
    for the NEXT incarnation ("retry"/"shrink"/"grow")."""

    incarnation: int
    returncode: int
    outcome: str
    wall_s: float
    ckpt_step: int | None
    advanced: bool
    budget_after: int = 0
    backoff_s: float = 0.0
    world_size: int | None = None
    evicted: list[int] = field(default_factory=list)
    lost_hosts: list[int] = field(default_factory=list)
    elastic_action: str | None = None


@dataclass
class SuperviseResult:
    returncode: int
    incidents: list[Incident] = field(default_factory=list)

    @property
    def restarts(self) -> int:
        return max(0, len(self.incidents) - 1)

    def summary_lines(self) -> list[str]:
        lines = [f"supervisor: {len(self.incidents)} incarnation(s), "
                 f"{self.restarts} restart(s), final rc "
                 f"{self.returncode}"]
        for inc in self.incidents:
            lines.append(
                f"  #{inc.incarnation}: {inc.outcome} rc={inc.returncode}"
                f" wall={inc.wall_s:.1f}s ckpt_step={inc.ckpt_step}"
                f"{' (advanced)' if inc.advanced else ''}"
                f" budget={inc.budget_after}"
                + (f" world={inc.world_size}"
                   if inc.world_size is not None else "")
                + (f" lost={inc.lost_hosts}" if inc.lost_hosts else "")
                + (f" -> {inc.elastic_action}"
                   if inc.elastic_action
                   and inc.elastic_action != "retry" else ""))
        return lines


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def supervise(run_incarnation: Callable[[dict[str, str]], object],
              *,
              policy: RestartPolicy | None = None,
              state_dir: str,
              ckpt_dir: str | None = None,
              telemetry=None,
              sleep: Callable[[float], None] = time.sleep,
              should_stop: Callable[[], bool] | None = None,
              elastic: "elastic_mod.ElasticPolicy | None" = None,
              on_incident: Callable[[Incident], None] | None = None,
              ) -> SuperviseResult:
    """Run ``run_incarnation(extra_env)`` until completion or budget
    exhaustion; returns the final rc plus the incident log.

    ``run_incarnation`` launches ONE incarnation of the training job
    (all its processes) with the given extra environment merged in,
    blocks, and returns the group's exit code — for the local
    launcher that is ``launch_local(...)`` + ``wait(...)``. It may
    instead return an ``elastic.GroupReport`` (the launcher's
    ``wait_report``); the per-process detail is what lets an elastic
    policy tell "host 2 died" from "everything died".

    ``ckpt_dir`` enables progress-based budget refunds; without it
    every non-completed exit burns budget (strictly bounded either
    way). ``telemetry`` (an events.Telemetry or None) records one
    ``restart`` event per relaunch, an ``elastic`` event per world
    resize, and a ``supervisor_give_up`` event on budget exhaustion.
    ``should_stop`` (checked between incarnations) lets the caller end
    supervision from the outside — the launcher's own preemption path.

    ``elastic`` (an ``elastic.ElasticPolicy``) turns host losses into
    world resizes instead of fixed-size retries: the next incarnation's
    world size and evicted-host set ride the env
    (``DTT_ELASTIC_WORLD`` / ``DTT_ELASTIC_EVICTED``); a successful
    shrink or grow refunds the budget and resets the backoff (the
    reconfiguration IS the recovery). ``on_incident`` is called with
    each finalized Incident — the launcher writes per-attempt
    summaries from it."""
    policy = policy or RestartPolicy()
    os.makedirs(state_dir, exist_ok=True)
    result = SuperviseResult(returncode=0)
    budget = policy.max_restarts
    streak = 0  # consecutive failures without checkpoint progress
    incarnation = 0
    estate = (elastic_mod.ElasticState(world=elastic.base_world)
              if elastic is not None else None)
    elastic_dir = os.path.join(state_dir, "elastic")

    def _notify(incident: Incident) -> None:
        if on_incident is not None:
            try:
                on_incident(incident)
            except Exception:  # noqa: BLE001 — a summary-writing
                # callback must never take down the restart loop.
                logger.exception("on_incident callback failed")

    while True:
        base = os.path.join(state_dir, f"exit_{incarnation}")
        # A previous supervisor run in the same state_dir (log dirs
        # default to a constant path) left sentinels at these indices;
        # pids differ so the glob would mix its verdicts into THIS
        # incarnation's classification — e.g. a stale watchdog_abort
        # burning budget on a run that just completed.
        for stale in glob.glob(f"{base}.pid*.json"):
            try:
                os.remove(stale)
            except OSError:
                pass
        env = {ENV_SENTINEL: base,
               ENV_RESTART_COUNT: str(incarnation)}
        if estate is not None:
            # Stale requests from a previous incarnation (or a previous
            # supervisor run) must not evict a healthy host now.
            elastic_mod.clear_eviction_request(elastic_dir)
            env[elastic_mod.ENV_WORLD] = str(estate.world)
            env[elastic_mod.ENV_EVICTED] = ",".join(
                map(str, estate.evicted))
            env[elastic_mod.ENV_ELASTIC_DIR] = elastic_dir
            if estate.world < elastic.base_world and elastic.grow:
                # Arm the launcher's grow watcher: once the reduced
                # world has committed this many NEW checkpoints (and
                # capacity holds), it signals the incarnation down at
                # that checkpoint boundary for the grow-back relaunch.
                env[elastic_mod.ENV_GROW_AFTER_CKPTS] = str(
                    elastic.required_ckpts_before_grow(estate.flaps))
        pre_steps = (set(checkpoint_steps_on_disk(ckpt_dir))
                     if ckpt_dir else set())
        t0 = time.monotonic()
        raw = run_incarnation(env)
        wall = time.monotonic() - t0
        report = (raw if isinstance(raw, elastic_mod.GroupReport)
                  else elastic_mod.GroupReport(returncode=int(raw)))
        rc = report.returncode
        statuses = read_exit_statuses(base)
        outcome = classify_exit(rc, statuses)
        lost: list[int] = []
        lost_reason = None
        if estate is not None and outcome != COMPLETED:
            lost, lost_reason = elastic_mod.lost_hosts_of(
                report, statuses, elastic_dir)
            if lost:
                outcome = HOST_LOST
        post_steps = (set(checkpoint_steps_on_disk(ckpt_dir))
                      if ckpt_dir else set())
        step = max(post_steps) if post_steps else None
        # Progress = a NEW committed checkpoint this incarnation, not
        # a higher number than ever seen: a restore-time quarantine
        # LOWERS the latest on-disk step while the incarnation still
        # genuinely advances from its usable base — comparing against
        # an all-time high-water mark would burn budget on a
        # recovering run until it re-passed the condemned step.
        advanced = bool(post_steps - pre_steps)
        incident = Incident(incarnation=incarnation, returncode=rc,
                            outcome=outcome, wall_s=wall,
                            ckpt_step=step, advanced=advanced,
                            world_size=(estate.world if estate
                                        else report.world_size),
                            evicted=(list(estate.evicted) if estate
                                     else []),
                            lost_hosts=list(lost))
        result.incidents.append(incident)
        if outcome == COMPLETED:
            incident.budget_after = budget
            result.returncode = 0
            for line in result.summary_lines():
                logger.info("%s", line)
            _notify(incident)
            return result
        if should_stop is not None and should_stop():
            # The SUPERVISOR was told to stop (e.g. the launcher was
            # preempted and forwarded the signal): the children saved
            # and exited — releasing the machine beats restarting the
            # job the infrastructure just reclaimed.
            incident.budget_after = budget
            result.returncode = rc
            logger.warning("supervisor: stop requested; not "
                           "restarting (last outcome %s rc=%d)",
                           outcome, rc)
            _notify(incident)
            return result
        decision = None
        if estate is not None:
            old_world = estate.world
            decision = elastic.decide_after_exit(
                estate, outcome, lost, lost_reason,
                new_ckpts=len(post_steps - pre_steps),
                grow_requested=report.grow_requested)
            incident.elastic_action = decision.action
            if decision.action != "retry":
                logger.warning(
                    "supervisor: elastic %s — world %d -> %d%s",
                    decision.action, old_world, estate.world,
                    f" (evicted {sorted(estate.evicted)})"
                    if estate.evicted else "")
                if telemetry is not None:
                    telemetry.event(
                        "elastic", incarnation=incarnation,
                        action=decision.action, old_world=old_world,
                        new_world=estate.world,
                        lost_hosts=list(lost), lost_reason=lost_reason,
                        evicted=list(estate.evicted), outcome=outcome,
                        ckpt_step=step)
        # Budget: checkpoint progress (or a clean preemption, which is
        # the infrastructure's fault, not the job's) refunds; anything
        # else burns. This is what turns a deterministic step-N crash
        # into a fast, bounded give-up (see module docstring). A
        # successful elastic shrink/grow also refunds AND resets the
        # backoff streak: the failure was answered by reconfiguration,
        # so the relaunch is immediate.
        if decision is not None and decision.refund:
            budget = policy.max_restarts
            streak = 0
        elif advanced:
            budget = policy.max_restarts
            streak = 0
        elif outcome in (PREEMPTED, HOST_LOST):
            # Refund the budget (not the job's fault) but KEEP the
            # backoff escalating: a preemption storm with zero
            # checkpoint progress must wait out the capped backoff
            # between attempts, never hot-loop restarts. A host loss
            # the policy chose NOT to shrink on (replacement capacity,
            # min_world floor) is the same infrastructure-shaped
            # failure.
            budget = policy.max_restarts
            streak += 1
        else:
            budget -= 1
            streak += 1
        incident.budget_after = budget
        if budget < 0:
            result.returncode = rc if rc != 0 else 1
            logger.error(
                "supervisor: giving up after %d incarnation(s) — no "
                "checkpoint progress in the last %d attempt(s) "
                "(crash-loop); last outcome %s rc=%d",
                len(result.incidents), streak, outcome, rc)
            for line in result.summary_lines():
                logger.error("%s", line)
            if telemetry is not None:
                telemetry.event("supervisor_give_up",
                                incarnations=len(result.incidents),
                                streak=streak, outcome=outcome,
                                returncode=rc)
                if telemetry.events_jsonl:
                    # The crash-loop give-up is exactly the moment a
                    # human gets paged: leave a flight-recorder bundle
                    # next to the events stream (lazy import keeps the
                    # parent telemetry-free until this terminal path).
                    from distributed_training_tpu_torch.telemetry.incident \
                        import write_incident_bundle
                    write_incident_bundle(
                        os.path.join(
                            os.path.dirname(telemetry.events_jsonl),
                            "incidents"),
                        reason=("crash-loop: no checkpoint progress in "
                                f"the last {streak} attempt(s)"),
                        kind="give_up",
                        events_tail=telemetry.tail(),
                        extra={"incarnations": len(result.incidents),
                               "streak": streak, "outcome": outcome,
                               "returncode": rc})
            _notify(incident)
            return result
        delay = policy.backoff_s(streak) if streak else 0.0
        incident.backoff_s = delay
        logger.warning(
            "supervisor: incarnation %d exited %s (rc=%d) after %.1fs; "
            "ckpt_step=%s%s; restarting in %.2fs "
            "(budget %d/%d)",
            incarnation, outcome, rc, wall, step,
            " (advanced)" if advanced else "", delay, budget,
            policy.max_restarts)
        if telemetry is not None:
            extra = {}
            if incident.world_size is not None:
                # Topology history for postmortems: the size this
                # incarnation ran at and who was excluded from it.
                extra = {"world_size": incident.world_size,
                         "evicted_hosts": list(incident.evicted)}
            telemetry.event("restart", incarnation=incarnation,
                            outcome=outcome, returncode=rc,
                            ckpt_step=step, advanced=advanced,
                            backoff_s=round(delay, 3), budget=budget,
                            **extra)
        _notify(incident)
        if delay > 0:
            sleep(delay)
        incarnation += 1



# ---------------------------------------------------------------------------
# serving supervision (in-process engine restarts)
# ---------------------------------------------------------------------------


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
