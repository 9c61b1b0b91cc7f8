"""Deterministic fault injection: the test harness for recovery (port).

A copy of ``distributed_training_tpu/resilience/faults.py``, which is
framework-free. The trainer calls ``on_step`` and ``step_delay``, the
loaders ``on_data``, the streaming loader ``on_source`` and the
checkpoint manager ``on_checkpoint_saved``; the serving kinds drive the
engine's ``faults`` slot (``serving/engine.py``) and
``resilience/supervisor.py::supervise_serving``.

``train.fault_plan`` is a comma-separated plan of scheduled faults,
each a pure function of the global optimizer step — the straggler.py
discipline: on a multi-host pod every host evaluates the same trigger
at the same loop point, so an injected fault can never leave hosts on
different sides of a collective (veScale's deterministic
single-controller property, preserved under fault injection).

Grammar (docs/robustness.md)::

    plan    := entry ("," entry)*
    entry   := kind "@" step (":" modifier)*
    kind    := crash | sigterm | corrupt_ckpt | data_stall | data_error
             | data_corrupt | source_stall | lose_host | slow_host
             | engine_crash | swap_corrupt | slow_decode
             | client_disconnect                  # serving kinds
    modifier:= "always" | duration | "host=" K    # duration: "500ms"
             | "source=" NAME | "skip" | "fatal"  # source-level kinds

- ``crash@40``        raise ``InjectedCrash`` after step 40 completes
  (hard failure: no final save; recovery = supervisor restart +
  checkpoint resume).
- ``sigterm@80``      deliver SIGTERM to this process at step 80
  (exercises the PreemptionGuard clean-save path).
- ``corrupt_ckpt@120`` flip bytes in the newest committed checkpoint
  once a save at step >= 120 lands (exercises manifest verification,
  quarantine, and the restore fallback chain).
- ``data_stall@60:500ms`` sleep 500ms in batch assembly at step 60
  (exercises data_wait accounting and the hang watchdog).
- ``data_error@60``   raise a transient ``InjectedDataError`` in batch
  assembly at step 60 (exercises the loader's bounded retry).
- ``data_corrupt@60:source=wiki:skip`` the first sample read from
  source ``wiki`` at or after step 60 raises ``InjectedCorruptData``
  — a VALIDATION failure, not an IO blip, so it is never retried
  (at-or-after, the ``corrupt_ckpt`` precedent: the mixture may
  assemble the exact batch without touching the named source).
  Policy ``skip`` (the default) exercises the streaming pipeline's
  skip-and-record path (``data_skip`` event with the (source,
  sample_id), ``StreamState.skipped`` counter); ``fatal`` propagates
  and kills the run (recovery = supervisor restart; the ledger keeps
  it one-shot). ``source=`` optional — the first read of any source
  takes the hit when omitted.
- ``source_stall@60:500ms:source=wiki`` sleep 500ms in the first
  read of source ``wiki`` at or after step 60 (a single slow source
  must show up in data_wait attribution without stalling the other
  sources' cursor arithmetic).
- ``lose_host@40:host=2`` host 2 dies WITHOUT CLEANUP
  (``os._exit``) after step 40 — the machine-reclaimed shape; no
  sentinel, no final save. Exercises the launcher's lost-host
  detection and the elastic shrink path (resilience/elastic.py).
- ``slow_host@40:host=2:200ms`` host 2 sleeps 200ms inside EVERY
  measured step from step 40 on — a persistently degraded host, not a
  blip. Exercises the straggler detector's verdict → coordinated
  eviction path. Unlike the one-shot faults it keeps applying for the
  rest of its incarnation; the ledger only suppresses it after a
  restart (the degraded host was evicted — its replacement at the
  same index must not inherit the slowdown).

Serving kinds trigger on the engine LAUNCH COUNT (one per non-idle
``Engine.step`` — the serving analogue of the global step) through the
engine's ``on_launch``/``on_swap`` hooks:

- ``engine_crash@12``  raise ``InjectedCrash`` out of ``Engine.step``
  after launch 12 (recovery = the serving supervisor's in-process
  restart + KV re-adoption, resilience/supervisor.py
  ``supervise_serving``).
- ``swap_corrupt@12``  the first ``Engine.swap_weights`` publish at or
  after launch 12 fails verification and is REFUSED whole — the
  incumbent weights keep serving (at-or-after: swaps are sparse).
- ``slow_decode@12:50ms`` sleep 50ms between launches 12 and 13 — a
  one-shot degraded step (drain-deadline and SLO-attribution drills),
  not the persistent ``slow_host`` shape.
- ``client_disconnect@12`` drop one live stream listener after launch
  12 (the severed-client shape; the engine finishes the request and
  the exactly-once high-water mark keeps the stream consistent).

Host-targeted faults keep the every-host-same-loop-point discipline:
every host evaluates the trigger; only the host whose process index
matches ``host=K`` acts, and the action never involves a collective.

**One-shot vs. always:** a restarted run re-executes the steps since
the last checkpoint, so a naive step trigger re-fires every
incarnation and nothing ever recovers. Faults are therefore one-shot
by default: firing is recorded in a small ledger file BEFORE the
action, and already-fired faults are skipped after restart (every
host loads the same ledger state at startup, so the skip is as
deterministic as the trigger). ``:always`` disables the ledger for
that fault — the deliberate crash-loop used to test the supervisor's
budget exhaustion.

Every firing emits a ``fault_injected`` telemetry event.
"""

from __future__ import annotations

import json
import logging
import os
import re
import signal
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

from distributed_training_tpu_torch.resilience.elastic import (
    LOST_HOST_EXIT_CODE,
)

# Serving kinds key on the ENGINE LAUNCH COUNT (the serving analogue
# of the global step — one per non-idle ``Engine.step``): the engine's
# ``on_launch``/``on_swap`` hooks evaluate them (serving/engine.py),
# same write-before-action ledger as the trainer kinds.
SERVING_KINDS = ("engine_crash", "swap_corrupt", "slow_decode",
                 "client_disconnect")
KINDS = ("crash", "sigterm", "corrupt_ckpt", "data_stall", "data_error",
         "data_corrupt", "source_stall", "lose_host",
         "slow_host") + SERVING_KINDS
# Kinds that target one host (require a host= modifier).
HOST_KINDS = ("lose_host", "slow_host")
# Kinds that act inside a single mixture source's read path (accept a
# source= modifier; data/stream.py's per-doc hook evaluates them).
SOURCE_KINDS = ("data_corrupt", "source_stall")
# data_corrupt recovery policies (see InjectedCorruptData).
CORRUPT_POLICIES = ("skip", "fatal")

_ENTRY_RE = re.compile(r"^(?P<kind>[a-z_]+)@(?P<step>\d+)"
                       r"(?P<mods>(?::[A-Za-z0-9._=-]+)*)$")
_DURATION_RE = re.compile(r"^(?P<num>\d+(?:\.\d+)?)(?P<unit>ms|s)$")
_HOST_RE = re.compile(r"^host=(?P<host>\d+)$")
_SOURCE_RE = re.compile(r"^source=(?P<source>[A-Za-z0-9._-]+)$")


class FaultPlanError(ValueError):
    """Malformed ``train.fault_plan`` string."""


class InjectedCrash(RuntimeError):
    """A scheduled hard failure (``crash@N``). Propagates out of the
    step loop uncaught — the process dies without a final save, which
    is the point."""


class InjectedDataError(OSError):
    """A scheduled TRANSIENT input-pipeline failure (``data_error@N``).
    Subclasses OSError so the loader's retry path treats it exactly
    like a real IO blip."""


class InjectedCorruptData(ValueError):
    """A scheduled VALIDATION failure in one source's sample read
    (``data_corrupt@N``). Subclasses ValueError — corrupt bytes do not
    improve on a retry, so the loader's transient-retry path must not
    touch it. ``corrupt_policy`` is the duck-typed attribute the
    streaming pipeline keys its skip-and-record vs. fatal handling on
    (shared with data/stream.py's ``CorruptSampleError`` so injected
    and real corruption recover through the same code path)."""

    def __init__(self, msg: str, policy: str = "skip"):
        super().__init__(msg)
        self.corrupt_policy = policy


def parse_duration_s(text: str) -> float:
    m = _DURATION_RE.match(text)
    if not m:
        raise FaultPlanError(
            f"bad duration {text!r} (want e.g. '500ms' or '2s')")
    v = float(m.group("num"))
    return v / 1000.0 if m.group("unit") == "ms" else v


@dataclass(frozen=True)
class Fault:
    kind: str
    step: int
    always: bool = False
    stall_s: float = 0.0
    host: int | None = None
    source: str | None = None
    policy: str = ""

    @property
    def key(self) -> str:
        """Ledger identity. Deliberately excludes tuning modifiers
        (durations, policies): the plan is config, the (kind, step
        [, host][, source]) tuple is the scheduled incident."""
        base = f"{self.kind}@{self.step}"
        if self.host is not None:
            base += f":host={self.host}"
        if self.source is not None:
            base += f":source={self.source}"
        return base


def parse_fault_plan(spec: str) -> tuple[Fault, ...]:
    """Parse ``"crash@40,sigterm@80,data_stall@60:500ms"`` → faults."""
    faults: list[Fault] = []
    seen: set[str] = set()
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _ENTRY_RE.match(entry)
        if not m:
            raise FaultPlanError(
                f"bad fault entry {entry!r} (want kind@step[:modifier],"
                f" kinds: {', '.join(KINDS)})")
        kind = m.group("kind")
        if kind not in KINDS:
            raise FaultPlanError(
                f"unknown fault kind {kind!r} in {entry!r} "
                f"(kinds: {', '.join(KINDS)})")
        step = int(m.group("step"))
        if step <= 0:
            raise FaultPlanError(
                f"fault step must be >= 1 in {entry!r}")
        always = False
        stall_s = 0.0
        host: int | None = None
        source: str | None = None
        policy = ""
        mods = [t for t in m.group("mods").split(":") if t]
        for tok in mods:
            hm = _HOST_RE.match(tok)
            sm = _SOURCE_RE.match(tok)
            if tok == "always":
                always = True
            elif tok in CORRUPT_POLICIES:
                policy = tok
            elif hm:
                host = int(hm.group("host"))
            elif sm:
                source = sm.group("source")
            else:
                stall_s = parse_duration_s(tok)
        if stall_s and kind not in ("data_stall", "slow_host",
                                    "source_stall", "slow_decode"):
            raise FaultPlanError(
                f"duration modifier only applies to data_stall/"
                f"slow_host/source_stall/slow_decode, got {entry!r}")
        if kind in ("data_stall", "slow_host", "source_stall",
                    "slow_decode") and not stall_s:
            raise FaultPlanError(
                f"{kind} needs a duration, e.g. "
                f"'{kind}@{step}:500ms' (got {entry!r})")
        if host is not None and kind not in HOST_KINDS:
            raise FaultPlanError(
                f"host= modifier only applies to "
                f"{'/'.join(HOST_KINDS)}, got {entry!r}")
        if kind in HOST_KINDS and host is None:
            raise FaultPlanError(
                f"{kind} needs a target, e.g. "
                f"'{kind}@{step}:host=2' (got {entry!r})")
        if source is not None and kind not in SOURCE_KINDS:
            raise FaultPlanError(
                f"source= modifier only applies to "
                f"{'/'.join(SOURCE_KINDS)}, got {entry!r}")
        if policy and kind != "data_corrupt":
            raise FaultPlanError(
                f"skip/fatal policy only applies to data_corrupt, "
                f"got {entry!r}")
        f = Fault(kind=kind, step=step, always=always, stall_s=stall_s,
                  host=host, source=source, policy=policy)
        if f.key in seen:
            raise FaultPlanError(f"duplicate fault {f.key!r}")
        seen.add(f.key)
        faults.append(f)
    return tuple(faults)


def check_plan_hooks(plan: tuple[Fault, ...],
                     has_stream_sources: bool) -> None:
    """Fail at wiring time when a plan schedules faults whose hook
    point the configured pipeline never calls: source-level kinds
    fire from the streaming loader's per-document read
    (``on_source``), which ``ShardedDataLoader`` does not have — a
    drill that silently never fires would exit 0 and validate
    nothing."""
    if has_stream_sources:
        return
    dead = [f.key for f in plan if f.kind in SOURCE_KINDS]
    if dead:
        raise FaultPlanError(
            f"fault(s) {dead} are source-level "
            f"({'/'.join(SOURCE_KINDS)}) but the run has no "
            "train.data_sources — the sharded loader never reads "
            "per-source, so they would silently never fire")


def corrupt_step_dir(step_dir: str, nbytes: int = 64) -> str | None:
    """Deterministically damage the largest file in a committed step
    dir (invert ``nbytes`` in the middle), leaving the manifest alone
    so verification CATCHES the damage. Returns the damaged path."""
    files = sorted((os.path.getsize(p), os.path.relpath(p, step_dir), p)
                   for root, _dirs, names in os.walk(step_dir)
                   for p in (os.path.join(root, n) for n in names))
    files = [f for f in files if f[0] > 0]
    if not files:
        return None
    size, _rel, path = max(files)
    with open(path, "r+b") as f:
        off = max(0, size // 2 - nbytes // 2)
        f.seek(off)
        chunk = f.read(min(nbytes, size - off))
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    return path


class FaultInjector:
    """Evaluates the plan at the three hook points (trainer step loop,
    data loader, checkpoint manager) and performs due faults.

    ``ledger_path`` holds the fired-set across restarts (one file per
    host — each host fires deterministically and records its own).
    ``ckpt_dir`` is where ``corrupt_ckpt`` finds its victim. ``host``
    is this process's index — host-targeted faults (``host=K``) act
    only when it matches, though every host evaluates the trigger."""

    def __init__(self, plan: tuple[Fault, ...] | str,
                 ledger_path: str | None = None,
                 ckpt_dir: str | None = None,
                 host: int = 0):
        self.plan = (parse_fault_plan(plan) if isinstance(plan, str)
                     else tuple(plan))
        self.ledger_path = ledger_path
        self.ckpt_dir = ckpt_dir
        self.host = int(host)
        self.fired: set[str] = set()
        if ledger_path and os.path.exists(ledger_path):
            try:
                with open(ledger_path) as f:
                    self.fired = set(json.load(f).get("fired", []))
            except (OSError, ValueError) as e:
                logger.warning("unreadable fault ledger %s (%s); "
                               "treating all faults as unfired",
                               ledger_path, e)
        # Snapshot of what had fired BEFORE this incarnation started:
        # ``slow_host`` keeps applying within the incarnation that
        # first fired it (a degraded host stays degraded) but must not
        # resume after a restart — the evicted host's replacement at
        # the same index is a healthy machine.
        self._fired_at_load: set[str] = set(self.fired)
        if self.plan:
            logger.info(
                "fault plan armed: %s (already fired: %s)",
                ", ".join(f.key + (":always" if f.always else "")
                          for f in self.plan),
                sorted(self.fired) or "none")

    # -- internals ---------------------------------------------------------

    def _due(self, step: int, kinds: tuple[str, ...]) -> list[Fault]:
        return [f for f in self.plan
                if f.kind in kinds and f.step == step
                and (f.always or f.key not in self.fired)]

    def _record(self, fault: Fault, **info) -> None:
        """Mark fired — ledger write BEFORE the action, so a fault
        that kills the process cannot re-fire after restart."""
        self.fired.add(fault.key)
        if self.ledger_path:
            os.makedirs(os.path.dirname(self.ledger_path) or ".",
                        exist_ok=True)
            tmp = f"{self.ledger_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"fired": sorted(self.fired)}, f)
            os.replace(tmp, self.ledger_path)
        from distributed_training_tpu_torch import telemetry
        # "fault_kind", not "kind": the sink uses "kind" as the record
        # type, and a kwarg would silently overwrite it.
        telemetry.event("fault_injected", fault=fault.key,
                        fault_kind=fault.kind, step=fault.step,
                        always=fault.always, **info)
        logger.warning("FAULT INJECTED: %s %s", fault.key, info or "")

    # -- hook points -------------------------------------------------------

    def on_step(self, global_step: int) -> None:
        """Trainer step loop, after step ``global_step``'s bookkeeping.
        Graceful faults fire before lethal ones so a plan scheduling
        both at one step still exercises the graceful path; the
        host-targeted ``lose_host`` fires between them (it is lethal,
        but only for its target — the survivors' next collective hangs
        until the launcher's fail-fast sweep reaps the group, exactly
        the real lost-host shape)."""
        for f in self._due(global_step, ("sigterm",)):
            self._record(f)
            signal.raise_signal(signal.SIGTERM)
        for f in self._due(global_step, ("lose_host",)):
            if f.host != self.host:
                continue  # every host evaluates; only the target acts
            self._record(f, host=self.host)
            logger.warning("lose_host: host %d dying without cleanup "
                           "(os._exit(%d))", self.host,
                           LOST_HOST_EXIT_CODE)
            os._exit(LOST_HOST_EXIT_CODE)
        for f in self._due(global_step, ("crash",)):
            self._record(f)
            raise InjectedCrash(
                f"injected crash at global step {global_step}")

    def on_launch(self, launch: int) -> list[str]:
        """Serving engine hook, after launch ``launch``'s step record
        is emitted (serving/engine.py ``_run_faults``). Performs the
        self-contained action (``slow_decode`` sleeps here — a
        degraded-step blip, not a degraded host) and returns the
        fired kinds whose action needs engine state
        (``client_disconnect``, ``engine_crash`` — graceful recorded
        before lethal, so a plan scheduling both at one launch
        ledgers both even though the crash ends the incarnation)."""
        fired: list[str] = []
        for f in self._due(launch, ("slow_decode",)):
            self._record(f, stall_s=f.stall_s, launch=launch)
            fired.append(f.kind)
            time.sleep(f.stall_s)
        for f in self._due(launch, ("client_disconnect",)):
            self._record(f, launch=launch)
            fired.append(f.kind)
        for f in self._due(launch, ("engine_crash",)):
            self._record(f, launch=launch)
            fired.append(f.kind)
        return fired

    def on_swap(self, launch: int) -> bool:
        """Weight-swap hook (``Engine.swap_weights``): True when an
        armed ``swap_corrupt`` makes THIS publish fail verification.
        At-or-after semantics (the ``corrupt_ckpt`` precedent): swaps
        are sparse, an exact launch-count match would usually never
        fire. The ledger write precedes the refusal it causes."""
        for f in self.plan:
            if (f.kind != "swap_corrupt" or launch < f.step
                    or (not f.always and f.key in self.fired)):
                continue
            self._record(f, fired_at=launch)
            return True
        return False

    def step_delay(self, global_step: int) -> float:
        """Seconds this host must stall inside the measured region of
        step ``global_step`` (``slow_host`` faults). Applies to EVERY
        step >= the trigger step for the rest of the incarnation —
        a degraded host, not a blip — and is recorded (ledger +
        telemetry) once, at first application. Skipped entirely when
        a previous incarnation already fired it (the slow host was
        evicted; its replacement is healthy)."""
        total = 0.0
        for f in self.plan:
            if (f.kind != "slow_host" or global_step < f.step
                    or f.host != self.host):
                continue
            if not f.always and f.key in self._fired_at_load:
                continue
            if f.key not in self.fired:
                self._record(f, host=self.host, stall_s=f.stall_s)
            total += f.stall_s
        return total

    def on_data(self, step: int) -> None:
        """Data path, once per batch assembly ATTEMPT (inside the
        loader's retry loop, so a transient injected error is retried
        exactly like a real one). ``step`` is the loader's
        deterministic batch counter."""
        for f in self._due(step, ("data_stall",)):
            self._record(f, stall_s=f.stall_s)
            time.sleep(f.stall_s)
        for f in self._due(step, ("data_error",)):
            self._record(f)
            raise InjectedDataError(
                f"injected transient data error at step {step}")

    def _due_source(self, step: int, source: str,
                    kinds: tuple[str, ...]) -> list[Fault]:
        """Source-level due check: fires at the FIRST matching read at
        or after the scheduled step (the ``corrupt_ckpt`` precedent —
        an exact-step match would silently never fire when the
        mixture happens to assemble that batch without touching the
        named source). Deterministic: the stream's read sequence is a
        pure function of its state on every host."""
        return [f for f in self.plan
                if f.kind in kinds and step >= f.step
                and (f.source is None or f.source == source)
                and (f.always or f.key not in self.fired)]

    def on_source(self, step: int, source: str) -> None:
        """Source-level read path (data/stream.py), once per document
        read ATTEMPT. ``step`` is the loader's deterministic batch
        counter; a fault carrying ``source=`` acts on the named
        source's first read at or after its step — an unqualified one
        hits the first read of any source. The ledger write precedes
        the raise, so a ``fatal`` corruption that kills the run is
        one-shot across restarts."""
        for f in self._due_source(step, source, ("source_stall",)):
            self._record(f, source=source, stall_s=f.stall_s,
                         fired_at=step)
            time.sleep(f.stall_s)
        for f in self._due_source(step, source, ("data_corrupt",)):
            policy = f.policy or "skip"
            self._record(f, source=source, policy=policy,
                         fired_at=step)
            raise InjectedCorruptData(
                f"injected corrupt sample in source {source!r} at "
                f"step {step}", policy=policy)

    def on_checkpoint_saved(self, step: int,
                            directory: str | None = None) -> None:
        """Checkpoint manager, after a save at ``step`` is committed.
        A ``corrupt_ckpt@N`` fires at the first save with step >= N
        (saves land on a cadence; an exact-match step would usually
        never fire). Called on the COORDINATOR only (the manager
        gates it): on shared storage N hosts XOR-flipping the same
        bytes would undo each other.

        Only steps that already have a checksum manifest are eligible
        victims: corrupting a not-yet-manifested step would let the
        later manifest flush checksum the damaged bytes and BLESS the
        corruption — the injected fault must be the one verification
        catches, never one it hides. With async saves the newest step
        is still unmanifested when this hook runs, so the previous
        step takes the damage; the fault stays pending until a
        manifested step exists."""
        directory = directory or self.ckpt_dir
        if directory is None:
            return
        from distributed_training_tpu_torch.resilience import integrity
        for f in self.plan:
            if (f.kind != "corrupt_ckpt" or step < f.step
                    or (not f.always and f.key in self.fired)):
                continue
            target = next(
                (s for s in reversed(
                    integrity.checkpoint_steps_on_disk(directory))
                 if os.path.exists(os.path.join(
                     directory, str(s), integrity.MANIFEST_NAME))),
                None)
            if target is None:
                continue
            step_dir = os.path.join(directory, str(target))
            damaged = corrupt_step_dir(step_dir)
            self._record(f, target_step=target, damaged=damaged)
