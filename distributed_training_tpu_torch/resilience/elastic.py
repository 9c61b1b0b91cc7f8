"""Elastic world-size policy: shrink and grow a run without losing it
(port of ``resilience/elastic.py``, which is framework-free; this is the
port's own copy).

When a host is lost (crashed, reclaimed, or evicted), the supervised run
resumes from its newest manifested checkpoint at the surviving world
size: the checkpoint manager reassembles each saved leaf and places it by
the new layout (``checkpoint/manager.py``), the train CLI derives the
per-shard batch from ``train.global_batch_size`` so the global batch is
kept (``per_shard_batch``), and the streaming loader re-deals only the
rows not yet consumed (``data/stream.py``). When capacity returns, the
launcher's grow watcher signals the shrunken run down at a checkpoint
boundary and the supervisor relaunches it at full size.

Decision table (``ElasticPolicy.decide_after_exit``):

| outcome                     | capacity to replace | action            |
|-----------------------------|---------------------|-------------------|
| whole-group crash           | —                   | retry, same world |
| whole-job preemption        | —                   | retry, same world |
| host lost (involuntary)     | yes                 | retry, same world |
| host lost (involuntary)     | no                  | **shrink**        |
| host evicted                | either              | **shrink**        |
| any, at ``min_world``       | —                   | retry             |

A successful shrink or grow refunds the supervisor's retry budget and
resets its backoff. A shrunken world grows back after
``grow_after_ckpts * 2**flaps`` new checkpoints (the dwell doubles each
time a shrink follows a grow, so a flapping host cannot thrash the run).

An eviction is never an in-band kill: every host leaves its step loop at
the same step, saves, and exits with a ``host_lost`` sentinel, and an
eviction-request file (``write_eviction_request``, written by the
straggler detector, ``telemetry/straggler.py``) names the host for the
supervisor.

Standard library only: this module runs in the launcher process next to
the supervisor and is imported by the train CLI for the batch
arithmetic.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field, replace
from typing import Callable

logger = logging.getLogger(__name__)

# Environment contract between the supervisor and each incarnation.
ENV_WORLD = "DTT_ELASTIC_WORLD"          # resolved world size
ENV_EVICTED = "DTT_ELASTIC_EVICTED"      # comma-separated host ids
ENV_ELASTIC_DIR = "DTT_ELASTIC_DIR"      # eviction-request sentinel dir
ENV_GROW_AFTER_CKPTS = "DTT_ELASTIC_GROW_AFTER"  # launcher grow watcher

# Exit code resilience/faults.py's ``lose_host`` uses for its
# no-cleanup death (os._exit) — distinct from the watchdog's 42 and
# from 128+signum signal deaths, so a lost host reads as a crash whose
# identity the launcher's group report pins down.
LOST_HOST_EXIT_CODE = 97

EVICTION_REQUEST = "eviction_request.json"

# How a host was lost (``lost_hosts_of`` reasons).
LOST_EVICTION = "eviction"
LOST_INVOLUNTARY = "lost"


def evicted_from_env(env: dict | None = None) -> list[int]:
    """Evicted-host set this incarnation inherited (ENV_EVICTED)."""
    raw = (env if env is not None else os.environ).get(ENV_EVICTED, "")
    return [int(x) for x in raw.split(",") if x.strip().isdigit()]


def per_shard_batch(global_batch: int, shard_count: int) -> int:
    """Per-data-shard batch size preserving the global batch across
    world sizes. Elastic runs must pick a ``train.global_batch_size``
    divisible by every world size they can shrink to (e.g. 12 for a
    4-host run that may run at 3) — an uneven split would silently
    change the optimization trajectory, so it fails loudly instead."""
    if global_batch <= 0:
        raise ValueError(
            f"global_batch_size must be > 0, got {global_batch}")
    if global_batch % shard_count:
        raise ValueError(
            f"train.global_batch_size={global_batch} does not divide "
            f"evenly over {shard_count} data shard(s) — elastic runs "
            "need a global batch divisible by every world size they "
            "can shrink to (e.g. 12 for 4-or-3 hosts)")
    return global_batch // shard_count


@dataclass(frozen=True)
class GroupReport:
    """What the launcher observed about one incarnation's process
    group — the per-process detail ``classify_exit`` alone cannot see.
    ``self_failed`` are processes that exited nonzero on their own;
    ``killed`` are the ones the launcher killed in its fail-fast
    teardown (their deaths are consequences, not causes)."""

    returncode: int
    world_size: int | None = None
    self_failed: tuple[int, ...] = ()
    killed: tuple[int, ...] = ()
    completed: tuple[int, ...] = ()
    grow_requested: bool = False


# ---------------------------------------------------------------------------
# eviction-request sentinel (written by the straggler detector's
# coordinator, consumed — and cleared — by the supervisor)
# ---------------------------------------------------------------------------


def write_eviction_request(elastic_dir: str, host: int, step: int,
                           **info) -> str:
    """Atomic sentinel: "evict host K" — the supervisor consumes it at
    the incarnation boundary; it is never an in-band kill."""
    os.makedirs(elastic_dir, exist_ok=True)
    path = os.path.join(elastic_dir, EVICTION_REQUEST)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"host": int(host), "step": int(step),
                   "t": time.time(), **info}, f)
    os.replace(tmp, path)
    return path


def read_eviction_request(elastic_dir: str | None) -> dict | None:
    if not elastic_dir:
        return None
    path = os.path.join(elastic_dir, EVICTION_REQUEST)
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if (isinstance(rec, dict)
                   and isinstance(rec.get("host"), int)) else None


def clear_eviction_request(elastic_dir: str | None) -> None:
    if not elastic_dir:
        return
    try:
        os.remove(os.path.join(elastic_dir, EVICTION_REQUEST))
    except OSError:
        pass


def lost_hosts_of(report: GroupReport, statuses: list[dict],
                  elastic_dir: str | None = None
                  ) -> tuple[list[int], str | None]:
    """Which hosts this incarnation lost, and why.

    Precedence: (1) clean eviction exits — every host writes a
    ``host_lost`` sentinel naming the evictee; (2) the coordinator's
    eviction-request FILE (covers a group that died during teardown
    before its sentinels landed); (3) the launcher's group report — a
    strict subset of processes that failed on their own while the rest
    completed or were killed in the fail-fast sweep is a lost host. A
    whole group failing together is a crash, not a host loss."""
    evicted = sorted({s["lost_host"] for s in statuses
                      if s.get("outcome") == "host_lost"
                      and isinstance(s.get("lost_host"), int)})
    if evicted:
        return evicted, LOST_EVICTION
    req = read_eviction_request(elastic_dir)
    if req is not None:
        return [req["host"]], LOST_EVICTION
    if report.self_failed and (report.killed or report.completed):
        return sorted(report.self_failed), LOST_INVOLUNTARY
    return [], None


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------


@dataclass
class ElasticState:
    """Mutable world-topology state the supervisor threads through
    incarnations (also what postmortems want: the topology history)."""

    world: int
    evicted: list[int] = field(default_factory=list)
    flaps: int = 0               # shrinks that followed a grow-back
    grows: int = 0
    ckpts_since_shrink: int = 0


@dataclass(frozen=True)
class Decision:
    """One incarnation-boundary decision."""

    action: str                  # "retry" | "shrink" | "grow"
    world: int
    evicted: tuple[int, ...] = ()
    reason: str | None = None
    # True → the reconfiguration itself is recovery: refund the retry
    # budget and reset the backoff streak (relaunch immediately).
    refund: bool = False


@dataclass
class ElasticPolicy:
    """Shrink/grow knobs (CLI: ``--elastic*`` on launch.local).

    ``replace_lost`` models "capacity available to hot-replace a lost
    host at relaunch" — False (the production default: a preempted
    host is gone for a while) makes involuntary losses shrink;
    ``capacity`` is the grow-back probe (None → always available,
    which is what a local simulation wants)."""

    base_world: int
    min_world: int = 1
    replace_lost: bool = False
    grow: bool = True
    grow_after_ckpts: int = 1
    capacity: Callable[[], bool] | None = None

    def capacity_available(self) -> bool:
        return True if self.capacity is None else bool(self.capacity())

    def required_ckpts_before_grow(self, flaps: int) -> int:
        """Grow-back hysteresis: each shrink that followed a grow
        doubles the dwell (in committed checkpoints) before the next
        grow — a flapping host cannot thrash the mesh."""
        return self.grow_after_ckpts * (2 ** min(max(0, flaps), 6))

    # -- decisions ---------------------------------------------------------

    def decide_after_exit(self, state: ElasticState, outcome: str,
                          lost_hosts: list[int],
                          lost_reason: str | None,
                          new_ckpts: int = 0,
                          grow_requested: bool = False) -> Decision:
        """Mutates ``state`` and returns the decision for the next
        incarnation. ``outcome`` is a supervisor exit class;
        ``new_ckpts`` is how many new steps this incarnation committed
        (feeds the grow-back dwell)."""
        if state.world < self.base_world:
            state.ckpts_since_shrink += max(0, new_ckpts)
        decision = self._decide(state, outcome, lost_hosts,
                                lost_reason, grow_requested)
        if decision.action == "shrink":
            if state.grows:
                state.flaps += 1
            state.world = decision.world
            state.evicted = sorted(set(state.evicted)
                                   | set(decision.evicted))
            state.ckpts_since_shrink = 0
        elif decision.action == "grow":
            state.world = decision.world
            # Host indices are fungible across incarnations: growing
            # back re-adds SLOTS, not the condemned machine (a real
            # fleet hands the slot to a replacement host).
            state.evicted = []
            state.grows += 1
            state.ckpts_since_shrink = 0
        return decision

    def _decide(self, state: ElasticState, outcome: str,
                lost_hosts: list[int], lost_reason: str | None,
                grow_requested: bool) -> Decision:
        survivors = state.world - len(lost_hosts)
        if lost_hosts and lost_reason == LOST_EVICTION:
            # A persistent straggler is SICK — retrying with it in the
            # mesh reproduces the slowdown, capacity or not.
            if survivors >= self.min_world:
                return Decision("shrink", survivors,
                                tuple(lost_hosts), LOST_EVICTION,
                                refund=True)
            logger.warning(
                "eviction of host(s) %s ignored: %d survivor(s) would "
                "fall below min_world=%d", lost_hosts, survivors,
                self.min_world)
            return Decision("retry", state.world,
                            reason="below_min_world")
        if lost_hosts:
            if self.replace_lost and self.capacity_available():
                return Decision("retry", state.world,
                                reason="replacement_capacity")
            if survivors >= self.min_world:
                return Decision("shrink", survivors,
                                tuple(lost_hosts), LOST_INVOLUNTARY,
                                refund=True)
            return Decision("retry", state.world,
                            reason="below_min_world")
        # No specific host lost: whole-group crash / preemption /
        # watchdog — a same-size retry, but take the grow-back
        # opportunity when one is due (every restart is a checkpoint
        # boundary).
        if self._grow_due(state, grow_requested):
            return Decision("grow", self.base_world, reason="grow_back",
                            refund=True)
        return Decision("retry", state.world, reason=outcome)

    def _grow_due(self, state: ElasticState,
                  grow_requested: bool) -> bool:
        if not self.grow or state.world >= self.base_world:
            return False
        if not self.capacity_available():
            return False
        if grow_requested:
            # The launcher's grow watcher already verified the dwell
            # before it signaled the incarnation down.
            return True
        return (state.ckpts_since_shrink
                >= self.required_ckpts_before_grow(state.flaps))
