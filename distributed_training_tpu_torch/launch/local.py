"""Local multi-process launcher (port of ``launch/local.py``).

Spawns ``num_processes`` OS processes on this machine, each one rank of
a ``torch.distributed`` world that rendezvouses at a local TCP store:
every child gets torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
which ``runtime.initialize_runtime`` reads. The counterpart of
``torchrun --nproc_per_node N`` and of ``mp.spawn`` in the reference
playground::

    python -m distributed_training_tpu_torch.launch --nproc 2 -- \\
        -m distributed_training_tpu_torch.train train.device=cpu

One device per process: the trainer takes ``cuda:LOCAL_RANK`` (NCCL) or,
under ``train.device=cpu``, the CPU (gloo). While it waits, the launcher
forwards SIGTERM/SIGINT to the children (their preemption guard saves
and exits cleanly), kills the group on the first failure (torchrun's
fail-fast) and returns the first failure's exit code; when process 0's
log shows that the store's port was taken between the probe and its
bind, the whole group is relaunched on a fresh port.

``--supervise`` runs incarnations of the group under the restart
supervisor (``resilience/supervisor.py::supervise``): exits are
classified by the children's exit sentinels, a restart that commits a
new checkpoint under ``--ckpt-dir`` refunds the budget of
``--max-restarts``, and failures without progress back off from
``--backoff-base-s``. Supervisor state and its ``events.jsonl`` go to
``<log-dir>/supervisor/``, each incarnation's logs and ``summary.json``
to ``<log-dir>/attempt_<i>/``. ``--elastic`` (with ``--supervise``)
re-forms the group at the surviving world size when a host is lost
(``resilience/elastic.py``), never below ``--elastic-min-world``, and
grows it back after ``--elastic-grow-after-ckpts`` new checkpoints at
the smaller size (``_GrowWatcher`` signals the group down at that
checkpoint boundary) unless ``--elastic-no-grow``. ``--metrics-port``
appends ``train.metrics_port=PORT`` to the command (process 0 serves
``/metrics`` there), and ``--summarize RUN_DIR`` prints the run dir's
merged cross-host telemetry report after a clean exit (each process
writes ``host_<i>/events.jsonl``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass

from distributed_training_tpu_torch.resilience import elastic as elastic_mod
from distributed_training_tpu_torch.resilience import supervisor as sup
from distributed_training_tpu_torch.resilience.elastic import GroupReport
from distributed_training_tpu_torch.resilience.integrity import (
    checkpoint_steps_on_disk,
)

logger = logging.getLogger(__name__)

# Exported per spawn attempt (see ``run_group``): which port-retry
# attempt a child belongs to. Production children ignore it; tests use
# it to script a first-attempt bind failure.
ENV_PORT_ATTEMPT = "DTT_PORT_ATTEMPT"

# What torch's TCP store prints when its port was taken between the
# ``_free_port`` probe and its own bind (the race ``run_group`` retries).
_BIND_FAILURE_MARKERS = ("address already in use", "eaddrinuse",
                         "failed to bind")


def _free_port(attempts: int = 8) -> int:
    """A free TCP port (bounded retry). The probe is TOCTOU: another
    process may take the port before the store binds it, which
    ``run_group`` handles by relaunching on a fresh port."""
    last: OSError | None = None
    for attempt in range(attempts):
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return s.getsockname()[1]
        except OSError as e:  # ephemeral ports exhausted: back off
            last = e
            time.sleep(0.05 * (attempt + 1))
    raise RuntimeError(
        f"could not acquire a coordinator port after {attempts} "
        f"attempts: {last}")


@dataclass
class LocalProcess:
    process_id: int
    proc: subprocess.Popen
    log_path: str | None


def launch_local(argv: list[str], num_processes: int,
                 devices_per_process: int = 1, log_dir: str | None = None,
                 env: dict[str, str] | None = None,
                 coordinator_port: int | None = None) -> list[LocalProcess]:
    """Spawn the local process group; returns handles (non-blocking).

    ``argv`` is everything after ``python`` (e.g. ``["-m",
    "distributed_training_tpu_torch.train", "train.device=cpu"]``).
    Per-process output goes to ``log_dir/proc_<i>.log`` when given.
    ``devices_per_process`` must be 1: a process drives one device."""
    if devices_per_process != 1:
        raise ValueError(
            f"devices_per_process={devices_per_process}: a process of the "
            "port drives one device (cuda:LOCAL_RANK or the CPU)")
    port = coordinator_port or _free_port()
    procs: list[LocalProcess] = []
    for pid in range(num_processes):
        child_env = dict(os.environ)
        child_env.update(env or {})
        child_env.update({
            "RANK": str(pid), "WORLD_SIZE": str(num_processes),
            "LOCAL_RANK": str(pid),
            "LOCAL_WORLD_SIZE": str(num_processes),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
        log_path = None
        stdout = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            log_path = os.path.join(log_dir, f"proc_{pid}.log")
            stdout = open(log_path, "w")
        try:
            proc = subprocess.Popen(
                [sys.executable, *argv], env=child_env, stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None)
        finally:
            if stdout is not None:
                stdout.close()  # the child holds its own descriptor
        procs.append(LocalProcess(pid, proc, log_path))
    return procs


@contextlib.contextmanager
def _forward_signals(procs: list[LocalProcess],
                     signaled: threading.Event | None = None,
                     signums=(signal.SIGTERM, signal.SIGINT)):
    """While waiting, forward SIGTERM/SIGINT to the children instead of
    dying around them, so their preemption guard still saves, and set
    ``signaled`` (the launcher itself was told to stop: a supervisor then
    stands down instead of restarting the job the infrastructure asked
    it to release). The flag belongs to the caller's run, so a signal
    taken by one launch in a process never stops a later one. A no-op
    off the main thread (``signal.signal`` would raise there)."""
    def handler(signum, frame):
        del frame
        if signaled is not None:
            signaled.set()
        logger.warning("launcher got %s: forwarding to %d child "
                       "process(es)", signal.Signals(signum).name,
                       len(procs))
        for lp in procs:
            if lp.proc.poll() is None:
                try:
                    lp.proc.send_signal(signum)
                except (ProcessLookupError, OSError):
                    continue  # already reaped or exiting

    prev: dict[int, object] = {}
    try:
        for s in signums:
            prev[s] = signal.signal(s, handler)
    except ValueError:  # not the main thread: nothing to forward
        yield
        return
    try:
        yield
    finally:
        for s, p in prev.items():
            signal.signal(s, p)


def wait(procs: list[LocalProcess], timeout: float | None = None) -> int:
    """Wait for every process, killing the group on the first failure.
    Returns the first failure's exit code (0 when all succeed)."""
    return wait_report(procs, timeout).returncode


def wait_report(procs: list[LocalProcess],
                timeout: float | None = None,
                signaled: threading.Event | None = None) -> GroupReport:
    """``wait``, returning the whole ``GroupReport``. SIGTERM/SIGINT
    delivered to the launcher meanwhile are forwarded to the children
    (and set ``signaled`` when given)."""
    with _forward_signals(procs, signaled):
        return _wait_inner(procs, timeout)


def _wait_inner(procs: list[LocalProcess],
                timeout: float | None = None) -> GroupReport:
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = list(procs)
    worst = 0
    killed_ids: set[int] = set()
    self_failed: list[int] = []
    killed: list[int] = []
    completed: list[int] = []
    while pending:
        for lp in list(pending):
            budget = None
            if deadline is not None:
                budget = max(0.0, deadline - time.monotonic())
            try:
                code = lp.proc.wait(timeout=0.2 if budget is None
                                    else min(0.2, budget or 0.01))
            except subprocess.TimeoutExpired:
                if deadline is not None and time.monotonic() >= deadline:
                    for other in pending:
                        other.proc.kill()
                    raise TimeoutError(
                        f"local launch timed out after {timeout}s; "
                        f"pending={[p.process_id for p in pending]}")
                continue
            pending.remove(lp)
            if code == 0:
                completed.append(lp.process_id)
                continue
            if lp.process_id in killed_ids:
                killed.append(lp.process_id)
                continue
            self_failed.append(lp.process_id)
            if worst == 0:
                # A signal death is a negative returncode: report it as
                # a failure (128 + signal), not as max(0, code).
                worst = code if code > 0 else 128 - code
            logger.error("process %d exited %d%s: killing group",
                         lp.process_id, code,
                         f" (log: {lp.log_path})" if lp.log_path else "")
            for other in pending:
                # Only a process still alive at the sweep counts as
                # killed by the launcher.
                if other.proc.poll() is None:
                    killed_ids.add(other.process_id)
                    other.proc.kill()
    return GroupReport(returncode=worst, world_size=len(procs),
                       self_failed=tuple(sorted(self_failed)),
                       killed=tuple(sorted(killed)),
                       completed=tuple(sorted(completed)))


def coordinator_bind_failed(procs: list[LocalProcess]) -> bool:
    """Whether the (failed) group died because process 0, which binds the
    store, lost the ``_free_port`` race: its log's first 64 KiB hold a
    bind-failure marker. Other processes' logs are not read."""
    lp = next((p for p in procs if p.process_id == 0), None)
    if lp is None or lp.log_path is None:
        return False
    try:
        with open(lp.log_path, errors="replace") as f:
            text = f.read(65536).lower()
    except OSError:
        return False
    return any(m in text for m in _BIND_FAILURE_MARKERS)


def run_group(argv: list[str], num_processes: int,
              devices_per_process: int = 1, log_dir: str | None = None,
              env: dict[str, str] | None = None,
              timeout: float | None = None,
              port_attempts: int = 3, on_procs=None,
              signaled: threading.Event | None = None) -> GroupReport:
    """Launch and wait, relaunching the whole group on a fresh port when
    the store's bind lost the ``_free_port`` race (at most
    ``port_attempts`` attempts). Every attempt exports
    ``DTT_PORT_ATTEMPT``. ``on_procs`` (procs -> optional cleanup
    callable) attaches a watcher to the live group (the elastic grow
    watcher). ``signaled``: set when the launcher is signaled while it
    waits (``wait_report``)."""
    report = GroupReport(returncode=1, world_size=num_processes)
    for attempt in range(max(1, port_attempts)):
        attempt_env = dict(env or {})
        attempt_env[ENV_PORT_ATTEMPT] = str(attempt)
        procs = launch_local(argv, num_processes, devices_per_process,
                             log_dir=log_dir, env=attempt_env)
        cleanup = on_procs(procs) if on_procs is not None else None
        try:
            report = wait_report(procs, timeout, signaled)
        finally:
            if cleanup is not None:
                cleanup()
        if report.returncode == 0:
            return report
        if (attempt + 1 >= max(1, port_attempts)
                or not coordinator_bind_failed(procs)):
            return report
        logger.warning("coordinator port bind failed; retrying the group "
                       "on a fresh port (attempt %d/%d)", attempt + 2,
                       port_attempts)
    return report


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="dtt-torch-launch-local",
        description="Run a torch.distributed world of local processes")
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--devices-per-proc", type=int, default=1,
                   help="must be 1: a process drives one device")
    p.add_argument("--log-dir", default="outputs/local_launch")
    p.add_argument("--summarize", default=None, metavar="RUN_DIR",
                   help="after a clean exit, print the run dir's merged "
                        "cross-host telemetry report")
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="serve process 0's live Prometheus endpoint "
                        "(/metrics, /healthz) on this port: appends "
                        "train.metrics_port=PORT to the command")
    p.add_argument("--supervise", action="store_true",
                   help="restart dead training processes with backoff; a "
                        "restart that commits a new checkpoint refunds the "
                        "retry budget")
    p.add_argument("--max-restarts", type=int, default=3,
                   help="retry budget between checkpoint advances")
    p.add_argument("--backoff-base-s", type=float, default=1.0,
                   help="first restart delay; doubles per consecutive "
                        "failure without progress (jittered, capped)")
    p.add_argument("--ckpt-dir", default=None, metavar="DIR",
                   help="the run's train.snapshot_path, watched for "
                        "checkpoint progress (without it every failure "
                        "burns budget)")
    p.add_argument("--elastic", action="store_true",
                   help="with --supervise: on a lost host, re-form at the "
                        "surviving world size (resharded restore, per-shard "
                        "batch from train.global_batch_size), then grow "
                        "back at a checkpoint boundary")
    p.add_argument("--elastic-min-world", type=int, default=1,
                   help="never shrink below this many processes")
    p.add_argument("--elastic-grow-after-ckpts", type=int, default=1,
                   help="checkpoints a shrunken world must commit before "
                        "growing back (doubles per flap)")
    p.add_argument("--elastic-no-grow", action="store_true",
                   help="stay at the shrunken size for the rest of the run")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the python argv to run")
    args = p.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        cmd = ["-m", "distributed_training_tpu_torch.train"]
    if args.metrics_port:
        cmd = cmd + [f"train.metrics_port={args.metrics_port}"]
    if args.elastic and not args.supervise:
        p.error("--elastic requires --supervise")
    if args.supervise:
        rc = _supervised_main(args, cmd)
    else:
        rc = run_group(cmd, args.nproc, args.devices_per_proc,
                       log_dir=args.log_dir).returncode
    if rc == 0 and args.summarize:
        from distributed_training_tpu_torch.telemetry import summarize
        summarize.main([args.summarize])
    return rc


class _GrowWatcher:
    """Signals a shrunken incarnation down at a checkpoint boundary so
    the supervisor can re-form it at full size: once ``needed`` new
    steps are committed since the incarnation started, SIGTERM goes to
    the group (the preemption guard's save-and-exit path), the
    incarnation exits "preempted", and the relaunch at full size
    restores the step just saved. Never an in-band kill."""

    def __init__(self, procs: list[LocalProcess], ckpt_dir: str,
                 needed: int, poll_s: float = 0.3):
        self.procs = procs
        self.ckpt_dir = ckpt_dir
        self.needed = max(1, needed)
        self.poll_s = poll_s
        self.triggered = False
        self._baseline = set(checkpoint_steps_on_disk(ckpt_dir))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="elastic-grow", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            new = set(checkpoint_steps_on_disk(self.ckpt_dir)) - self._baseline
            if len(new) >= self.needed:
                if any(lp.proc.poll() is not None for lp in self.procs):
                    # The group is already exiting (the dwell was met by
                    # its final checkpoint, or a failure is tearing it
                    # down): a signal now would relabel that exit.
                    return
                self.triggered = True
                logger.warning("elastic: %d new checkpoint(s) at the "
                               "reduced size; signalling the group down "
                               "to grow back", len(new))
                for lp in self.procs:
                    if lp.proc.poll() is None:
                        try:
                            lp.proc.send_signal(signal.SIGTERM)
                        except (ProcessLookupError, OSError):
                            continue
                return
            self._stop.wait(self.poll_s)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _supervised_main(args, cmd: list[str]) -> int:
    """``--supervise``: incarnations of the local group under the restart
    supervisor (and, with ``--elastic``, the elastic policy)."""
    from distributed_training_tpu_torch.telemetry.events import Telemetry
    state_dir = os.path.join(args.log_dir, "supervisor")
    # This supervised run's own stop flag: set when the launcher is
    # signaled while an incarnation runs.
    signaled = threading.Event()
    tel = Telemetry(events_jsonl=os.path.join(state_dir, "events.jsonl"),
                    fresh=False)
    policy = None
    if args.elastic:
        policy = elastic_mod.ElasticPolicy(
            base_world=args.nproc, min_world=args.elastic_min_world,
            grow=not args.elastic_no_grow,
            grow_after_ckpts=args.elastic_grow_after_ckpts)

    def run_incarnation(extra_env: dict[str, str]):
        attempt = extra_env.get(sup.ENV_RESTART_COUNT, "0")
        nproc = int(extra_env.get(elastic_mod.ENV_WORLD) or args.nproc)
        grow_after = extra_env.get(elastic_mod.ENV_GROW_AFTER_CKPTS)
        watchers: list[_GrowWatcher] = []

        def on_procs(procs):
            if grow_after is None or not args.ckpt_dir:
                return None
            w = _GrowWatcher(procs, args.ckpt_dir, int(grow_after))
            watchers.append(w)
            return w.stop

        report = run_group(
            cmd, nproc, args.devices_per_proc,
            log_dir=os.path.join(args.log_dir, f"attempt_{attempt}"),
            env=extra_env, on_procs=on_procs, signaled=signaled)
        if any(w.triggered for w in watchers):
            report = dataclasses.replace(report, grow_requested=True)
        return report

    def on_incident(incident: sup.Incident) -> None:
        # The outcome and topology beside the attempt's process logs.
        d = os.path.join(args.log_dir, f"attempt_{incident.incarnation}")
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, "summary.json.tmp")
        with open(tmp, "w") as f:
            json.dump(dataclasses.asdict(incident), f, indent=1)
        os.replace(tmp, os.path.join(d, "summary.json"))

    try:
        result = sup.supervise(
            run_incarnation,
            policy=sup.RestartPolicy(max_restarts=args.max_restarts,
                                     backoff_base_s=args.backoff_base_s),
            state_dir=state_dir, ckpt_dir=args.ckpt_dir, telemetry=tel,
            should_stop=signaled.is_set, elastic=policy,
            on_incident=on_incident)
    finally:
        tel.close()
    return result.returncode


if __name__ == "__main__":
    sys.exit(main())
