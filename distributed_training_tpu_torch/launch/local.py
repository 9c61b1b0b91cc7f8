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
bind, the whole group is relaunched on a fresh port. The restart
supervisor (``--supervise``, ``--elastic``) waits for ROADMAP.md queue
A item 14; the JAX launcher's cross-host report (``--summarize``) and
live metrics port (``--metrics-port``) come with item 15.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

# Exported per spawn attempt (see ``run_group``): which port-retry
# attempt a child belongs to. Production children ignore it; tests use
# it to script a first-attempt bind failure.
ENV_PORT_ATTEMPT = "DTT_PORT_ATTEMPT"

# What torch's TCP store prints when its port was taken between the
# ``_free_port`` probe and its own bind (the race ``run_group`` retries).
_BIND_FAILURE_MARKERS = ("address already in use", "eaddrinuse",
                         "failed to bind")


@dataclass
class GroupReport:
    """What the launcher saw of one process group: ``self_failed`` exited
    nonzero on their own, ``killed`` were killed in the fail-fast sweep
    (consequences, not causes). The port's own copy of the JAX
    ``resilience/elastic.py`` record, until item 14 ports that module."""

    returncode: int
    world_size: int | None = None
    self_failed: tuple[int, ...] = ()
    killed: tuple[int, ...] = ()
    completed: tuple[int, ...] = ()


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
                     signums=(signal.SIGTERM, signal.SIGINT)):
    """While waiting, forward SIGTERM/SIGINT to the children instead of
    dying around them, so their preemption guard still saves. A no-op
    off the main thread (``signal.signal`` would raise there)."""
    def handler(signum, frame):
        del frame
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
                timeout: float | None = None) -> GroupReport:
    """``wait``, returning the whole ``GroupReport``. SIGTERM/SIGINT
    delivered to the launcher meanwhile are forwarded to the children."""
    with _forward_signals(procs):
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
              port_attempts: int = 3) -> GroupReport:
    """Launch and wait, relaunching the whole group on a fresh port when
    the store's bind lost the ``_free_port`` race (at most
    ``port_attempts`` attempts). Every attempt exports
    ``DTT_PORT_ATTEMPT``."""
    report = GroupReport(returncode=1, world_size=num_processes)
    for attempt in range(max(1, port_attempts)):
        attempt_env = dict(env or {})
        attempt_env[ENV_PORT_ATTEMPT] = str(attempt)
        procs = launch_local(argv, num_processes, devices_per_process,
                             log_dir=log_dir, env=attempt_env)
        report = wait_report(procs, timeout)
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
    p.add_argument("--supervise", action="store_true",
                   help="restart dead training processes (waits for "
                        "ROADMAP.md queue A item 14)")
    p.add_argument("--elastic", action="store_true",
                   help="with --supervise: re-form at the surviving world "
                        "size (waits for ROADMAP.md queue A item 14)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the python argv to run")
    args = p.parse_args(argv)
    cmd = [c for c in args.cmd if c != "--"]
    if not cmd:
        cmd = ["-m", "distributed_training_tpu_torch.train"]
    if args.elastic and not args.supervise:
        p.error("--elastic requires --supervise")
    if args.supervise:
        raise NotImplementedError(
            "--supervise/--elastic: the restart supervisor waits for "
            "ROADMAP.md queue A item 14")
    return run_group(cmd, args.nproc, args.devices_per_proc,
                     log_dir=args.log_dir).returncode


if __name__ == "__main__":
    sys.exit(main())
