"""The port's local launcher and DDP playground (``launch/local.py``,
``playground/ddp_from_primitives.py``), on the CPU.

Launcher:

- ``run_group`` of 2 processes running the default-config MLP CLI
  (``train.device=cpu``): both ranks join one gloo world from the
  launcher's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_*``, rank 0
  writes the run, a sharded checkpoint appears; the losses equal the
  one-process CLI's over the same global batches;
- signal forwarding: SIGTERM to the launcher's process reaches both
  children (the launcher itself survives it), their preemption guard
  saves mid-run, and every exit code is 0; the stop flag it sets belongs
  to that launch, so a supervised run started later in the process
  still restarts a crashed incarnation;
- exit-code aggregation: the first failure's code, the sibling killed
  (``GroupReport``), a signal death reported as 128 + signal;
- the port retry: a first attempt whose process 0 reports
  ``EADDRINUSE`` is relaunched on a fresh port, a failure without the
  marker is not (only process 0 fails on that attempt, as in a real bind
  failure, where the others wait on the store: a second rank failing too
  could be reaped first and its sweep kill process 0 before it prints);
- ``--elastic`` without ``--supervise`` is a usage error, and more than
  one device per process is refused (``--supervise``/``--elastic`` run:
  ``tests/test_torch_supervisor.py``, ``tests/test_torch_elastic.py``).

Playground: world 2 through its own CLI (which starts the world through
the launcher) from JAX's init, against the JAX playground on 2 fake
devices: the per-epoch mean losses within 1e-6 relative and the final
params within 1e-6, equal on both ranks.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from distributed_training_tpu_torch.launch import local as launch
from distributed_training_tpu_torch.train import cli

jax = pytest.importorskip("jax")

from distributed_training_tpu.playground import ddp_from_primitives as jax_pg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_ARGS = ["train.device=cpu", "train.dataset_size=64",
            "train.batch_size=8", "train.total_epochs=2",
            "train.log_every=1", "run.log_level=WARNING"]


def _env() -> dict:
    return {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


def _losses(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if "loss" in r]


def test_two_process_mlp_cli(tmp_path):
    out = tmp_path / "run"
    report = launch.run_group(
        ["-m", "distributed_training_tpu_torch.train", *MLP_ARGS,
         f"run.output_dir={out}", f"train.snapshot_path={out}/ckpt"],
        2, log_dir=str(tmp_path / "logs"), env=_env(), timeout=240)
    logs = "".join(p.read_text() for p in (tmp_path / "logs").iterdir())
    assert report.returncode == 0, logs[-3000:]
    assert report.completed == (0, 1) and report.world_size == 2
    # Each process writes its own stream, stamped with its host index.
    for host in (0, 1):
        events = [json.loads(line) for line in open(
            out / "default" / f"host_{host}" / "events.jsonl")]
        rt = next(e for e in events if e.get("kind") == "runtime")
        assert rt["world"] == 2 and rt["backend"] == "gloo"
        assert rt["rank"] == rt["host"] == host
    assert os.path.exists(out / "ckpt" / "4" / "layout.json")
    # One process over the same global batches (2 shards x 8 rows).
    one = tmp_path / "one"
    assert cli.main([*MLP_ARGS, "train.batch_size=16",
                     f"run.output_dir={one}",
                     f"train.snapshot_path={one}/ckpt"]) == 0
    np.testing.assert_allclose(_losses(out / "default"),
                               _losses(one / "default"), rtol=1e-5)


def test_sigterm_is_forwarded(tmp_path):
    out, logs = tmp_path / "run", tmp_path / "logs"
    argv = ["-m", "distributed_training_tpu_torch.train", *MLP_ARGS,
            "train.total_epochs=100000", "train.stop_poll_every=1",
            f"run.output_dir={out}", f"train.snapshot_path={out}/ckpt"]
    procs = launch.launch_local(argv, 2, log_dir=str(logs), env=_env())
    metrics = out / "default" / "metrics.jsonl"

    def stop_when_training():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if metrics.exists() and len(metrics.read_text().splitlines()) > 3:
                break
            time.sleep(0.2)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=stop_when_training, daemon=True)
    t.start()
    report = launch.wait_report(procs, timeout=240)
    t.join()
    text = "".join(p.read_text() for p in logs.iterdir())
    assert report.returncode == 0 and report.completed == (0, 1), text[-3000:]
    saved = [d for d in os.listdir(out / "ckpt") if d.isdigit()]
    assert saved, "no checkpoint from the preempted run"
    meta = json.loads((out / "ckpt" / max(saved, key=int) /
                       "meta.json").read_text())
    assert meta["epoch"] < 100000


def test_a_signal_to_one_launch_does_not_stop_a_later_supervisor(tmp_path):
    """The stop flag a signal sets belongs to the launch that took it: a
    supervised run started later in the same process still restarts its
    crashed incarnation (a process-wide flag made it stand down)."""
    procs = launch.launch_local(["-c", "import time; time.sleep(60)"], 1,
                                log_dir=str(tmp_path / "sleep"), env=_env())

    def stop_when_running():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and procs[0].proc.poll() is None:
            if os.path.exists(procs[0].log_path):
                break
            time.sleep(0.05)
        time.sleep(0.5)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=stop_when_running, daemon=True)
    t.start()
    signaled = threading.Event()
    launch.wait_report(procs, timeout=60, signaled=signaled)
    t.join(timeout=65)
    assert signaled.is_set()
    crash_once = ("import os, sys; "
                  "sys.exit(1 if os.environ['DTT_RESTART_COUNT'] == '0' "
                  "else 0)")
    rc = launch.main(["--nproc", "1", "--log-dir", str(tmp_path / "sup"),
                      "--supervise", "--max-restarts", "1",
                      "--backoff-base-s", "0.01", "--", "-c", crash_once])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "sup")) == [
        "attempt_0", "attempt_1", "supervisor"]


def test_exit_codes_aggregate(tmp_path):
    die = ("import os, sys, time; r = os.environ['RANK']; "
           "sys.exit(3) if r == '0' else time.sleep(600)")
    procs = launch.launch_local(["-c", die], 2, log_dir=str(tmp_path))
    report = launch.wait_report(procs, timeout=60)
    assert (report.returncode, report.self_failed, report.killed) == \
        (3, (0,), (1,))
    sig = "import os, signal; os.kill(os.getpid(), signal.SIGKILL)"
    assert launch.wait(launch.launch_local(["-c", sig], 1),
                       timeout=60) == 128 + signal.SIGKILL
    ok = "import os; assert os.environ['LOCAL_RANK'] == os.environ['RANK']"
    assert launch.run_group(["-c", ok], 3).returncode == 0


def test_port_retry(tmp_path):
    # Rank 0 of the first attempt fails as a bind failure does, once
    # rank 1 has written its port: the group is killed at the first
    # failure, so a rank 1 slow to start under load would otherwise die
    # before writing it.
    script = ("import os, sys, time; a = os.environ['DTT_PORT_ATTEMPT']; "
              "open(os.path.join(sys.argv[1], 'port' + a + '_' + "
              "os.environ['RANK']), 'w').write(os.environ['MASTER_PORT']); "
              "r = os.environ['RANK']; "
              "[time.sleep(0.05) for _ in range(600) if (a, r) == "
              "('0', '0') and not os.path.exists(os.path.join("
              "sys.argv[1], 'port0_1'))]; "
              "print('EADDRINUSE: address already in use', flush=True) "
              "if (a, r) == ('0', '0') else None; "
              "sys.exit(1 if (a, r) == ('0', '0') else 0)")
    report = launch.run_group(["-c", script, str(tmp_path)], 2,
                              log_dir=str(tmp_path / "logs"))
    assert report.returncode == 0
    ports = {n: (tmp_path / n).read_text() for n in
             ("port0_0", "port0_1", "port1_0", "port1_1")}
    assert ports["port0_0"] == ports["port0_1"]
    assert ports["port1_0"] == ports["port1_1"]
    assert ports["port0_0"] != ports["port1_0"]
    # A failure that is not the bind race is not retried.
    crash = "import os, sys; sys.exit(2)"
    report = launch.run_group(["-c", crash], 2,
                              log_dir=str(tmp_path / "logs2"))
    assert report.returncode == 2
    assert not launch.coordinator_bind_failed(
        launch.launch_local(["-c", "pass"], 1))


def test_unported_launcher_options_raise(capsys):
    with pytest.raises(SystemExit):
        launch.main(["--elastic", "--", "-c", "pass"])
    assert "--elastic requires --supervise" in capsys.readouterr().err
    with pytest.raises(ValueError, match="one device"):
        launch.launch_local(["-c", "pass"], 1, devices_per_process=2)


def test_playground_world2_matches_jax(tmp_path):
    kw = dict(epochs=2, batch_size=16, lr=0.05, dataset_size=128, seed=7)
    want = jax_pg.train_ddp(world_size=2, **kw)
    init = jax_pg.init_params(jax.random.PRNGKey(7))
    np.savez(tmp_path / "init.npz", **{k: np.asarray(v)
                                       for k, v in init.items()})
    log_dir = tmp_path / "logs"
    proc = subprocess.run(
        [sys.executable, "-m",
         "distributed_training_tpu_torch.playground.ddp_from_primitives",
         "--world-size", "2", "--device", "cpu", "--epochs", "2",
         "--batch-size", "16", "--lr", "0.05", "--dataset-size", "128",
         "--seed", "7", "--init", str(tmp_path / "init.npz"),
         "--log-dir", str(log_dir), "--log-norms"],
        env=dict(os.environ, **_env()), capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "final mean_loss" in proc.stdout
    ranks = [json.loads((log_dir / f"ddp_rank_{r}.json").read_text())
             for r in range(2)]
    assert ranks[0]["params"] == ranks[1]["params"]
    np.testing.assert_allclose(
        [h["mean_loss"] for h in ranks[0]["history"]],
        [h["mean_loss"] for h in want["history"]], rtol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(
            ranks[0]["params"][k],
            np.asarray(want["params"][k]).reshape(-1), rtol=0, atol=1e-6)
    # Per-rank norm lines with per-rank losses.
    lines = [(log_dir / f"ddp_rank_{r}.log").read_text().splitlines()
             for r in range(2)]
    assert len(lines[0]) == len(lines[1]) == 8 and "|g[w]|" in lines[0][0]
    assert lines[0] != lines[1]
