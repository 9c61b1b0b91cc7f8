"""The artifact and the processes of ``tests/test_torch_server_cli.py``.

    python tests/test_torch_server_world.py <out_dir>

trains the committed plan ``serving_4dev_cpu_decode``'s model (d_model
64, 2 layers, 256 tokens; its ``model_kwargs``) for two steps on the CPU
through the port's trainer CLI, then exports the checkpoint with
``checkpoint/export.py --plan serving_4dev_cpu_decode``, so the artifact
carries the plan's provenance stamp and nothing is downloaded. It writes
``<out_dir>/model.pt``. ``serve`` starts the port's server CLI, one
process per rank of a gloo world. It imports only the port (and torch,
numpy), never JAX. The file holds no tests.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

from distributed_training_tpu_torch.checkpoint import export
from distributed_training_tpu_torch.parallel.planner import load_plan
from distributed_training_tpu_torch.train import cli

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_plan_world import cli_overrides  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = "serving_4dev_cpu_decode"
CONFIG = os.path.join(REPO, "conf", "serving", "default.yaml")
# Two steps at a constant rate, no warm-up: the first update moves the
# weights, so the tokens depend on more than the prompt's last token.
STEPS = 2


def server_prompts(seed: int = 29, n: int = 6) -> list:
    """``n`` prompts of 4–20 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(4, 21)))
            .astype(np.int32) for _ in range(n)]


def make_artifact(out_dir: str) -> str:
    model = dict(load_plan(PLAN).inputs["model_kwargs"])
    overrides = [o for o in cli_overrides(model)
                 if not o.startswith("train.max_steps_per_epoch")]
    run = os.path.join(out_dir, "run")
    assert cli.main(overrides + [
        f"train.max_steps_per_epoch={STEPS}", f"train.save_every={STEPS}",
        "train.warmup_steps=0", "train.lr_schedule=constant",
        "train.learning_rate=0.03", f"run.output_dir={run}"]) == 0
    path = os.path.join(out_dir, "model.pt")
    assert export.main(["--ckpt", os.path.join(run, "default",
                                               "checkpoints"),
                        "--out", path, "--plan", PLAN]) == 0
    return path


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve(args: list, world: int, cwd: str) -> list:
    """``python -m distributed_training_tpu_torch.serving.server <args>``
    in ``world`` processes (``RANK``/``WORLD_SIZE``/``MASTER_*`` set when
    ``world`` > 1), working directory ``cwd``; each process's standard
    error goes to ``<cwd>/rank<r>.log``, its standard output to a pipe."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if world > 1:
        env.update(WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()))
    procs = []
    for rank in range(world):
        if world > 1:
            env = dict(env, RANK=str(rank), LOCAL_RANK=str(rank))
        with open(os.path.join(cwd, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "distributed_training_tpu_torch.serving.server", *args],
                cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=log,
                text=True))
    return procs


if __name__ == "__main__":
    make_artifact(sys.argv[1])
