"""A target's port trainer or engine on a world of its processes, and one
step of it under the collectives recorder (port of
``analysis/compile.py``).

Nothing is compiled here. JAX lowers and compiles the jitted train step
abstractly on a simulated mesh and reads the collectives from the HLO;
eager PyTorch has no program to read, so the port builds the real
Trainer (or the serving engine) on a world of ``target.devices``
processes and runs one step, whose collectives the step's own helpers
record (``telemetry/collectives.py``):

- a train target: the Trainer over the target's mesh, model, batch and
  sequence, one step of ``SyntheticLMDataset`` rows (JAX's data for the
  abstract batch), the coordinator's ``collectives`` event of it;
- a serving target: ``serving/disagg.py::compile_verify_serving`` on the
  committed plan, the gated launch recorded (its gate must agree).

A world is ``target.devices`` processes over gloo (``run_world``; all on
``cuda:0`` when the device is the card, as the smoke's mesh phases run),
or this process for a target of one device. Each world audits every
target of its size, so targets of one size share one world.

    python -m distributed_training_tpu_torch.analysis.compile JOB RANK

is one process of such a world (the job is ``run_world``'s).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def target_runtime(target, device):
    """The runtime ``target`` runs on: this process alone for a target of
    one device, else its mesh over the process group already started
    (whose world must be ``target.devices``)."""
    import torch

    from distributed_training_tpu_torch.runtime import (
        MESH_AXES,
        MeshSpec,
        Runtime,
        resolve_device,
        slice_runtime,
    )

    dev = resolve_device(device)
    if target.devices == 1:
        return Runtime(device=dev)
    spec = MeshSpec(**{a: target.mesh_axes.get(a, 1) for a in MESH_AXES})
    return slice_runtime([spec], torch.device(dev))


def build_trainer(target, rt):
    """The port's Trainer on ``target``'s model, strategy, batch and
    overrides over ``rt``, and its loader (JAX's
    ``build_abstract_trainer`` with real state)."""
    from distributed_training_tpu_torch.config import Config
    from distributed_training_tpu_torch.data import ShardedDataLoader
    from distributed_training_tpu_torch.data.datasets import (
        SyntheticLMDataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg.train.parallel_strategy = target.strategy
    cfg.train.batch_size = target.batch_size
    cfg.train.log_every = 0
    cfg.train.device = rt.device.type
    for k, v in target.train_overrides.items():
        setattr(cfg.train, k, v)
    for a, n in rt.spec.as_dict().items():
        setattr(cfg.mesh, a, n)
    kwargs = dict(target.model_kwargs)
    dtype = kwargs.pop("dtype", cfg.train.dtype)
    model = build_model(target.model, dtype=dtype, device=rt.device,
                        **kwargs)
    ds = SyntheticLMDataset(size=max(64, target.batch_size),
                            seq_len=target.seq_len,
                            vocab_size=min(model.cfg.vocab_size, 50257),
                            seed=0)
    loader = ShardedDataLoader(ds, rt, batch_size=target.batch_size,
                               shuffle=False)
    return Trainer(cfg, rt, model, loader), loader


@contextlib.contextmanager
def _recording_sink():
    """An event sink in a temporary directory, installed as the ambient
    one (the trainer emits its ``collectives`` event only while a sink
    records); the previous sink is restored after."""
    from distributed_training_tpu_torch.telemetry import events

    prev = events.current()
    with tempfile.TemporaryDirectory(prefix="dtt_audit_events_") as d:
        tel = events.install(events.Telemetry(os.path.join(d, "e.jsonl")))
        try:
            yield tel
        finally:
            tel.close()
            events.install(prev)


def train_step_report(target, rt) -> tuple:
    """``(trainer, event)``: one step of ``target``'s Trainer over
    ``rt`` and its ``collectives`` event (None on a process other than
    the coordinator)."""
    with _recording_sink() as tel:
        trainer, loader = build_trainer(target, rt)
        it = iter(loader.epoch(0))
        try:
            batch = next(it)
        finally:
            it.close()
        trainer.train_step(batch)
        event = next((e for e in tel.tail()
                      if e.get("kind") == "collectives"), None)
    if event is not None:
        event = {k: v for k, v in event.items() if k not in ("kind", "t")}
    return trainer, event


def serving_step_report(target, device) -> dict:
    """This process's ``collectives`` report of the serving target's
    gated launch (the ``resident`` objective runs the decode step its
    burst repeats); raises when the gate disagrees."""
    from distributed_training_tpu_torch.parallel import planner
    from distributed_training_tpu_torch.serving.disagg import (
        compile_verify_serving,
    )

    plan = planner.load_plan(target.serving_plan)
    objective = ("prefill" if target.serving_objective == "prefill"
                 else "decode")
    out = compile_verify_serving(types.SimpleNamespace(objective=objective),
                                 plan, device, audit=True)
    if not out["gate"]["agree"]:
        raise RuntimeError(f"{target.name}: the serving gate disagrees: "
                           f"{out['gate']}")
    return out["collectives"]


def run_world(names: list, devices: int, device: str,
              min_replicated_bytes: int, timeout_s: float = 900) -> list:
    """The audit records of targets ``names`` (each of ``devices``
    devices) from a spawned world of ``devices`` processes over gloo."""
    with tempfile.TemporaryDirectory(prefix="dtt_audit_world_") as d:
        job = {"world": devices, "targets": list(names), "device": device,
               "min_replicated_bytes": min_replicated_bytes,
               "rdzv": os.path.join(d, "rdzv"),
               "out": os.path.join(d, "records.json")}
        job_path = os.path.join(d, "job.json")
        with open(job_path, "w", encoding="utf-8") as f:
            json.dump(job, f)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       p for p in (REPO, os.environ.get("PYTHONPATH"))
                       if p))
        logs = [open(os.path.join(d, f"rank{r}.log"), "w")
                for r in range(devices)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "distributed_training_tpu_torch.analysis"
             ".compile", job_path, str(r)], env=env, stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(devices)]
        deadline = time.monotonic() + timeout_s
        try:
            codes = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
                     for p in procs]
        except subprocess.TimeoutExpired:
            codes = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if codes != [0] * devices:
            tails = []
            for r in range(devices):
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    tails.append(f"rank {r}:\n{f.read()[-3000:]}")
            raise RuntimeError(
                f"audit world of {devices} for {names} exited {codes}\n"
                + "\n".join(tails))
        with open(job["out"], encoding="utf-8") as f:
            return json.load(f)


def _worker(job_path: str, rank: int) -> int:
    """One process of ``run_world``'s world: every target of the job
    audited; rank 0 writes the records."""
    import torch
    import torch.distributed as dist

    from distributed_training_tpu_torch.analysis import audit, targets

    with open(job_path, encoding="utf-8") as f:
        job = json.load(f)
    torch.set_num_threads(1)
    device = job["device"]
    if device == "cuda":
        torch.cuda.set_device(0)
        device = "cuda:0"
    dist.init_process_group("gloo", init_method=f"file://{job['rdzv']}",
                            rank=rank, world_size=job["world"])
    try:
        records = [audit.audit_target(targets.TARGETS[n], device,
                                      job["min_replicated_bytes"])
                   for n in job["targets"]]
        if rank == 0:
            with open(job["out"], "w", encoding="utf-8") as f:
                json.dump(records, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2])))
