"""Training entry point of the port (port of ``train/cli.py``).

    python -m distributed_training_tpu_torch.train [key=value ...]
    python -m distributed_training_tpu_torch.train model=gpt2_125m train=gpt2
    python -m distributed_training_tpu_torch.train train=bytes_lm \
        model=byte_lm train.dataset_kwargs.path=<corpus.bin>
    torchrun --nproc_per_node 2 -m distributed_training_tpu_torch.train \
        train.device=cpu train.parallel_strategy=fsdp mesh.fsdp=2 ...
    torchrun --nproc_per_node 2 -m distributed_training_tpu_torch.train \
        train.device=cpu train.parallel_strategy=tp mesh.tp=2 ...
    torchrun --nproc_per_node 4 -m distributed_training_tpu_torch.train \
        train.device=cpu train.sharding_plan=<name or path> ...

The same ``conf/`` tree and override grammar as the JAX CLI; with no
override it trains the default config, the MLP ``Linear(20, 1)`` on
``synthetic`` under SGD and ``ddp``. ``train.eval_fraction`` splits
held-out rows off the dataset, scored every ``train.eval_every`` epochs
(``val_loss`` in ``metrics.jsonl``). It runs on
the CUDA card (``cuda:LOCAL_RANK`` under torchrun, over NCCL) unless
``train.device=cpu`` is given (gloo). Under torchrun every process runs
this; only process 0 writes ``resolved_config.yaml``, ``metrics.jsonl``
and ``events.jsonl``, and every process logs to its own file
(``<log_file>.p<rank>`` beside process 0's). Checkpoints go to
``train.snapshot_path`` (sharded under a process group), and a rerun
with the same settings resumes from the newest one. SIGTERM stops the
run at a step every process agrees on, after a final save. The process
group this CLI started is destroyed on every exit.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from distributed_training_tpu_torch.checkpoint import Checkpointer
from distributed_training_tpu_torch.config import (
    load_config,
    save_resolved,
)
from distributed_training_tpu_torch.data import (
    ShardedDataLoader,
    build_dataset,
    train_eval_split,
)
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.parallel import check_strategy
from distributed_training_tpu_torch.parallel.planner import (
    apply_plan_to_config,
)
from distributed_training_tpu_torch.runtime import (
    initialize_runtime,
    shutdown_runtime,
)
from distributed_training_tpu_torch.telemetry import events
from distributed_training_tpu_torch.train.trainer import (
    Trainer,
    refuse_unported,
)
from distributed_training_tpu_torch.utils.logging import setup_logging
from distributed_training_tpu_torch.utils.preemption import (
    PreemptionGuard,
)

logger = logging.getLogger(__name__)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtt-torch-train",
        description="Training on one NVIDIA card (the PyTorch port)")
    p.add_argument("--config-dir", default=None,
                   help="config root (default: <repo>/conf)")
    p.add_argument("--config-name", default="config")
    p.add_argument("overrides", nargs="*",
                   help="key.path=value config overrides")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)

    cfg = load_config(args.config_dir, args.config_name, args.overrides)
    if cfg.train.data_sources and cfg.train.eval_fraction > 0:
        raise ValueError(
            "train.eval_fraction is not supported with train.data_sources "
            "(the stream has no held-out split); set eval_fraction=0")
    refuse_unported(cfg.train)
    check_strategy(cfg.train.parallel_strategy)
    plan = None
    if cfg.train.sharding_plan:
        # The mesh is derived from the plan: its model-sharding axes
        # pinned, dp the wildcard; the Trainer checks the resolved mesh.
        plan = apply_plan_to_config(cfg)
    run_dir = os.path.join(cfg.run.output_dir, cfg.run.experiment_name)
    os.makedirs(run_dir, exist_ok=True)
    rt = initialize_runtime(cfg)
    guard = PreemptionGuard.install()
    try:
        return _run(cfg, rt, guard, run_dir, plan)
    finally:
        guard.uninstall()
        shutdown_runtime(rt)


def _run(cfg, rt, guard, run_dir: str, plan=None) -> int:
    setup_logging(cfg.run.log_level, os.path.join(run_dir, cfg.run.log_file),
                  rt.process_index, force=True)
    if plan is not None:
        logger.info("sharding plan %s@%s: mesh derived %s", plan.name,
                    plan.fingerprint(), plan.mesh)
    if cfg.train.global_batch_size:
        if cfg.train.global_batch_size % rt.data_shard_count:
            raise ValueError(
                f"train.global_batch_size {cfg.train.global_batch_size} "
                f"does not split over {rt.data_shard_count} shard(s)")
        cfg.train.batch_size = (cfg.train.global_batch_size
                                // rt.data_shard_count)
    if not cfg.train.metrics_jsonl:
        cfg.train.metrics_jsonl = os.path.join(run_dir, "metrics.jsonl")
    if not cfg.train.events_jsonl:
        cfg.train.events_jsonl = os.path.join(run_dir, "events.jsonl")
    logger.info("config loaded; %s", rt.describe())
    if rt.is_coordinator:
        save_resolved(cfg, os.path.join(run_dir, "resolved_config.yaml"))

    dataset = build_dataset(
        cfg.train.dataset,
        _defaults={"size": cfg.train.dataset_size, "seed": cfg.train.seed},
        **cfg.train.dataset_kwargs)
    eval_loader = None
    if cfg.train.eval_fraction > 0:
        # The held-out rows, rounded up to whole global batches so the
        # loader never wrap-pads them: val_loss is an exact mean.
        dataset, eval_ds = train_eval_split(
            dataset, cfg.train.eval_fraction, seed=cfg.train.seed,
            multiple_of=cfg.train.batch_size * rt.data_shard_count)
        eval_loader = ShardedDataLoader(
            eval_ds, rt, batch_size=cfg.train.batch_size, shuffle=False,
            seed=cfg.train.seed, data_retries=cfg.train.data_retries)
    loader = ShardedDataLoader(
        dataset, rt, batch_size=cfg.train.batch_size,
        shuffle=cfg.train.shuffle, seed=cfg.train.seed,
        drop_last=cfg.train.drop_last,
        max_steps_per_epoch=cfg.train.max_steps_per_epoch,
        data_retries=cfg.train.data_retries)
    model_kwargs = dict(cfg.model.kwargs)
    # A model-level dtype wins over the training compute dtype.
    model_dtype = model_kwargs.pop("dtype", cfg.train.dtype)
    model = build_model(cfg.model.name, loss=cfg.train.loss,
                        dtype=model_dtype, device=rt.device, **model_kwargs)

    with Checkpointer(cfg.train.snapshot_path, runtime=rt) as checkpointer:
        resumed = checkpointer.latest_step() is not None
        tel = events.install(events.Telemetry(
            events_jsonl=(cfg.train.events_jsonl if rt.is_coordinator
                          else None), fresh=not resumed))
        try:
            tel.event("runtime", backend=rt.backend,
                      world=rt.process_count, rank=rt.process_index,
                      mesh=rt.spec.as_dict(), device=str(rt.device),
                      device_kind=rt.device_kind,
                      strategy=cfg.train.parallel_strategy)
            if cfg.train.anomaly_detect:
                tel.event("anomaly_detect", running=False,
                          reason="the anomaly detector waits for "
                                 "ROADMAP.md queue A item 15")
            trainer = Trainer(cfg, rt, model, loader, checkpointer,
                              preemption_guard=guard,
                              eval_loader=eval_loader)
            if trainer.global_step > 0:
                data_state = loader.state_dict()
                tel.event("resume", step=trainer.global_step,
                          epoch=trainer.epochs_run,
                          samples_consumed=data_state["samples_consumed"],
                          global_batch=loader.global_batch)
            summary = trainer.train()
        finally:
            events.uninstall()
            tel.close()
    if rt.is_coordinator:
        logger.info("training done: %s%s", summary,
                    " (stopped by preemption)" if guard.should_stop else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
