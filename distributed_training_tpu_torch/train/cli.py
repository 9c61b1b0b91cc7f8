"""Training entry point of the port (port of ``train/cli.py``).

    python -m distributed_training_tpu_torch.train [key=value ...]
    python -m distributed_training_tpu_torch.train model=gpt2_125m train=gpt2

The same ``conf/`` tree and override grammar as the JAX CLI. It runs on
the CUDA card unless ``train.device=cpu`` is given. One process, one
card: the run directory gets ``resolved_config.yaml``, ``metrics.jsonl``,
``events.jsonl`` and the log file; checkpoints go to
``train.snapshot_path``, and a rerun with the same settings resumes from
the newest one.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

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

    from distributed_training_tpu_torch.checkpoint import Checkpointer
    from distributed_training_tpu_torch.config import (
        load_config,
        save_resolved,
    )
    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.runtime import initialize_runtime
    from distributed_training_tpu_torch.telemetry import events
    from distributed_training_tpu_torch.train.trainer import (
        Trainer,
        refuse_unported,
    )
    from distributed_training_tpu_torch.utils.logging import setup_logging

    cfg = load_config(args.config_dir, args.config_name, args.overrides)
    refuse_unported(cfg.train)
    run_dir = os.path.join(cfg.run.output_dir, cfg.run.experiment_name)
    os.makedirs(run_dir, exist_ok=True)
    rt = initialize_runtime(cfg)
    setup_logging(cfg.run.log_level, os.path.join(run_dir, cfg.run.log_file),
                  rt.process_index, force=True)
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
    save_resolved(cfg, os.path.join(run_dir, "resolved_config.yaml"))

    dataset = build_dataset(
        cfg.train.dataset,
        _defaults={"size": cfg.train.dataset_size, "seed": cfg.train.seed},
        **cfg.train.dataset_kwargs)
    loader = ShardedDataLoader(
        dataset, rt, batch_size=cfg.train.batch_size,
        shuffle=cfg.train.shuffle, seed=cfg.train.seed,
        drop_last=cfg.train.drop_last,
        max_steps_per_epoch=cfg.train.max_steps_per_epoch)
    model_kwargs = dict(cfg.model.kwargs)
    # A model-level dtype wins over the training compute dtype.
    model_dtype = model_kwargs.pop("dtype", cfg.train.dtype)
    model = build_model(cfg.model.name, loss=cfg.train.loss,
                        dtype=model_dtype, device=rt.device, **model_kwargs)

    with Checkpointer(cfg.train.snapshot_path) as checkpointer:
        resumed = checkpointer.latest_step() is not None
        tel = events.install(events.Telemetry(
            events_jsonl=cfg.train.events_jsonl, fresh=not resumed))
        try:
            trainer = Trainer(cfg, rt, model, loader, checkpointer)
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
    logger.info("training done: %s", summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
