"""Offline evaluation CLI: score a trained checkpoint on a dataset (port
of ``eval.py``).

    python -m distributed_training_tpu_torch.eval --run-dir outputs/default
    python -m distributed_training_tpu_torch.eval --run-dir outputs/byte \\
        --dataset bytes --dataset-kwargs '{"path": "corpus.bin",
        "seq_len": 512}' --batch-size 8 --max-batches 50

The model is rebuilt from the run's ``resolved_config.yaml``, the params
come from the newest (or ``--step``) checkpoint whatever mesh wrote it,
and the dataset defaults to the run's own. Each batch is scored with
``model.loss(train=False)`` in one process; only whole batches are
scored (a wrap-padded batch would count rows twice) unless the dataset
is smaller than one batch, and then the result says ``"padded": true``.
It runs on the CUDA card unless ``--device cpu`` is given.

Prints ONE JSON line: ``{"loss", "perplexity", "tokens", "batches",
"step"}`` (as the JAX CLI), plus ``"seconds"`` and the kernels'
``"kernel_launches"`` in this process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtt-torch-eval",
        description="Score a trained checkpoint on a dataset (the PyTorch "
                    "port)")
    p.add_argument("--run-dir", required=True,
                   help="training run dir (resolved_config.yaml + "
                        "checkpoints)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: newest)")
    p.add_argument("--dataset", default=None,
                   help="dataset registry name (default: the run's "
                        "train.dataset)")
    p.add_argument("--dataset-kwargs", default=None,
                   help="JSON dict (default: the run's "
                        "train.dataset_kwargs)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="default: the run's train.batch_size")
    p.add_argument("--max-batches", type=int, default=0,
                   help="0 = the whole dataset")
    p.add_argument("--device", default=None,
                   help="'cpu' to score on the CPU (default: the CUDA "
                        "card)")
    p.add_argument("--events-jsonl", default=None,
                   help="append the eval span and result event here "
                        "(default: off)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)

    from distributed_training_tpu_torch.data import (
        ShardedDataLoader,
        build_dataset,
    )
    from distributed_training_tpu_torch.generate import (
        _build_model_from_cfg,
        _load_run_config,
        _restore_params,
    )
    from distributed_training_tpu_torch.ops import kernel_launches
    from distributed_training_tpu_torch.runtime import (
        Runtime,
        resolve_device,
    )
    from distributed_training_tpu_torch.telemetry import events

    device = resolve_device(args.device)
    tel = None
    if args.events_jsonl:
        # fresh=False: the natural target is the run's own events.jsonl,
        # which an evaluation appends to and never truncates.
        tel = events.install(events.Telemetry(
            events_jsonl=args.events_jsonl, fresh=False))
    try:
        cfg = _load_run_config(args.run_dir)
        model = _build_model_from_cfg(cfg, device)
        params, step = _restore_params(args.run_dir, cfg.train.snapshot_path,
                                       args.step, device)
        # A dataset override starts from empty kwargs: the run's belong
        # to its own dataset.
        if args.dataset_kwargs is not None:
            ds_kwargs = json.loads(args.dataset_kwargs)
        elif args.dataset:
            ds_kwargs = {}
        else:
            ds_kwargs = dict(cfg.train.dataset_kwargs)
        dataset = build_dataset(
            args.dataset or cfg.train.dataset,
            _defaults={"size": cfg.train.dataset_size,
                       "seed": cfg.train.seed},
            **ds_kwargs)
        batch_size = args.batch_size or cfg.train.batch_size
        loader = ShardedDataLoader(dataset, Runtime(device=device),
                                   batch_size=batch_size, shuffle=False)
        full_steps = loader.sampler.num_samples // batch_size
        padded = full_steps == 0
        score_steps = max(full_steps, 1)
        if args.max_batches:
            score_steps = min(score_steps, args.max_batches)

        losses, tokens = [], 0
        t0 = time.perf_counter()
        with events.span("eval", run_dir=args.run_dir, step=step), \
                torch.no_grad():
            it = loader.epoch(0)
            for i, batch in enumerate(it):
                if i >= score_steps:
                    break
                loss, _ = model.loss(params, batch, train=False)
                # Stays on the device: one sync, after the last batch.
                losses.append(loss)
                first = next(iter(batch.values()))
                tokens += int(np.prod(first.shape))
            it.close()
            if not losses:
                raise ValueError("dataset yielded no batches")
            mean = float(np.mean([float(x) for x in losses]))
        rec = {"loss": round(mean, 6),
               "perplexity": round(float(np.exp(mean)), 4),
               "tokens": tokens, "batches": len(losses), "step": step}
        if padded:
            rec["padded"] = True  # dataset < one batch: rows repeat
        events.event("eval_result", **rec)
        rec["seconds"] = time.perf_counter() - t0
        rec["kernel_launches"] = kernel_launches()
        print(json.dumps(rec))
    finally:
        if tel is not None:
            events.uninstall()
            tel.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
