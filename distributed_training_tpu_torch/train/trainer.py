"""The Trainer: train step and epoch orchestration (port of
``train/trainer.py``).

``make_train_step`` is the JAX step in eager PyTorch: the model's loss,
``torch.autograd.grad`` over every param leaf, the global norm of the
unclipped gradients (the ``grad_norm`` metric), the optimizer chain, and
an in-place update. ``Trainer`` keeps the JAX orchestration: resume from
the newest checkpoint (params, optimizer state, step and the loader's
cursor), the epoch loop with ``data_wait``/``step`` telemetry spans, a
metrics row every ``log_every`` steps, a checkpoint every ``save_every``
epochs, ``total_steps``/``max_steps_per_epoch``, and ``nan_guard``.

One process drives one card (``ddp`` on a world of 1). The JAX trainer's
other hooks are not ported yet and asking for one raises, naming its
ROADMAP.md queue A item.
"""

from __future__ import annotations

import logging
import time
from typing import Mapping

import numpy as np
import torch

from distributed_training_tpu_torch.models.base import count_params
from distributed_training_tpu_torch.parallel import get_strategy
from distributed_training_tpu_torch.telemetry import events as telemetry
from distributed_training_tpu_torch.train import state as state_lib
from distributed_training_tpu_torch.train.optimizer import (
    build_optimizer,
    flatten,
    global_norm,
)
from distributed_training_tpu_torch.utils.metrics import MetricsLogger

logger = logging.getLogger(__name__)

# TrainConfig fields whose feature is not ported yet: field → (the value
# that leaves it off, what it is, its ROADMAP.md queue A item).
_UNPORTED = {
    "grad_accum_steps": (1, "gradient accumulation", 4),
    "offload_opt_state": (False, "optimizer-state offload", 4),
    "divergence_check_every": (0, "the replica-drift check", 4),
    "sharding_plan": ("", "sharding plans", 17),
    "eval_fraction": (0.0, "held-out evaluation", 5),
    "data_sources": ({}, "the streaming data pipeline", 14),
    "fault_plan": ("", "fault injection", 14),
    "watchdog_timeout_s": (0.0, "the hang watchdog", 15),
    "profile_dir": ("", "whole-run profiling", 15),
    "profile_at": ("", "in-run profile capture", 15),
    "metrics_port": (0, "the live metrics endpoint", 15),
    "hbm_sample_every": (0, "HBM sampling", 15),
}


def refuse_unported(tcfg) -> None:
    """Raise for a TrainConfig that asks for a feature this slice does
    not run."""
    for name, (off, what, item) in _UNPORTED.items():
        if getattr(tcfg, name) not in (off, None):
            raise NotImplementedError(
                f"train.{name}={getattr(tcfg, name)!r}: {what} waits for "
                f"ROADMAP.md queue A item {item}")


def make_train_step(model, optimizer, nan_guard: bool = False):
    """The train step ``(state, batch) -> metrics``, updating ``state``
    in place. With ``nan_guard``, a step whose loss or gradient norm is
    not finite leaves params and optimizer state as they were (one host
    sync per step to decide)."""

    def train_step(state: dict, batch: Mapping[str, torch.Tensor]) -> dict:
        params = state["params"]
        flat = flatten(params)
        loss, metrics = model.loss(params, batch, train=True)
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        metrics = dict(metrics)
        metrics["grad_norm"] = global_norm(grads.values())
        ok = True
        if nan_guard:
            ok = bool(torch.isfinite(loss) & torch.isfinite(metrics["grad_norm"]))
            metrics["skipped_nonfinite"] = torch.tensor(float(not ok))
        if ok:
            updates, state["opt_state"] = optimizer.update(
                grads, state["opt_state"], flat)
            with torch.no_grad():
                for k, p in flat.items():
                    p.add_(updates[k])
        state["step"] += 1
        return metrics

    return train_step


class Trainer:
    """Config-driven training orchestrator on one device."""

    def __init__(self, cfg, runtime, model, loader, checkpointer=None):
        self.cfg = cfg
        self.rt = runtime
        self.model = model
        self.loader = loader
        self.checkpointer = checkpointer
        self.telemetry = telemetry.current()
        self._steps_dispatched = 0
        tcfg = cfg.train
        refuse_unported(tcfg)
        self.strategy = get_strategy(tcfg.parallel_strategy,
                                     gather_on_save=tcfg.gather_on_save)
        self._check_dataset()
        total_steps = tcfg.total_steps or (
            loader.steps_per_epoch * tcfg.total_epochs)
        self.optimizer = build_optimizer(tcfg, total_steps)
        self._step_fn = make_train_step(model, self.optimizer,
                                        nan_guard=tcfg.nan_guard)

        self.epochs_run = 0
        restored = (checkpointer.restore_latest(model.device)
                    if checkpointer is not None else None)
        if restored is not None:
            self.state, meta = restored
            state_lib.with_grad(self.state["params"])
            self._resume_loader(meta)
            logger.info("resumed from checkpoint: epoch=%d step=%d",
                        self.epochs_run, self.state["step"])
        else:
            self.state = state_lib.init_state(model, self.optimizer,
                                              tcfg.seed)
            logger.info("initialized fresh state: %d params",
                        count_params(self.state["params"]))
        self.global_step = self.state["step"]
        flops_per_sample = (model.flops_per_sample()
                            if hasattr(model, "flops_per_sample") else 0)
        self.metrics = MetricsLogger(
            log_every=tcfg.log_every,
            samples_per_step=loader.global_batch,
            flops_per_sample=flops_per_sample,
            num_devices=runtime.num_devices,
            enabled=runtime.is_coordinator,
            device_kind=runtime.device_kind,
            jsonl_path=tcfg.metrics_jsonl or None,
            jsonl_fresh=restored is None,
            start_step=self.global_step,
            on_entry=lambda entry: self.telemetry.event("train_metrics",
                                                        **entry))

    def _check_dataset(self) -> None:
        """The model/dataset contract, checked before the first step:
        batch keys, and token ids inside the model's vocab."""
        ds = getattr(self.loader, "dataset", None)
        if ds is None or len(ds) == 0:
            return
        need = set(getattr(self.model, "batch_keys", ()) or ())
        have = set(ds.batch(np.array([0])).keys())
        if not need <= have:
            raise ValueError(
                f"model expects batch keys {sorted(need)} but the dataset "
                f"yields {sorted(have)}")
        model_vocab = getattr(getattr(self.model, "cfg", None),
                              "vocab_size", None)
        ds_vocab = getattr(ds, "vocab_size", None)
        if model_vocab and ds_vocab and ds_vocab > model_vocab:
            raise ValueError(
                f"the dataset draws token ids from a vocab of {ds_vocab} "
                f"but the model embeds only {model_vocab}: set train."
                "dataset_kwargs.vocab_size to the model's vocab")

    def _resume_loader(self, meta: dict) -> None:
        """Continue the interrupted epoch at its saved cursor; a cursor
        this loader cannot use falls back to an epoch-boundary resume
        (replaying a mid-epoch save's epoch), as the JAX trainer does."""
        self.epochs_run = int(meta.get("epoch", -1)) + 1
        data_state = meta.get("data")
        if data_state:
            try:
                self.loader.load_state_dict(data_state)
                self.epochs_run = self.loader.resume_epoch
                return
            except (ValueError, KeyError, TypeError) as e:
                logger.warning("checkpointed loader state unusable (%s); "
                               "resuming at the epoch boundary", e)
        if isinstance(data_state, dict) and data_state.get("mid_epoch"):
            self.epochs_run = max(0, self.epochs_run - 1)
        self.loader.seek_epoch(self.epochs_run)

    # -- loops -------------------------------------------------------------

    def train_step(self, batch) -> dict:
        # The first step builds the kernels (the JAX trainer's "compile"
        # span); later ones are "step" spans. Kernels run asynchronously:
        # a span is host time up to the enqueue of the step's last launch.
        name = "compile" if self._steps_dispatched == 0 else "step"
        with self.telemetry.span(name, step=self.global_step + 1):
            metrics = self._step_fn(self.state, batch)
        self._steps_dispatched += 1
        self.global_step += 1
        return metrics

    def _run_epoch(self, epoch: int) -> dict:
        losses = []
        it = iter(self.loader.epoch(epoch))
        try:
            while True:
                with self.telemetry.span("data_wait",
                                         step=self.global_step + 1):
                    batch = next(it, None)
                if batch is None:
                    break
                metrics = self.train_step(batch)
                self.metrics.record(self.global_step, metrics, epoch=epoch)
                losses.append(metrics["loss"])
        finally:
            # Close the iterator on every exit: the prefetch worker is
            # stopped and joined, and the loader's position stays at the
            # last batch the optimizer saw.
            it.close()
        # One host sync per epoch (the losses stay on the device until
        # here, unless a metrics row read one).
        mean_loss = (float(np.mean([float(x) for x in losses]))
                     if losses else float("nan"))
        return {"epoch": epoch, "mean_loss": mean_loss}

    def train(self, max_epochs: int | None = None) -> dict:
        max_epochs = max_epochs or self.cfg.train.total_epochs
        summary: dict = {}
        t0 = time.perf_counter()
        self.telemetry = telemetry.current()
        for epoch in range(self.epochs_run, max_epochs):
            summary = self._run_epoch(epoch)
            if self.rt.is_coordinator:
                logger.info("epoch %d | mean_loss %.6f", epoch,
                            summary["mean_loss"])
            save_every = self.cfg.train.save_every
            if (self.checkpointer is not None and save_every > 0
                    and epoch % save_every == 0):
                meta = {"epoch": epoch, **self._arch_meta(),
                        "data": self.loader.state_dict()}
                self.checkpointer.save(self.global_step, self.state,
                                       meta=meta)
            self.epochs_run = epoch + 1
        if self.checkpointer is not None:
            self.checkpointer.wait()
        summary["wall_time_s"] = time.perf_counter() - t0
        return summary

    def _arch_meta(self) -> dict:
        """Architecture identity stamped into every checkpoint meta."""
        return {"model_name": self.cfg.model.name,
                "model_kwargs": dict(self.cfg.model.kwargs),
                "model_dtype": self.cfg.model.kwargs.get(
                    "dtype", self.cfg.train.dtype),
                "loss": self.cfg.train.loss}
