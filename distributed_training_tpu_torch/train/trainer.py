"""The Trainer: train step and epoch orchestration (port of
``train/trainer.py``).

``make_train_step`` is the JAX step in eager PyTorch: the model's loss,
``torch.autograd.grad`` over every param leaf (summed over
``grad_accum_steps`` strided microbatches and averaged), the gradients
averaged over the data processes, the global norm of the unclipped
gradients (the ``grad_norm`` metric), the optimizer chain, and an
in-place update. ``Trainer`` keeps the JAX orchestration: resume from the
newest checkpoint (params, optimizer state, step and the loader's
cursor), the epoch loop with ``data_wait``/``step`` telemetry spans, a
metrics row every ``log_every`` steps, a checkpoint every ``save_every``
epochs (and the consolidated artifact with ``gather_on_save``), a stop
on preemption agreed by every process with a mid-epoch save,
``total_steps``/``max_steps_per_epoch``, ``nan_guard``,
``offload_opt_state`` and ``divergence_check_every``, and the held-out
evaluation: with an ``eval_loader`` the trainer scores the held-out rows
every ``eval_every`` epochs (``evaluate``: the model's loss with
``train=False`` per batch, summed on the device, one host sync per
evaluation, an ``eval`` span) and logs ``val_loss``.

The strategy (``ddp``, ``zero1``, ``fsdp``, ``hybrid``, ``tp``,
``tp_fsdp``) lays the state out over the runtime's mesh
(``parallel/strategy.py``): FSDP stores the weights sharded and gathers
them one layer at a time for compute (``parallel/fsdp.py``); ZeRO-1
keeps each process's slice of the Adam moments, updates its slice of the
params and all-gathers them; tensor parallelism binds the tp group to
the model (``parallel/tensor.py``), whose block then computes on this
rank's blocks of the weights. tp ranks take the same batch: the data
axes are (dp, fsdp), and MFU counts every card. Under sequence
parallelism (``sp``) the sp members of a data shard take the same rows,
each its slice of the sequence (the loader cuts it), the model's
attention crosses the slices (``bind_sequence_parallel``), gradients
are summed over ``sp``, and tokens/s and MFU count each token once (the
global batch's rows at the global length). Under pipeline parallelism
(``pp``) the stages of a data shard take the same rows; each grad-accum
microbatch goes through the pipeline's forward and backward schedule
(``model.pipeline_grads``, ``parallel/pipeline.py``) in place of
``torch.autograd.grad``, the last stage's loss is broadcast over ``pp``
(so the logged metrics, the ``nan_guard`` decision and the stop poll
agree on every stage), each stage's partial gradients are summed over
``pp``, the pipeline's waits count in ``sync_s``, and tokens/s and MFU
count each token once. A MoE model's load-balancing aux is the global
batch's: the trainer binds the data group (the dp, fsdp and sp axes;
``bind_data_group``, ``parallel/expert.py``) over which its statistics
are summed, passes each microbatch's shard weight to the loss so that
the aux's gradient share is not weighted twice, and logs ``moe_aux``,
averaged over the grad-accum microbatches. Under
``train.sharding_plan`` the placements come from the plan's sharding
map instead (``parallel/planner.py::PlannedStrategy``), and a runtime
mesh other than the plan's raises ``PlanError`` here.

Resilience: the loader's ``state_dict()`` (the sharded loader's cursor,
or the streaming loader's whole position) rides every checkpoint's meta
and is restored before the first batch, so a resume continues
mid-epoch exactly once; a checkpoint saved under another mesh is re-cut
to this run's layout (``checkpoint/manager.py``). With a fault injector
(``train.fault_plan``) the step loop calls ``step_delay`` inside the
measured step and ``on_step`` after each step's bookkeeping, where the
JAX trainer does. An async checkpoint's copy of the state is fenced
before the next optimizer update.

Observability, wired as the JAX trainer wires it: a ``GoodputLedger``
takes the depth-0 spans into its buckets and the loop emits ``goodput``
window events every ``log_every`` steps and a run event at the end (MFU
from the model's FLOPs against ``utils/metrics.py``'s peak for the
card); an ``HBMSampler`` samples the card's allocator every
``hbm_sample_every`` steps beside the state's exact bytes; the hang
watchdog (``watchdog``, built by the CLI) is armed before each batch is
fetched, with ten times the allowance on the first step; an in-run
``ProfileCapture`` starts before the fetch and, once its steps are in,
emits an ``attribution`` event; the ``StragglerDetector`` exchanges the
window's step and data_wait times every ``straggler_every`` steps in a
world of several processes, and a verdict that persists
``straggler_evict_after`` windows stops every process at the same step
for an elastic eviction. Dropout masks are seeded from ``train.seed``,
the step, the microbatch and the data shard.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from distributed_training_tpu_torch.models.base import count_params
from distributed_training_tpu_torch.models.transformer import fold_seed
from distributed_training_tpu_torch.parallel import fsdp, planner
from distributed_training_tpu_torch.parallel import pipeline as pp_lib
from distributed_training_tpu_torch.parallel.expert import DataGroup
from distributed_training_tpu_torch.parallel.ring_attention import (
    EXCHANGES,
    SPGroup,
)
from distributed_training_tpu_torch.parallel.strategy import (
    get_strategy,
    layout as strategy_layout,
)
from distributed_training_tpu_torch.parallel.tensor import TPGroup
from distributed_training_tpu_torch.resilience import elastic
from distributed_training_tpu_torch.runtime import BATCH_AXES, MESH_AXES
from distributed_training_tpu_torch.telemetry import events as telemetry
from distributed_training_tpu_torch.telemetry.goodput import GoodputLedger
from distributed_training_tpu_torch.telemetry.hbm import HBMSampler
from distributed_training_tpu_torch.telemetry.straggler import (
    StragglerDetector,
)
from distributed_training_tpu_torch.train import state as state_lib
from distributed_training_tpu_torch.train.optimizer import (
    build_optimizer,
    flatten,
    global_norm,
)
from distributed_training_tpu_torch.utils import diagnostics
from distributed_training_tpu_torch.utils.memory import (
    state_bytes_per_device,
)
from distributed_training_tpu_torch.utils.metrics import (
    MetricsLogger,
    peak_flops_per_chip,
)

logger = logging.getLogger(__name__)

def microbatches(batch: Mapping, a: int) -> list:
    """The strided split of the JAX step: microbatch ``i`` holds rows
    ``i, i+a, i+2a, …`` of the batch."""
    if a <= 1:
        return [batch]
    return [{k: v[i::a] for k, v in batch.items()} for i in range(a)]


def _live_targets(micro: list, runtime) -> torch.Tensor:
    """The live targets (the loss's denominator) of each data shard in
    each microbatch, (data shards, microbatches) f32: this process
    counts its slice's, and one all-reduce over the data shards and
    ``sp`` sums the slices and fills in the other shards."""
    counts = torch.zeros((runtime.data_shard_count, len(micro)),
                         device=runtime.device)
    counts[runtime.data_shard_index] = torch.stack(
        [(torch.as_tensor(mb["tokens"])[:, 1:] >= 0).sum()
         for mb in micro]).to(counts)
    dist.all_reduce(counts, group=runtime.group(BATCH_AXES + ("sp",)))
    return counts


def make_train_step(model, optimizer, nan_guard: bool = False,
                    grad_accum_steps: int = 1, layout: dict | None = None,
                    runtime=None, before_update=None,
                    dropout_seed: int | None = None):
    """The train step ``(state, batch) -> metrics``, updating ``state``
    in place. With ``nan_guard``, a step whose loss or gradient norm is
    not finite leaves params and optimizer state as they were (one host
    sync per step to decide). ``layout``/``runtime``: the placements of
    the state's leaves over the runtime's mesh (None: one process,
    whole leaves). ``before_update``: called right before the in-place
    update (the checkpointer's fence on an async save's copy). The
    step's ``sync_s`` attribute holds the host seconds its last call
    spent in the gradient synchronisation (0 without a process group).
    ``dropout_seed``: the run's seed, from which each microbatch's
    dropout seed is folded with the step, the microbatch index and this
    process's data shard (None: the model draws no masks).

    Across data shards the loss is the global batch's mean over real
    tokens, as the JAX step's is: with several shards and a token batch,
    each shard's loss is weighted by its share of the live targets (one
    all-reduce of the counts per step, ``_live_targets``), a weight of
    exactly 1 when the shards hold equal counts. Under a mesh with
    ``pp`` the model's ``pipeline_grads`` runs each microbatch's
    forward and backward schedule and accumulates this stage's
    gradients into the leaves' ``.grad``, which the step takes and
    clears; within a microbatch the loss is the batch's sum of
    negative log-likelihoods over its count of live targets, whatever
    the pipeline's microbatches hold."""
    shard = runtime.data_shard_index if runtime is not None else 0
    pls = (layout or {}).get("params", {})
    opt_pls = (layout or {}).get("opt", {})
    tp_partial = (layout or {}).get("tp_partial", ())
    sharded = runtime is not None and runtime.mesh is not None
    # ZeRO-1's leaves: whole params, moments on a slice of them.
    sliced = {k: pl for k, pl in opt_pls.items()
              if pl is not None and pls.get(k) is None}
    # The group each split leaf's sum of squares is summed over.
    split_over = {pl.axes: runtime.group(pl.axes)
                  for pl in pls.values() if pl is not None}
    norm_groups = {k: split_over[pl.axes] for k, pl in pls.items()
                   if pl is not None}
    weigh = sharded and runtime.data_shard_count > 1
    pipelined = sharded and runtime.spec.pp > 1

    def train_step(state: dict, batch: Mapping[str, torch.Tensor]) -> dict:
        params = state["params"]
        flat = flatten(params)
        leaves = list(flat.values())
        grads, metrics = None, {}
        micro = microbatches(batch, grad_accum_steps)
        wait0 = EXCHANGES["wait_s"] + pp_lib.EXCHANGES["wait_s"]
        t_counts = time.perf_counter()
        weighted = weigh and "tokens" in batch
        if weighted:
            counts = _live_targets(micro, runtime)
            weights = (counts[shard] * runtime.data_shard_count
                       / counts.sum(0).clamp(min=1))
        counts_s = time.perf_counter() - t_counts
        for i, mb in enumerate(micro):
            rng = (None if dropout_seed is None else
                   fold_seed(dropout_seed, state["step"] + 1, i, shard))
            if pipelined:
                loss, m = model.pipeline_grads(
                    params, mb, rng=rng,
                    scale=weights[i] if weighted else None)
            else:
                # A model with a data group (its MoE aux is the global
                # batch's) is told the weight, which the aux's gradient
                # must not take a second time.
                kw = ({"shard_weight": weights[i]}
                      if weighted and hasattr(model, "bind_data_group")
                      else {})
                loss, m = model.loss(params, mb, rng=rng, train=True, **kw)
            if weighted:
                loss = loss * weights[i]
                m = {**m, "loss": m["loss"] * weights[i]}
            if not pipelined:
                g = torch.autograd.grad(loss, leaves)
                grads = list(g) if grads is None else [
                    a + b for a, b in zip(grads, g)]
            for k, v in m.items():
                metrics[k] = v if k not in metrics else metrics[k] + v
        if pipelined:
            # Accumulated over the microbatches; a leaf this stage never
            # used (another stage's embedding or head) is a zero part.
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in leaves]
            for p in leaves:
                p.grad = None
        grads = dict(zip(flat, grads))
        if len(micro) > 1:
            grads = {k: g / len(micro) for k, g in grads.items()}
            metrics = {k: v / len(micro) for k, v in metrics.items()}
        t_sync = time.perf_counter()
        if sharded:
            fsdp.average_grads(grads, pls, runtime, tp_partial)
            metrics = fsdp.mean_over_data(metrics, runtime)
        # Nonlinear derived metrics don't average: recompute from the
        # mean loss, as the JAX step does.
        if "perplexity" in metrics:
            metrics["perplexity"] = torch.exp(metrics["loss"])
        gnorm = global_norm(grads.values(),
                            [norm_groups.get(k) for k in grads])
        metrics["grad_norm"] = gnorm
        # Host seconds in the step's collectives (the gradient
        # synchronisation, the sequence-parallel and the pipeline's
        # exchanges, the count of live targets): on a blocking backend
        # (gloo) they are the wait for the slowest process, or for a
        # neighbouring stage.
        train_step.sync_s = (time.perf_counter() - t_sync + counts_s
                             + EXCHANGES["wait_s"]
                             + pp_lib.EXCHANGES["wait_s"] - wait0
                             if sharded else 0.0)
        ok = True
        if nan_guard:
            ok = bool(torch.isfinite(metrics["loss"]) & torch.isfinite(gnorm))
            metrics["skipped_nonfinite"] = torch.tensor(float(not ok))
        if ok:
            if before_update is not None:
                before_update()
            with torch.no_grad():
                views = {k: fsdp.local_view(p, sliced.get(k), runtime)
                         for k, p in flat.items()}
                gviews = {k: fsdp.local_view(g, sliced.get(k), runtime)
                          for k, g in grads.items()}
                updates, state["opt_state"] = optimizer.update(
                    gviews, state["opt_state"], views, gnorm=gnorm)
                for k, v in views.items():
                    v.add_(updates[k])
                if sliced:
                    whole = fsdp.gather_full(
                        {k: views[k] for k in sliced}, sliced, runtime)
                    for k in sliced:
                        flat[k].copy_(whole[k])
        state["step"] += 1
        return metrics

    train_step.sync_s = 0.0
    return train_step


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, page-locked when ``t`` is on the card."""
    if t.device.type == "cuda":
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.detach().clone()


class Trainer:
    """Config-driven training orchestrator over the runtime's mesh."""

    def __init__(self, cfg, runtime, model, loader, checkpointer=None,
                 preemption_guard=None, params: dict | None = None,
                 eval_loader=None, fault_injector=None, watchdog=None,
                 profile_capture=None):
        """``params``: whole weights to start from instead of the
        seed's init (ignored when a checkpoint resumes).
        ``eval_loader``: the held-out rows, scored every ``eval_every``
        epochs. ``fault_injector``: a ``resilience.faults.FaultInjector``
        whose step hooks the loop calls. ``watchdog``: a
        ``telemetry.watchdog.HangWatchdog`` armed around each step
        (owned by the caller). ``profile_capture``: a
        ``telemetry.attribution.ProfileCapture`` (None: no capture)."""
        self.cfg = cfg
        self.rt = runtime
        self.model = model
        self.loader = loader
        self.eval_loader = eval_loader
        self.checkpointer = checkpointer
        # Cooperative stop flag (SIGTERM → save + clean exit); see
        # utils/preemption.py. None → never stops early.
        self.preemption_guard = preemption_guard
        self.faults = fault_injector
        self.watchdog = watchdog
        self.profiles = profile_capture
        self.ledger = None
        self.hbm = None
        self._stop_agreed = False
        self.telemetry = telemetry.current()
        self._steps_dispatched = 0
        self._div_check_done = False
        tcfg = cfg.train
        # A no-op in a world of one process or with straggler_every=0.
        self.straggler = StragglerDetector(
            runtime, every=tcfg.straggler_every,
            threshold=tcfg.straggler_threshold,
            persist=tcfg.straggler_persist,
            evict_after=tcfg.straggler_evict_after,
            elastic_dir=os.environ.get(elastic.ENV_ELASTIC_DIR))
        if runtime.process_count > 1 and runtime.mesh is None:
            raise RuntimeError(
                f"a world of {runtime.process_count} processes without a "
                "process group and mesh: build the runtime with "
                "initialize_runtime under torch.distributed")
        if tcfg.grad_accum_steps < 1 or (
                loader.batch_size % tcfg.grad_accum_steps):
            raise ValueError(
                f"grad_accum_steps={tcfg.grad_accum_steps} must divide "
                f"the per-shard batch_size={loader.batch_size}")
        # The layout's source: a resolved plan when one is pinned (its
        # sharding map by path, on exactly the plan's mesh), else the
        # strategy's rules.
        if tcfg.sharding_plan:
            plan = planner.load_plan(tcfg.sharding_plan)
            planner.check_plan_runtime(plan, runtime.spec)
            self.strategy = planner.PlannedStrategy(
                plan=plan, min_shard_elems=tcfg.min_shard_elems,
                gather_on_save=tcfg.gather_on_save)
        else:
            self.strategy = get_strategy(
                tcfg.parallel_strategy, runtime.spec,
                min_shard_elems=tcfg.min_shard_elems,
                gather_on_save=tcfg.gather_on_save)
        total_steps = tcfg.total_steps or (
            loader.steps_per_epoch * tcfg.total_epochs)
        self.optimizer = build_optimizer(tcfg, total_steps)
        self.layout = self._layout()
        self._bind_gather()
        self._bind_tensor_parallel()
        self._bind_sequence_parallel()
        self._bind_pipeline()
        self._bind_data_group()
        self._check_dataset()
        self.optimizer.bind_layout(
            flatten(model.param_shapes()),
            (self.layout or {}).get("opt", {}), runtime.group)
        self._step_fn = make_train_step(
            model, self.optimizer, nan_guard=tcfg.nan_guard,
            grad_accum_steps=tcfg.grad_accum_steps,
            layout=self.layout, runtime=runtime,
            before_update=getattr(checkpointer, "fence", None),
            dropout_seed=(tcfg.seed if getattr(getattr(model, "cfg", None),
                                               "dropout", 0.0) > 0.0
                          else None))

        self.epochs_run = 0
        restored = (checkpointer.restore_latest(model.device, self.layout)
                    if checkpointer is not None else None)
        if restored is not None:
            self.state, meta = restored
            state_lib.with_grad(self.state["params"])
            self._resume_loader(meta)
            logger.info("resumed from checkpoint: epoch=%d step=%d",
                        self.epochs_run, self.state["step"])
        else:
            self.state = state_lib.init_state(model, self.optimizer,
                                              tcfg.seed, self.layout,
                                              runtime, params=params)
            logger.info("initialized fresh state: %d params on this "
                        "process", count_params(self.state["params"]))
        # Optimizer-state offload: the moments live in (pinned) host
        # memory between steps and visit the device for the update.
        self._offload = tcfg.offload_opt_state
        if self._offload:
            self.offload_opt_state()
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
        # The HBM samples' cross-check: this process's state bytes on
        # its device (moments offloaded to the host count zero).
        self._state_bytes_est = (
            state_bytes_per_device(self.state["params"], device=model.device)
            + state_bytes_per_device(self.state["opt_state"],
                                     device=model.device))
        self._flops_per_step = flops_per_sample * loader.global_batch
        self._bind_telemetry()

    def _bind_telemetry(self) -> None:
        """(Re)resolve the ambient Telemetry and build the goodput ledger
        and the HBM sampler against it: at construction and at the top of
        ``train``, so a sink installed after the Trainer was built still
        gets the trainer's spans."""
        tel = telemetry.current()
        if tel is self.telemetry and (self.ledger is not None
                                      or not tel.enabled):
            return
        self.telemetry = tel
        if not tel.enabled:
            self.ledger = self.hbm = None
            return
        self.ledger = GoodputLedger(
            flops_per_step=self._flops_per_step,
            num_devices=self.rt.num_devices,
            peak_flops=peak_flops_per_chip(self.rt.device_kind) or 0.0)
        tel.attach_ledger(self.ledger)
        self.hbm = HBMSampler(tel, every=self.cfg.train.hbm_sample_every,
                              estimate_bytes=self._state_bytes_est,
                              device=self.model.device)

    # -- layout ------------------------------------------------------------

    def _layout(self) -> dict | None:
        """Each leaf's placement over the mesh (None without a process
        group: every leaf whole)."""
        if self.rt.mesh is None:
            return None
        shapes = flatten(self.model.param_shapes())
        out = strategy_layout(self.strategy, shapes,
                              flatten(self.model.logical_axes()))
        factored = self.optimizer.factored_layout(shapes, out["opt"])
        if factored:
            out["factored"] = factored
        return out

    def _bind_gather(self) -> None:
        """Bind the per-layer gather when any weight is stored sharded
        (the JAX trainer's gather-for-compute binding)."""
        pls = (self.layout or {}).get("params", {})
        gather = None
        if any(pl is not None for pl in pls.values()):
            if not self.cfg.train.fsdp_gather_for_compute:
                raise ValueError(
                    "train.fsdp_gather_for_compute=false: the port gathers "
                    "sharded weights for compute; it has no partitioner to "
                    "choose another layout")
            gather = fsdp.GatherForCompute(pls, self.rt,
                                           self.model.stacked_keys)
        self.model.bind_gather_for_compute(gather)

    def _bind_tensor_parallel(self) -> None:
        """Under ``tp``/``tp_fsdp`` with a process group, bind the tp
        group to the model (a group of one at tp 1: the same code and
        collectives as at tp > 1, which change no bit there)."""
        tp = None
        if self.layout is not None and self.strategy.family == "tp":
            tp = TPGroup(self.rt.group(("tp",)))
        self.model.bind_tensor_parallel(tp)

    def _bind_sequence_parallel(self) -> None:
        """With ``sp`` > 1, bind this process's sp group to the model:
        each process holds its slice of every row's sequence, and the
        model's attention crosses the slices (a model without a sequence
        raises)."""
        n = self.rt.spec.sp
        bind = getattr(self.model, "bind_sequence_parallel", None)
        if n > 1 and bind is None:
            raise ValueError(
                f"mesh.sp={n}: {type(self.model).__name__} has no "
                "sequence to split over sp")
        if bind is not None:
            bind(SPGroup(self.rt.group(("sp",))) if n > 1 else None)

    def _bind_pipeline(self) -> None:
        """With ``pp`` > 1, bind this process's pp group to the model
        (after the sp group: Ulysses' head check reads it); a model
        without a pipeline raises."""
        n = self.rt.spec.pp
        bind = getattr(self.model, "bind_pipeline", None)
        if n > 1 and bind is None:
            raise ValueError(
                f"mesh.pp={n}: {type(self.model).__name__} has no "
                "pipeline of layers to split over pp")
        if bind is not None:
            bind(pp_lib.PPGroup(self.rt.group(("pp",))) if n > 1 else None,
                 self.rt.data_shard_count)

    def _bind_data_group(self) -> None:
        """Bind the processes that hold parts of one global batch (the
        dp, fsdp and sp axes) to a model that sums statistics over them
        (MoE's aux); None with no such axis."""
        bind = getattr(self.model, "bind_data_group", None)
        if bind is None:
            return
        sizes = self.rt.spec.as_dict()
        axes = tuple(a for a in (*BATCH_AXES, "sp") if sizes[a] > 1)
        bind(DataGroup(self.rt.group(axes), self.rt.data_shard_count)
             if self.layout is not None and axes else None)

    def offload_opt_state(self) -> None:
        """Move the optimizer moments to host memory (pinned when the
        device is a card)."""
        opt = self.state["opt_state"]
        self.state["opt_state"] = {
            k: ({n: _pinned_like(t) for n, t in v.items()}
                if isinstance(v, dict) else v) for k, v in opt.items()}

    def _opt_to(self, opt: dict, host: dict | None = None) -> dict:
        """The moments copied to the device, or (``host``) back into
        ``host``'s buffers; both copies are asynchronous on the card."""
        out = {}
        for k, v in opt.items():
            if not isinstance(v, dict):
                out[k] = v
            elif host is None:
                out[k] = {n: t.to(self.model.device, non_blocking=True)
                          for n, t in v.items()}
            else:
                out[k] = {n: host[k][n].copy_(t, non_blocking=True)
                          for n, t in v.items()}
        return out

    def _check_dataset(self) -> None:
        """The model/dataset contract, checked before the first step:
        batch keys (of the training and the held-out rows), and token
        ids inside the model's vocab."""
        need = set(getattr(self.model, "batch_keys", ()) or ())
        for role, ldr in (("eval", self.eval_loader), ("train", self.loader)):
            ds = getattr(ldr, "dataset", None)
            if ds is None or len(ds) == 0:
                continue
            have = set(ds.batch(np.array([0])).keys())
            if not need <= have:
                raise ValueError(
                    f"model expects batch keys {sorted(need)} but the "
                    f"{role} dataset yields {sorted(have)}: pick a "
                    "matching train.dataset (LMs: synthetic_lm / bytes / "
                    "memmap_tokens; regression: synthetic*; images: "
                    "synthetic_images)")
        ds = getattr(self.loader, "dataset", None)
        if ds is None or len(ds) == 0:
            return
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

    # -- cooperative stop / health ----------------------------------------

    @property
    def _stopping_early(self) -> bool:
        """Leaving the run before its epochs are done: preemption
        (agreed by every process) or a coordinated eviction stop. Both
        force a final save; the CLI's exit sentinel says which."""
        return (self._stop_agreed
                or self.straggler.evict_request is not None)

    def _agreed_stop(self) -> bool:
        """Whether to break the step loop, agreed by every process: a
        process that breaks while the others run the next step would
        leave their collectives waiting forever. Every
        ``stop_poll_every`` steps (a function of the step, the same on
        every process) each contributes its flag to an all-reduce MAX."""
        if self.preemption_guard is None:
            return False
        local = self.preemption_guard.should_stop
        if self.rt.process_count == 1:
            self._stop_agreed = local
            return local
        poll = max(1, self.cfg.train.stop_poll_every)
        if self.global_step % poll == 0:
            flag = torch.tensor([int(local)], device=self.model.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            self._stop_agreed = bool(flag.item())
        return self._stop_agreed

    def _check_divergence(self) -> dict | None:
        """Replica drift of each param over the mesh axes it is
        replicated on (DDP: (dp, fsdp); an FSDP shard: dp; a layer norm
        under tp: tp too; shards fingerprinted in place). None when no
        leaf has replicas."""
        if self.rt.mesh is None:
            return None
        sizes = self.rt.spec.as_dict()
        by_axes: dict = {}
        groups = {}
        for k, pl in self.layout["params"].items():
            axes = tuple(a for a in MESH_AXES if sizes[a] > 1
                         and a not in (pl.axes if pl else ()))
            if axes:
                if axes not in by_axes:
                    by_axes[axes] = self.rt.group(axes)
                groups[k] = by_axes[axes]
        if not groups:
            return None
        return diagnostics.replica_divergence(
            flatten(self.state["params"]), groups)

    # -- loops -------------------------------------------------------------

    def train_step(self, batch) -> dict:
        # The first step builds the kernels (the JAX trainer's "compile"
        # span); later ones are "step" spans. Kernels run asynchronously:
        # a span is host time up to the enqueue of the step's last launch.
        name = "compile" if self._steps_dispatched == 0 else "step"
        with self.telemetry.span(name, step=self.global_step + 1):
            if self.faults is not None:
                # slow_host: the stall lands inside the measured step.
                delay_s = self.faults.step_delay(self.global_step + 1)
                if delay_s:
                    time.sleep(delay_s)
            host = None
            if self._offload:
                host = self.state["opt_state"]
                self.state["opt_state"] = self._opt_to(host)
            metrics = self._step_fn(self.state, batch)
            if self._offload:
                self.state["opt_state"] = self._opt_to(
                    self.state["opt_state"], host)
        self._steps_dispatched += 1
        self.global_step += 1
        return metrics

    def _sync(self) -> None:
        """Wait for the card's queued work (nothing on the CPU)."""
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _run_epoch(self, epoch: int) -> dict:
        losses = []
        tcfg = self.cfg.train
        div_every, log_every = tcfg.divergence_check_every, tcfg.log_every
        it = iter(self.loader.epoch(epoch))
        try:
            while True:
                if self.watchdog is not None:
                    # Armed before the fetch: a stalled loader is inside
                    # the window. The first step builds the kernels, so
                    # it gets ten times the allowance.
                    self.watchdog.arm(
                        step=self.global_step + 1, epoch=epoch,
                        timeout_s=(self.watchdog.timeout_s * 10
                                   if self._steps_dispatched == 0
                                   else None))
                if self.profiles is not None:
                    # Started before the fetch, so the captured window
                    # holds the step's data wait.
                    self.profiles.maybe_start(self.global_step + 1)
                t_wait0 = time.perf_counter()
                with self.telemetry.span("data_wait",
                                         step=self.global_step + 1):
                    batch = next(it, None)
                data_wait_s = time.perf_counter() - t_wait0
                if batch is None:
                    if self.watchdog is not None:
                        self.watchdog.disarm()
                    break
                t_step0 = time.perf_counter()
                metrics = self.train_step(batch)
                if self.straggler.enabled:
                    # The step's own host time: without the wait for the
                    # slowest process inside a blocking gradient sync,
                    # which would make every process look as slow.
                    self.straggler.record_step(
                        time.perf_counter() - t_step0
                        - self._step_fn.sync_s, data_wait_s)
                    # A collective on a cadence of global_step: every
                    # process enters it at the same loop point.
                    if (self.straggler.maybe_exchange(self.global_step)
                            is not None and self.watchdog is not None):
                        self.watchdog.set_context(
                            self.straggler.watchdog_info())
                if self.straggler.evict_request is not None:
                    # Every process sees the request at this exchange
                    # step: all leave together, save and exit.
                    if self.watchdog is not None:
                        self.watchdog.disarm()
                    logger.warning(
                        "stopping for elastic eviction of host %s "
                        "(requested at step %s)",
                        self.straggler.evict_request.get("host"),
                        self.straggler.evict_request.get("step"))
                    self.metrics.record(self.global_step, metrics,
                                        epoch=epoch)
                    losses.append(metrics["loss"])
                    break
                if div_every and self.global_step % div_every == 0:
                    if (self.watchdog is not None
                            and not self._div_check_done):
                        # The first check's collectives run inside the
                        # armed window: the first step's allowance.
                        self.watchdog.arm(
                            step=self.global_step, epoch=epoch,
                            timeout_s=self.watchdog.timeout_s * 10)
                    self._div_check_done = True
                    report = self._check_divergence()
                    if report is not None:
                        metrics = {**metrics, "replica_divergence":
                                   report["max_divergence"]}
                self.metrics.record(self.global_step, metrics, epoch=epoch)
                if self.hbm is not None:
                    self.hbm.maybe_sample(self.global_step)
                if (self.ledger is not None and log_every > 0
                        and self.global_step % log_every == 0):
                    self.telemetry.event(
                        "goodput", scope="window", step=self.global_step,
                        **self.ledger.window_report())
                if self.watchdog is not None:
                    self.watchdog.disarm()
                if self.profiles is not None:
                    # The capture's last step: the sync puts its device
                    # work in the trace, after the step span closed (it
                    # books to idle, not to the step bucket).
                    rep = self.profiles.maybe_stop(self.global_step,
                                                   sync=self._sync)
                    if rep is not None:
                        self.telemetry.event("attribution", **rep)
                losses.append(metrics["loss"])
                if self.faults is not None:
                    # Before the stop poll: a sigterm fault raised here
                    # is seen by _agreed_stop at the same step everywhere.
                    self.faults.on_step(self.global_step)
                if self._agreed_stop():
                    break
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
        self._bind_telemetry()
        if self.ledger is not None:
            # The ledger's wall clock starts at the loop, not at the
            # trainer's construction (init and restore are in the
            # stream, not in this run's goodput).
            self.ledger.reset()
        for epoch in range(self.epochs_run, max_epochs):
            summary = self._run_epoch(epoch)
            if self.rt.is_coordinator:
                logger.info("epoch %d | mean_loss %.6f", epoch,
                            summary["mean_loss"])
            eval_every = self.cfg.train.eval_every
            if (self.eval_loader is not None and eval_every
                    and (epoch + 1) % eval_every == 0
                    and not self._stopping_early):
                summary["val_loss"] = self.evaluate(
                    self.eval_loader.epoch(epoch))
                # Unthrottled: never dropped by the log_every window.
                self.metrics.record_scalar(self.global_step, "val_loss",
                                           summary["val_loss"], epoch=epoch)
            preempted = self._stopping_early
            save_every = self.cfg.train.save_every
            if self.checkpointer is not None and (
                    preempted or (save_every > 0
                                  and epoch % save_every == 0)):
                # Collective save: every process takes part. On
                # preemption, mid-epoch included: the loader's cursor
                # rides the meta, so the resume continues the epoch.
                self._save(epoch, force=preempted)
            if preempted:
                logger.warning("stopping at epoch %d due to %s", epoch,
                               "preemption" if self._stop_agreed
                               else "elastic eviction")
                break
            self.epochs_run = epoch + 1
        if self.checkpointer is not None:
            self.checkpointer.wait()
        summary["wall_time_s"] = time.perf_counter() - t0
        if self.ledger is not None:
            rep = self.ledger.report()
            self.telemetry.event("goodput", scope="run",
                                 step=self.global_step, **rep)
            summary["goodput"] = rep
            if self.rt.is_coordinator:
                logger.info(
                    "goodput %.1f%% over %.1fs wall (%d steps): %s",
                    100 * rep["goodput"], rep["wall_s"], rep["steps"],
                    rep["buckets"])
        return summary

    def evaluate(self, batches) -> float:
        """Mean loss over ``batches`` without updating the state
        (``model.loss(train=False)``, no autograd). Each process scores
        its shard of every batch; the per-batch losses are averaged over
        the data processes and summed on the device, and the host syncs
        once, at the end (the JAX trainer's one sync per evaluation)."""
        total, count = None, 0
        with self.telemetry.span("eval", step=self.global_step), \
                torch.no_grad():
            for b in batches:
                loss, _ = self.model.loss(self.state["params"], b,
                                          train=False)
                if self.rt.mesh is not None:
                    loss = fsdp.mean_over_data({"loss": loss},
                                               self.rt)["loss"]
                total = loss if total is None else total + loss
                count += 1
            if count == 0:
                return float("nan")
            return float(total) / count

    def _save(self, epoch: int, force: bool = False) -> None:
        if self._offload and self.model.device.type == "cuda":
            # The moments' copies back to the host are asynchronous.
            torch.cuda.synchronize(self.model.device)
        meta = {"epoch": epoch, **self._arch_meta(),
                "data": self.loader.state_dict()}
        self.checkpointer.save(self.global_step, self.state, meta=meta,
                               force=force, layout=self.layout)
        if self.strategy.gather_on_save:
            self.export_consolidated(epoch=epoch)

    def _arch_meta(self) -> dict:
        """Architecture identity stamped into every checkpoint meta."""
        return {"model_name": self.cfg.model.name,
                "model_kwargs": dict(self.cfg.model.kwargs),
                "model_dtype": self.cfg.model.kwargs.get(
                    "dtype", self.cfg.train.dtype),
                "loss": self.cfg.train.loss}

    # -- consolidated export -----------------------------------------------

    def export_consolidated(self, epoch: int | None = None) -> str:
        """Gather the whole train state and write ONE portable artifact
        (collective: every process enters; process 0 writes) at
        <snapshot_path>/consolidated_step<N>.pt."""
        from distributed_training_tpu_torch.checkpoint import consolidate
        path = os.path.join(self.cfg.train.snapshot_path,
                            f"consolidated_step{self.global_step}.pt")
        meta = {"step": self.global_step, **self._arch_meta()}
        if epoch is not None:
            meta["epoch"] = epoch
        return consolidate.export_consolidated(
            path, self.state, self.layout, self.rt, meta=meta)
