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
this; only process 0 writes ``resolved_config.yaml`` and
``metrics.jsonl``, every process logs to its own file
(``<log_file>.p<rank>`` beside process 0's), and in a world of several
processes (or under an elastic supervisor) each writes its own event
stream, ``host_<i>/events.jsonl``, stamped with its ``host`` index, which
``python -m distributed_training_tpu_torch.telemetry <run_dir>`` merges. Checkpoints go to
``train.snapshot_path`` (sharded under a process group), and a rerun
with the same settings resumes from the newest one, on any mesh (a step
saved under another world is re-cut). SIGTERM stops the run at a step
every process agrees on, after a final save. The process group this CLI
started is destroyed on every exit.

Resilience: ``train.data_sources`` trains on the exactly-once streaming
loader (``data/stream.py``; no held-out split), ``train.fault_plan``
arms the fault injector (one-shot ledger ``faults_fired.json``), and
``train.global_batch_size`` derives the per-shard batch from however
many data shards this incarnation has (``elastic.per_shard_batch``).
Under the restart supervisor (``launch --supervise``) a restarted
incarnation appends to the run's event stream, its ``resume`` event
carries the restored data position, and a clean exit writes the
exit-status sentinel ("completed", "preempted", or "host_lost" after a
straggler eviction). Every exit, a crash included, ends the stream with
this process's ``kernel_launches``.

Observability, as the JAX CLI wires it: each stream opens with a
``clock_sync`` record; on process 0 the anomaly detector and the
incident recorder observe the stream (``train.anomaly_detect``, their
baselines replayed from the restored stream on a resume), the live
metrics endpoint serves ``train.metrics_port`` (its port written to
``<run_dir>/metrics.port``) and ``train.profile_at`` or a
``<run_dir>/profile_now`` file captures a ``torch.profiler`` trace into
``<run_dir>/profiles/``; ``train.watchdog_timeout_s`` arms the hang
watchdog on every process (postmortems under ``host_dir/postmortem``,
``train.watchdog_abort`` exits 42), and ``train.profile_dir`` traces the
whole run.
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
    StreamingDataLoader,
    build_dataset,
    build_stream_sources,
    train_eval_split,
)
from distributed_training_tpu_torch.models.registry import build_model
from distributed_training_tpu_torch.ops import kernel_launches
from distributed_training_tpu_torch.parallel import check_strategy
from distributed_training_tpu_torch.parallel.planner import (
    apply_plan_to_config,
)
from distributed_training_tpu_torch.resilience import elastic, faults
from distributed_training_tpu_torch.resilience import supervisor as sup
from distributed_training_tpu_torch.runtime import (
    initialize_runtime,
    shutdown_runtime,
)
from distributed_training_tpu_torch.telemetry import events
from distributed_training_tpu_torch.telemetry.anomaly import AnomalyDetector
from distributed_training_tpu_torch.telemetry.attribution import (
    ProfileCapture,
)
from distributed_training_tpu_torch.telemetry.incident import (
    IncidentRecorder,
)
from distributed_training_tpu_torch.telemetry.metrics_server import (
    MetricsServer,
)
from distributed_training_tpu_torch.telemetry.summarize import load_jsonl
from distributed_training_tpu_torch.telemetry.watchdog import HangWatchdog
from distributed_training_tpu_torch.train.trainer import Trainer
from distributed_training_tpu_torch.utils import profiler
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
        # The global batch is world-size-invariant; a shrunken world
        # gets a larger per-shard batch (an uneven split raises).
        cfg.train.batch_size = elastic.per_shard_batch(
            cfg.train.global_batch_size, rt.data_shard_count)
        logger.info("global batch %d over %d shard(s) -> per-shard "
                    "batch %d", cfg.train.global_batch_size,
                    rt.data_shard_count, cfg.train.batch_size)
    evicted_hosts = elastic.evicted_from_env()
    # Per-process state (the event stream, the fault ledger) lives under
    # host_<i>/ in a world of several processes, and under an elastic
    # supervisor even at world 1, so a shrunken run keeps appending to
    # each index's stream and ledger.
    elastic_incarnation = os.environ.get(elastic.ENV_WORLD) is not None
    per_host = rt.process_count > 1 or elastic_incarnation
    host_dir = (os.path.join(run_dir, f"host_{rt.process_index}")
                if per_host else run_dir)
    if not cfg.train.metrics_jsonl:
        cfg.train.metrics_jsonl = os.path.join(run_dir, "metrics.jsonl")
    if not cfg.train.events_jsonl:
        cfg.train.events_jsonl = os.path.join(host_dir, "events.jsonl")
    logger.info("config loaded; %s", rt.describe())
    if rt.is_coordinator:
        save_resolved(cfg, os.path.join(run_dir, "resolved_config.yaml"))

    fault_injector = None
    if cfg.train.fault_plan:
        fplan = faults.parse_fault_plan(cfg.train.fault_plan)
        # Source-level kinds need the streaming loader's per-document
        # hook: a drill that never fires must not pass as one.
        faults.check_plan_hooks(fplan, bool(cfg.train.data_sources))
        fault_injector = faults.FaultInjector(
            fplan, ledger_path=os.path.join(host_dir, "faults_fired.json"),
            ckpt_dir=cfg.train.snapshot_path, host=rt.process_index)

    eval_loader = None
    if cfg.train.data_sources:
        sources = build_stream_sources(
            cfg.train.data_sources,
            defaults={"size": cfg.train.dataset_size,
                      "seed": cfg.train.seed})
        loader = StreamingDataLoader(
            sources, rt, batch_size=cfg.train.batch_size,
            pack_len=cfg.train.pack_seq_len, shuffle=cfg.train.shuffle,
            seed=cfg.train.seed,
            steps_per_epoch=cfg.train.max_steps_per_epoch,
            data_retries=cfg.train.data_retries,
            fault_injector=fault_injector)
    else:
        dataset = build_dataset(
            cfg.train.dataset,
            _defaults={"size": cfg.train.dataset_size,
                       "seed": cfg.train.seed},
            **cfg.train.dataset_kwargs)
        if cfg.train.eval_fraction > 0:
            # The held-out rows, rounded up to whole global batches so
            # the loader never wrap-pads them: val_loss is an exact mean.
            dataset, eval_ds = train_eval_split(
                dataset, cfg.train.eval_fraction, seed=cfg.train.seed,
                multiple_of=cfg.train.batch_size * rt.data_shard_count)
            eval_loader = ShardedDataLoader(
                eval_ds, rt, batch_size=cfg.train.batch_size,
                shuffle=False, seed=cfg.train.seed,
                data_retries=cfg.train.data_retries)
        loader = ShardedDataLoader(
            dataset, rt, batch_size=cfg.train.batch_size,
            shuffle=cfg.train.shuffle, seed=cfg.train.seed,
            drop_last=cfg.train.drop_last,
            max_steps_per_epoch=cfg.train.max_steps_per_epoch,
            data_retries=cfg.train.data_retries,
            fault_injector=fault_injector)
    model_kwargs = dict(cfg.model.kwargs)
    # A model-level dtype wins over the training compute dtype.
    model_dtype = model_kwargs.pop("dtype", cfg.train.dtype)
    model = build_model(cfg.model.name, loss=cfg.train.loss,
                        dtype=model_dtype, device=rt.device, **model_kwargs)

    restart_count = int(os.environ.get(sup.ENV_RESTART_COUNT, "0") or 0)
    with Checkpointer(cfg.train.snapshot_path, runtime=rt,
                      fault_injector=fault_injector) as checkpointer:
        resumed = checkpointer.latest_step() is not None
        appending = resumed or restart_count > 0
        # The restored stream, read before the Telemetry below opens it:
        # the anomaly detector's baselines are replayed from it.
        detect = cfg.train.anomaly_detect and rt.is_coordinator
        restored_events = (load_jsonl(cfg.train.events_jsonl)
                           if detect and appending else [])
        # Truncate only on a first incarnation: a supervised restart
        # that found no checkpoint still appends to the crashed one's
        # events.
        tel = events.install(events.Telemetry(
            events_jsonl=cfg.train.events_jsonl, fresh=not appending,
            start_step=checkpointer.latest_step() or 0,
            host_id=rt.process_index if per_host else None))
        watchdog = metrics_server = None
        profile_capture = ProfileCapture(
            run_dir, at_steps=cfg.train.profile_at,
            n_steps=cfg.train.profile_steps, enabled=rt.is_coordinator)
        incidents = None
        try:
            # One barrier-anchored instant per process: the aggregator
            # puts the per-host clocks on one axis from it.
            tel.event("clock_sync", **rt.clock_sync_record())
            tel.event("runtime", backend=rt.backend,
                      world=rt.process_count, rank=rt.process_index,
                      mesh=rt.spec.as_dict(), device=str(rt.device),
                      device_kind=rt.device_kind,
                      strategy=cfg.train.parallel_strategy)
            if detect:
                # Host-side observers of the stream: no device sync.
                detector = AnomalyDetector(
                    telemetry=tel, run_dir=run_dir,
                    window=cfg.train.anomaly_window,
                    min_samples=cfg.train.anomaly_min_samples,
                    threshold=cfg.train.anomaly_threshold,
                    sustain=cfg.train.anomaly_sustain,
                    autoprofile=cfg.train.anomaly_autoprofile,
                    host=rt.process_index)
                if restored_events:
                    n = detector.replay(restored_events)
                    logger.info("anomaly baselines rebuilt from %d "
                                "restored event(s)", n)
                incidents = IncidentRecorder(
                    run_dir, telemetry=tel, detector=detector,
                    cooldown_s=cfg.train.incident_cooldown_s)
                tel.add_observer(detector.observe)
                tel.add_observer(incidents.observe)
            if cfg.train.watchdog_timeout_s > 0:
                watchdog = HangWatchdog(
                    cfg.train.watchdog_timeout_s,
                    os.path.join(host_dir, "postmortem"), telemetry=tel,
                    abort=cfg.train.watchdog_abort)
            if cfg.train.metrics_port > 0 and rt.is_coordinator:
                metrics_server = _start_metrics_server(
                    cfg, tel, loader, rt, restart_count, run_dir)
            trainer = Trainer(cfg, rt, model, loader, checkpointer,
                              preemption_guard=guard,
                              eval_loader=eval_loader,
                              fault_injector=fault_injector,
                              watchdog=watchdog,
                              profile_capture=profile_capture)
            if (trainer.epochs_run > 0 or trainer.global_step > 0
                    or restart_count > 0):
                tel.event("resume", step=trainer.global_step,
                          epoch=trainer.epochs_run,
                          restarts=restart_count,
                          world_size=rt.process_count,
                          evicted_hosts=evicted_hosts,
                          **_cursor_info(loader),
                          **({"restore": checkpointer.last_restore}
                             if checkpointer.last_restore else {}))
            if cfg.train.profile_dir:
                with profiler.trace(cfg.train.profile_dir,
                                    host_only_on_coordinator=True,
                                    process_index=rt.process_index):
                    summary = trainer.train()
            else:
                summary = trainer.train()
        finally:
            try:
                if incidents is not None and guard.should_stop:
                    # What the run looked like when the stop came.
                    incidents.record(
                        "preemption",
                        reason="preemption/stop signal observed; "
                               "stopping at a checkpoint boundary")
                if watchdog is not None:
                    watchdog.stop()
                if metrics_server is not None:
                    metrics_server.stop()
                profile_capture.abort()  # the run ended mid-capture
                # Drain a save in flight while the stream is open: its
                # manifest may fire the injector's checkpoint hook.
                checkpointer.wait()
            finally:
                # This process's kernel launches, on every exit (a
                # crashed incarnation's count as the finished one's).
                tel.event("kernel_launches", **kernel_launches())
                events.uninstall()
                tel.close()
    if rt.is_coordinator:
        logger.info("training done: %s%s", summary,
                    " (stopped by preemption)" if guard.should_stop else "")
    # The supervisor's exit sentinel: a preempted run exits 0 after its
    # final save as a completed one does, and so does a coordinated
    # eviction, whose host_lost sentinel names the evictee; only this
    # record tells them apart. A no-op when unsupervised.
    evict = trainer.straggler.evict_request
    if evict is not None:
        sup.write_exit_status(
            sup.HOST_LOST, step=trainer.global_step,
            epochs_run=trainer.epochs_run, lost_host=evict["host"],
            reason=evict.get("reason"))
    else:
        sup.write_exit_status(
            sup.PREEMPTED if guard.should_stop else sup.COMPLETED,
            step=trainer.global_step, epochs_run=trainer.epochs_run)
    return 0


def _start_metrics_server(cfg, tel, loader, rt, restart_count: int,
                          run_dir: str):
    """The live Prometheus endpoint on ``train.metrics_port``, fed from
    the run's sink; its bound port goes to ``<run_dir>/metrics.port``."""
    ds = getattr(loader, "dataset", None)
    tokens_per_sample = (getattr(ds, "seq_len", None)
                         or cfg.train.pack_seq_len or 1)
    server = MetricsServer(
        cfg.train.metrics_port, telemetry=tel,
        tokens_per_step=loader.global_batch * tokens_per_sample,
        stall_timeout_s=cfg.train.watchdog_timeout_s,
        info={"world_size": rt.process_count,
              "incarnation": restart_count}).start()
    if server is not None:
        with open(os.path.join(run_dir, "metrics.port"), "w",
                  encoding="utf-8") as f:
            f.write(f"{server.port}\n")
    return server


def _cursor_info(loader) -> dict:
    """The restored data position for the resume event: samples
    consumed, the global batch, corrupt samples skipped, and (once
    something was consumed) the realized and target mixtures."""
    data_state = loader.state_dict()
    out = {"samples_consumed": data_state.get("samples_consumed"),
           "global_batch": loader.global_batch,
           "data_skips": data_state.get("skipped", 0)}
    if data_state.get("samples_consumed"):
        for k in ("realized_mixture", "target_mixture"):
            if data_state.get(k):
                out[k] = data_state[k]
    return out


if __name__ == "__main__":
    sys.exit(main())
