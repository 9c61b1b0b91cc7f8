"""Config layer: YAML composition + dotted CLI overrides → typed dataclasses.

The port's own copy of ``distributed_training_tpu/config.py`` (pure
Python plus yaml; importing the JAX one would import jax through its
package root). It reads the same ``conf/`` tree with the same schema, so
a resolved config is the same dict in both packages; the fields that
name TPU- or XLA-only features are kept for that reason, and the port's
trainer refuses the ones it does not run yet.

Grammar:
- ``group=name``      swap a defaults-group file (e.g. ``model=gpt2_125m``)
- ``a.b.c=value``     set a leaf (value parsed with yaml.safe_load)
- ``+a.b.c=value``    add a new leaf that need not already exist
"""

from __future__ import annotations

import copy
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any

import yaml


class ConfigError(ValueError):
    """Raised for malformed config files or overrides."""


# ---------------------------------------------------------------------------
# Typed config schema
# ---------------------------------------------------------------------------


@dataclass
class TrainConfig:
    """Training knobs; field-for-field superset of the reference's
    ``TrainingConfig`` (reference: src/distributed_trainer.py:29-39,
    conf/train/default.yaml)."""

    batch_size: int = 32          # per-process batch size, as in the reference
    # Elastic runs: a WORLD-SIZE-INVARIANT global batch. When > 0 the
    # CLI derives the per-shard batch_size as global_batch_size /
    # data_shard_count at startup, so a run that shrinks from 4 hosts
    # to 3 keeps the same optimization trajectory (pick a value
    # divisible by every world size the run can shrink to, e.g. 12
    # for 4-or-3). 0 keeps the legacy per-shard batch_size semantics.
    global_batch_size: int = 0
    total_epochs: int = 10
    save_every: int = 2           # epochs between checkpoints
    snapshot_path: str = "checkpoints"  # absolute-anchored at load (fixes B2)
    # Also export a gathered single-file artifact at every save point
    # (the reference FSDP FULL_STATE_DICT analogue; consolidate.py).
    gather_on_save: bool = False
    # Keep optimizer moments resident in pinned host memory BETWEEN
    # steps (streamed to device around each compiled step) — the
    # analogue of the reference FSDP's CPU offload (fsdp_strategy.py:
    # 23-25). Note: step-peak HBM is unchanged (the moments visit the
    # device for the update); this frees between-step residency, at
    # the cost of two opt-state transfers per step.
    offload_opt_state: bool = False
    # FSDP compute contract: constrain weights replicated at their
    # cast-to-compute sites so XLA all-gathers each weight for its
    # matmuls (layer-by-layer inside the scan, bf16, transient)
    # instead of all-reducing partial-product ACTIVATIONS — measured
    # via benchmarks/audit_collectives.py, the partitioner otherwise
    # chooses activation-shaped collectives that dwarf FSDP's param
    # traffic. Applies only when parallel_strategy == "fsdp" and the
    # model supports the binding.
    fsdp_gather_for_compute: bool = True
    # Durable metrics stream: coordinator appends every recorded entry
    # (loss, samples/sec/chip, mfu, val_loss) as one JSON line. Empty →
    # disabled; the CLI defaults it to <run_dir>/metrics.jsonl.
    metrics_jsonl: str = ""
    # Structured telemetry stream (spans, goodput windows, hbm samples
    # — see docs/observability.md). Empty → disabled; the CLI defaults
    # it to <run_dir>/events.jsonl, or host_<i>/events.jsonl on each
    # process of a world of several.
    events_jsonl: str = ""
    # Hang watchdog (telemetry/watchdog.py): a step armed longer than
    # this (from before its batch is fetched) dumps a postmortem bundle
    # (all-thread stacks, torch.cuda.memory_stats, last events) to
    # <run_dir>/postmortem/ (host_<i>/postmortem/ per process in a
    # world of several). 0 disables. Set it to a generous
    # multiple of the expected step time — compile is excluded (the
    # first step arms with a 10x allowance).
    watchdog_timeout_s: float = 0.0
    # After the postmortem: hard-exit (rc 42)? Default off — an
    # attended run may recover; unattended launchers want the abort so
    # a hung process doesn't hold the accelerator forever.
    watchdog_abort: bool = False
    # Steps between hbm telemetry samples (telemetry/hbm.py: the card's
    # torch.cuda.memory_stats beside the state's exact bytes, into the
    # event stream). 0 disables.
    hbm_sample_every: int = 0
    # Cross-host straggler detector (telemetry/straggler.py): every N
    # optimizer steps all processes exchange their window step/data_wait
    # means over one all_gather of a small f32 tensor and flag processes
    # persistently above threshold x the cross-host median. Off the
    # critical path (one small f32 vector per window); auto-disabled
    # when process_count == 1. 0 disables the exchange entirely.
    straggler_every: int = 100
    straggler_threshold: float = 1.5
    # Consecutive flagged windows before a verdict (one slow window is
    # noise — host GC, a checkpoint drain; a persistent 2x is a
    # failing host).
    straggler_persist: int = 2
    # Consecutive flagged windows before the detector requests a
    # COORDINATED EVICTION of the worst host: every host (same
    # all-gathered table, same step) breaks its loop, saves, and exits
    # with a host_lost sentinel the elastic supervisor consumes —
    # never an in-band kill. 0 disables (verdicts stay advisory).
    # Meaningful under launch.local --supervise --elastic.
    straggler_evict_after: int = 0
    # One-shot audit of the first step's collective traffic
    # (telemetry/collectives.py): the coordinator records every
    # collective the step function launches (kind, bytes, mesh axes)
    # and emits a `collectives` event (op counts + bytes/step per mesh
    # axis) so the summarizer can print a comms roofline next to MFU.
    # Reads tensor metadata only (no host sync, no collective); only
    # runs when an event sink is installed.
    collectives_audit: bool = True
    dataset_size: int = 2048
    learning_rate: float = 1e-3
    device: str = "auto"          # "auto" | "tpu" | "cpu"
    # "ddp" | "fsdp" (reference parity) + framework extensions:
    # "zero1" (DDP compute, moments sharded over data axes),
    # "hybrid" (FSDP in-slice, replicate across dp), "tp".
    parallel_strategy: str = "ddp"
    # Resolved auto-parallelism plan (parallel/planner.py): a
    # committed plan name (conf/plans/<name>.json) or a path. When
    # set, the trainer compiles against the plan's sharding-map-by-
    # name (PlannedStrategy) instead of parallel_strategy's ad-hoc
    # specs, and the CLI derives cfg.mesh from the plan (dp as the
    # elastic wildcard). Empty → legacy per-strategy specs.
    sharding_plan: str = ""
    # Comms/compute overlap scheduling (parallel/overlap.py): when a
    # plan is pinned, derive the XLA latency-hiding-scheduler (and
    # collective-combiner) flags from it and append them to XLA_FLAGS
    # before the backend initializes — the SimpleFSDP discipline of
    # hiding FSDP's all-gather/reduce-scatter under compute via the
    # COMPILER's schedule. The static overlap ratchet
    # (analysis/OVERLAP_baseline.json) scores the same flags; flags
    # already present in XLA_FLAGS are never overridden. False
    # reproduces the unscheduled (pre-r07) behavior.
    xla_overlap_flags: bool = True
    seed: int = 42
    optimizer: str = "sgd"        # "sgd" | "adamw" | "adafactor"
    weight_decay: float = 0.0
    # AdamW decay scope: "all" = every param (torch.optim.AdamW's
    # default, the parity baseline); "matrices" = only >=2-D params
    # (the transformer convention — biases/LayerNorm excluded).
    decay_mask: str = "all"
    b1: float = 0.9
    b2: float = 0.95
    grad_clip_norm: float = 0.0   # 0 disables
    warmup_steps: int = 0
    lr_schedule: str = "constant"  # "constant" | "cosine"
    total_steps: int = 0          # 0 → derived from epochs * steps/epoch
    log_every: int = 10           # steps between metric lines
    dtype: str = "float32"        # compute dtype: "float32" | "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False           # gradient checkpointing for big models
    # Microbatches accumulated per optimizer step (1 = off). The global
    # batch must split evenly: batch_size % grad_accum_steps == 0 per
    # shard. Peak activation memory scales with batch/grad_accum_steps.
    grad_accum_steps: int = 1
    loss: str = "auto"            # "auto" | "mse" | "xent" | "prob_xent"
    dataset: str = "synthetic"    # data source name
    dataset_kwargs: dict[str, Any] = field(default_factory=dict)
    # Multi-source exactly-once streaming pipeline (data/stream.py).
    # Non-empty switches the train loader to StreamingDataLoader:
    # ``{name: {dataset: <registry name>, weight: W, **kwargs}}``.
    # The pipeline's whole position (per-source cursors, mixture,
    # packing carry) is serialized into every checkpoint, so restarts
    # and elastic resizes resume mid-epoch exactly-once — pair with
    # train.global_batch_size so the stream is world-size-invariant.
    # Mutually exclusive with eval_fraction (no held-out split yet).
    data_sources: dict[str, Any] = field(default_factory=dict)
    # Sequence packing (streaming pipeline only): concatenate
    # documents across boundaries into fixed blocks of pack_seq_len
    # tokens (+1 for the next-token shift) — no padding, so
    # tokens/step rises to the full block on ragged corpora. 0 = one
    # row per document (sources must then share a row length).
    pack_seq_len: int = 0
    shuffle: bool = True
    drop_last: bool = False
    max_steps_per_epoch: int = 0  # 0 → whole shard (test/bench aid)
    nan_guard: bool = False       # skip+log non-finite update steps
    # Held-out evaluation: eval_fraction of the dataset is split off
    # (deterministically, seed-keyed) and scored every eval_every
    # epochs with dropout off and no state update. 0 disables either.
    eval_fraction: float = 0.0
    eval_every: int = 1           # epochs between evals (if enabled)
    min_shard_elems: int = 4096   # FSDP: replicate arrays smaller than this
    divergence_check_every: int = 0  # steps; 0 disables replica-drift check
    # Steps between cross-host stop-flag polls (multi-host only). Stop
    # latency on SIGTERM is stop_poll_every * step_time — keep that
    # below the preemption grace window (~30s on GCE); use 1 for steps
    # slower than a few seconds.
    stop_poll_every: int = 8
    # Non-empty → the coordinator traces the whole run with
    # torch.profiler (utils/profiler.py) into <profile_dir>/trace.json.
    profile_dir: str = ""
    # In-run profiler capture + step-time attribution (telemetry/
    # attribution.py): comma-separated global steps, e.g. "20" or
    # "20,500". At each step the COORDINATOR captures a torch.profiler
    # trace (CPU and CUDA activities, a Chrome-trace JSON) of
    # profile_steps steps into <run_dir>/profiles/ and immediately
    # emits an `attribution` event (compute / collective / host+data
    # fractions + overlap %, the busiest device ops). One-shot across
    # supervisor restarts. An already-running job is profiled on demand
    # by dropping a file named `profile_now` in the run dir. Empty and
    # no trigger file → off. One profiler runs at a time: while
    # profile_dir's whole-run trace is live the capture declines to
    # start.
    profile_at: str = ""
    profile_steps: int = 2
    # Live metrics endpoint (telemetry/metrics_server.py): when > 0
    # the coordinator serves Prometheus text exposition on this port —
    # GET /metrics (step time, tokens/s, MFU, goodput, data_wait,
    # straggler verdicts, overlap %, world size/incarnation) and GET
    # /healthz (503 once the step loop has stalled past the watchdog
    # threshold). Fed from the same Telemetry sink as events.jsonl —
    # one metrics source of truth. 0 disables.
    metrics_port: int = 0
    # Online anomaly detection + incident flight recorder (telemetry/
    # anomaly.py, telemetry/incident.py). The detector is a pure
    # host-side observer of the event stream (zero new device syncs):
    # rolling median/MAD baselines over step_time / data_wait /
    # throughput / loss / serving signals, `anomaly` events with
    # evidence, a sustained step-time regression arming one in-run
    # profile capture (drops `profile_now`, one-shot across restarts),
    # and incident bundles under <run_dir>/incidents/ on anomaly /
    # watchdog abort / preemption. Coordinator-only. Offline triage:
    # `python -m distributed_training_tpu_torch.telemetry <run_dir> --doctor`.
    anomaly_detect: bool = True
    anomaly_window: int = 64      # rolling baseline window (samples)
    anomaly_min_samples: int = 16  # baseline warmup before verdicts
    anomaly_threshold: float = 8.0  # MADs from median to flag
    anomaly_sustain: int = 5      # consecutive slow steps -> profile
    anomaly_autoprofile: bool = True  # arm profile_now on sustained
    incident_cooldown_s: float = 60.0  # min gap between bundles/kind
    # Deterministic fault injection (resilience/faults.py): e.g.
    # "crash@40,sigterm@80,corrupt_ckpt@120,data_stall@60:500ms".
    # Every trigger is a pure function of the global step (multi-host
    # safe); faults are one-shot across restarts unless marked
    # ":always". Empty disables. Grammar: docs/robustness.md.
    fault_plan: str = ""
    # Transient batch-assembly/IO errors are retried this many times
    # (short exponential backoff, `data_retry` telemetry event) before
    # the step loop is allowed to die. 0 fails on the first blip.
    data_retries: int = 2


@dataclass
class MeshConfig:
    """Logical mesh shape. ``-1`` on exactly one axis means "fill with the
    remaining devices". Axes: dp (pure data parallel, outermost / DCN),
    fsdp (param sharding, ICI), tp (tensor/model), sp (sequence/context),
    ep (expert; folded over fsdp×dp when used), pp (pipeline stages)."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1


@dataclass
class ModelConfig:
    """Model selection + hyperparameters. ``name`` picks the family from the
    registry (models/registry.py); remaining fields are family-specific and
    carried as an open dict so YAML stays the source of truth."""

    name: str = "mlp"
    kwargs: dict[str, Any] = field(default_factory=dict)


@dataclass
class RunConfig:
    """Run environment: output dir, logging."""

    output_dir: str = "outputs"
    log_level: str = "INFO"
    log_file: str = "training.log"
    experiment_name: str = "default"


@dataclass
class Config:
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    run: RunConfig = field(default_factory=RunConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# YAML composition
# ---------------------------------------------------------------------------


def _load_yaml(path: str) -> dict[str, Any]:
    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ConfigError(f"top level of {path} must be a mapping")
    return data


def _deep_merge(base: dict[str, Any], over: dict[str, Any]) -> dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(tree: dict[str, Any], dotted: str, value: Any,
              allow_new: bool) -> None:
    keys = dotted.split(".")
    node = tree
    for k in keys[:-1]:
        if k in node and not isinstance(node[k], dict):
            raise ConfigError(
                f"override path '{dotted}': '{k}' is a value, not a group")
        if k not in node:
            if not allow_new:
                raise ConfigError(
                    f"override path '{dotted}': unknown key '{k}' "
                    f"(use +{dotted}=... to add new keys)")
            node[k] = {}
        node = node[k]
    leaf = keys[-1]
    if not allow_new and leaf not in node:
        raise ConfigError(
            f"override path '{dotted}': unknown key '{leaf}' "
            f"(use +{dotted}=... to add new keys)")
    node[leaf] = value


def compose(config_dir: str, config_name: str = "config",
            overrides: list[str] | None = None,
            base_tree: dict[str, Any] | None = None) -> dict[str, Any]:
    """Compose the raw config dict: base defaults + root YAML + defaults
    groups + overrides.

    Mirrors the reference's Hydra composition of conf/config.yaml's
    ``defaults: [model: default, train: default]`` (conf/config.yaml:1-4)
    without the chdir side effects. ``base_tree`` (the typed schema's
    defaults) is merged underneath so every schema field is a valid
    override target even when the YAML files don't spell it out.
    """
    overrides = list(overrides or [])
    root = _load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = root.pop("defaults", [])

    # group=name overrides replace default group selections before loading
    group_over: dict[str, str] = {}
    leaf_over: list[tuple[str, str, bool]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override '{ov}' must be key=value")
        key, val = ov.split("=", 1)
        allow_new = key.startswith("+")
        key = key.lstrip("+")
        if "." not in key and os.path.isdir(os.path.join(config_dir, key)):
            group_over[key] = val
        else:
            leaf_over.append((key, val, allow_new))

    selections: list[tuple[str, str]] = []
    for entry in defaults:
        if isinstance(entry, str):  # e.g. "_self_"
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ConfigError(f"bad defaults entry: {entry!r}")
        (group, name), = entry.items()
        selections.append((group, group_over.pop(group, name)))
    selections.extend(group_over.items())

    tree: dict[str, Any] = copy.deepcopy(base_tree) if base_tree else {}
    for group, name in selections:
        group_file = os.path.join(config_dir, group, f"{name}.yaml")
        tree = _deep_merge(tree, {group: _load_yaml(group_file)})

    tree = _deep_merge(tree, root)

    for key, val, allow_new in leaf_over:
        _set_path(tree, key, yaml.safe_load(val),
                  allow_new or _is_open_path(key))
    return tree


def _is_open_path(dotted: str) -> bool:
    """Open-schema override targets need no ``+``: the ``model`` group
    (hyperparameters are family-specific, carried via ModelConfig.kwargs),
    any ``*_kwargs`` mapping (e.g. train.dataset_kwargs), and the
    ``train.data_sources`` mixture tree (source names and their
    dataset kwargs are user-defined)."""
    parts = dotted.split(".")
    if parts[0] == "model" and len(parts) > 1:
        return True
    return any(p.endswith("_kwargs") or p == "data_sources"
               for p in parts[:-1])


# ---------------------------------------------------------------------------
# dict → dataclass
# ---------------------------------------------------------------------------


def _coerce_scalar(ftype: type, v: Any, path: str) -> Any:
    """Coerce YAML scalars into the schema's type. Load-bearing for
    floats: PyYAML's float regex requires a dot, so Hydra-style
    ``train.learning_rate=3e-3`` arrives as the STRING '3e-3' and
    would flow into the optimizer uncoerced."""
    if isinstance(v, bool) or not isinstance(v, (str, int, float)):
        return v
    try:
        if ftype is float and not isinstance(v, float):
            return float(v)
        if ftype is int and isinstance(v, str):
            return int(v)
        if ftype is int and isinstance(v, float):
            if v != int(v):
                raise ValueError(v)  # 2.5 into an int field is junk
            return int(v)
        if ftype is bool and isinstance(v, str):
            lv = v.lower()
            if lv in ("true", "1", "yes"):
                return True
            if lv in ("false", "0", "no"):
                return False
            raise ValueError(v)
    except ValueError as e:
        raise ConfigError(
            f"cannot parse {v!r} as {ftype.__name__} for '{path}'"
        ) from e
    return v


def _build_dataclass(cls: type, data: dict[str, Any], path: str) -> Any:
    import typing
    hints = typing.get_type_hints(cls)  # resolve string annotations
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {}
    extra: dict[str, Any] = {}
    for k, v in data.items():
        if k in fields:
            ftype = hints.get(k, fields[k].type)
            if dataclasses.is_dataclass(ftype) and isinstance(v, dict):
                v = _build_dataclass(ftype, v, f"{path}.{k}")
            elif isinstance(ftype, type):
                v = _coerce_scalar(ftype, v, f"{path}.{k}")
            kwargs[k] = v
        else:
            extra[k] = v
    if extra:
        if "kwargs" in fields:  # open-schema dataclasses (ModelConfig)
            kwargs.setdefault("kwargs", {})
            kwargs["kwargs"] = {**extra, **kwargs["kwargs"]}
        else:
            raise ConfigError(
                f"unknown key(s) {sorted(extra)} under '{path}' for "
                f"{cls.__name__}")
    return cls(**kwargs)


def config_from_dict(tree: dict[str, Any]) -> Config:
    cfg = Config(
        train=_build_dataclass(TrainConfig, tree.get("train", {}), "train"),
        mesh=_build_dataclass(MeshConfig, tree.get("mesh", {}), "mesh"),
        model=_build_dataclass(ModelConfig, tree.get("model", {}), "model"),
        run=_build_dataclass(RunConfig, tree.get("run", {}), "run"),
    )
    return cfg


def load_config(config_dir: str | None = None, config_name: str = "config",
                overrides: list[str] | None = None) -> Config:
    """Load the typed framework config.

    ``config_dir`` defaults to ``<repo_root>/conf`` (parity with the
    reference's ``@hydra.main(config_path="../conf")``,
    src/distributed_trainer.py:243).
    """
    if config_dir is None:
        config_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "conf")
    base = Config().to_dict()
    # ModelConfig's open kwargs dict is presentation-only; model YAMLs
    # write hyperparameters at the top level of the model group.
    base["model"].pop("kwargs", None)
    tree = compose(config_dir, config_name, overrides, base_tree=base)
    cfg = config_from_dict(tree)
    # Anchor snapshot_path against output_dir at load time (not at save
    # time, and with no per-run chdir) so restarts launched the same way
    # find the previous snapshot — the reference's relative "snapshot.pt"
    # + Hydra per-run chdir made resume impossible (SURVEY.md §8 B2).
    # A relative output_dir still depends on the launch cwd; launchers
    # that need cwd-independence should set an absolute run.output_dir.
    if cfg.train.snapshot_path and not os.path.isabs(cfg.train.snapshot_path):
        cfg.train.snapshot_path = os.path.abspath(
            os.path.join(cfg.run.output_dir, cfg.run.experiment_name,
                         cfg.train.snapshot_path))
    return cfg


def save_resolved(cfg: Config, path: str) -> None:
    """Write the resolved config next to run outputs for reproducibility."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f, sort_keys=False)


def override_config(cfg: Config, **groups: dict[str, Any]) -> Config:
    """Return a copy of ``cfg`` with dataclass-level replacements applied
    (programmatic analogue of CLI overrides, used by tests/benches)."""
    cfg = copy.deepcopy(cfg)
    for group, repl in groups.items():
        sub = getattr(cfg, group)
        for k, v in repl.items():
            if not hasattr(sub, k):
                raise ConfigError(f"unknown field {group}.{k}")
            setattr(sub, k, v)
    return cfg
