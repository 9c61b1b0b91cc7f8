"""CLI: consolidate a checkpoint into one file (port of
``checkpoint/export.py``).

Offline counterpart of ``train.gather_on_save``: point it at a
checkpoint directory the trainer wrote and get the single portable
artifact (``checkpoint/consolidate.py`` format) without a process group
or the model. One process: it loads every process's shard file and
joins them by the layout manifest on the host, so it is meant for a
machine with enough memory for the whole state.

    python -m distributed_training_tpu_torch.checkpoint.export \\
        --ckpt outputs/default/checkpoints --out model.pt

``--quantize int8`` writes the params in the int8 weight-only layout
(``serving/disagg.py::quantize_params_int8``) and stamps
``meta["quantization"] = "int8"``; such an artifact's params go straight
into an ``Engine``. ``meta["sharding_plan"]`` stamps the plan the run
trained under, ``{"name", "fingerprint"}`` (``--plan``, or the run's
``train.sharding_plan`` read from its ``resolved_config.yaml``), which
``serving/disagg.py::WeightStore`` checks against the committed plan.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributed_training_tpu_torch.checkpoint.consolidate import (
    whole_state_of,
)


def restore_step_local(ckpt_dir: str, step: int | None = None
                       ) -> tuple[dict, int]:
    """One checkpoint step's whole state on the host, whatever mesh
    wrote it. Returns (state, step); ``step=None`` → newest."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if step is None:
        steps = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint steps found under {ckpt_dir}")
        step = steps[-1]
    step_dir = os.path.join(ckpt_dir, str(step))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(
            f"checkpoint step {step} not found in {ckpt_dir}")
    return whole_state_of(step_dir), step


def _plan_provenance(ckpt_dir: str, plan: str | None) -> dict | None:
    """The ``sharding_plan`` stamp of the artifact's meta: the source
    run's plan name and fingerprint. ``plan``: None → the run's
    ``train.sharding_plan`` from ``resolved_config.yaml`` in the
    directory above ``ckpt_dir`` (no file or no plan → no stamp);
    "none" → no stamp; anything else → that plan's name or path."""
    import yaml

    name = plan
    if name is None:
        cfg_path = os.path.join(os.path.dirname(ckpt_dir),
                                "resolved_config.yaml")
        if not os.path.exists(cfg_path):
            return None
        with open(cfg_path) as f:
            resolved = yaml.safe_load(f) or {}
        name = (resolved.get("train") or {}).get("sharding_plan") or ""
        if not name:
            return None
    if name == "none":
        return None
    from distributed_training_tpu_torch.parallel.planner import load_plan

    p = load_plan(name)
    return {"name": p.name, "fingerprint": p.fingerprint()}


# A runtime publish (``Engine.swap_weights``'s provenance gate) stamps
# what the export CLI stamps, from the same code.
plan_provenance = _plan_provenance


def export(ckpt_dir: str, out_path: str, step: int | None = None,
           plan: str | None = None, quantize: str | None = None) -> dict:
    if quantize not in (None, "int8"):
        raise ValueError(
            f"unsupported --quantize '{quantize}' (supported: int8)")
    ckpt_dir = os.path.abspath(ckpt_dir)
    from distributed_training_tpu_torch.checkpoint.consolidate import (
        write_artifact,
    )

    state, step = restore_step_local(ckpt_dir, step)
    meta: dict = {}
    meta_file = os.path.join(ckpt_dir, str(step), "meta.json")
    if os.path.exists(meta_file):
        with open(meta_file) as f:
            meta = json.load(f) or {}
    meta.setdefault("step", int(step))
    prov = _plan_provenance(ckpt_dir, plan)
    if prov is not None:
        meta["sharding_plan"] = prov
    if quantize == "int8":
        from distributed_training_tpu_torch.serving.disagg import (
            quantize_params_int8,
        )

        state = dict(state)
        state["params"] = quantize_params_int8(state["params"])
        meta["quantization"] = "int8"
    n = write_artifact(out_path, state, meta)
    return {"out": out_path, "step": int(step), "bytes": n,
            "quantization": quantize or "none"}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory (train.snapshot_path)")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--plan", default=None,
                   help="sharding-plan provenance to stamp into the "
                        "artifact's meta (default: the run's "
                        "train.sharding_plan; 'none' to skip)")
    p.add_argument("--quantize", default=None, choices=("int8",),
                   help="weight-only quantization of the exported params "
                        "(per-channel int8, stamped into the artifact's "
                        "meta)")
    args = p.parse_args(argv)
    print(json.dumps(export(args.ckpt, args.out, args.step,
                            plan=args.plan, quantize=args.quantize)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
