"""Generation CLI: sample from a trained checkpoint (port of
``generate.py``).

    # Byte-level models (vocab 256): the prompt is literal UTF-8.
    python -m distributed_training_tpu_torch.generate \\
        --run-dir outputs/default --prompt "def main(" \\
        --max-new-tokens 128 --temperature 0.8 --top-k 40

    # Token models: ids in, ids out.
    python -m distributed_training_tpu_torch.generate \\
        --run-dir outputs/gpt2 --prompt-ids 50256,318 -n 32

The model is rebuilt from the run's ``resolved_config.yaml`` and the
params come from the newest (or ``--step``) checkpoint under the run's
checkpoint directory, whatever mesh wrote it
(``checkpoint/export.py::restore_step_local``), or from a consolidated
artifact (``--artifact``). ``--decode paged`` (the default, greedy) runs
a one-slot serving ``Engine`` over the paged KV cache, its decode on the
paged-decode kernel; ``--decode fused``, every sampled run and a MoE
model (the serving engine has no MoE decode, in either package) take
the model's dense-cache ``generate``, its prompt through the model's
attention (the flash forward on the card). Sampling draws from a
``torch.Generator`` seeded by ``--seed``: the JAX package's
``jax.random`` stream is not reproduced, so only greedy tokens agree
with it.

It runs on the CUDA card unless ``--device cpu`` is given. The output is
the text (byte models) or the ids on stdout and a ``# step=...`` line on
stderr; ``--json`` prints one JSON line instead, with the tokens, the
decode time and the kernels' launches in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from distributed_training_tpu_torch.runtime import resolve_device


def _load_run_config(run_dir: str):
    import yaml

    from distributed_training_tpu_torch.config import config_from_dict

    path = os.path.join(run_dir, "resolved_config.yaml")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: point --run-dir at a training run "
            "directory (<run.output_dir>/<run.experiment_name>)")
    with open(path) as f:
        return config_from_dict(yaml.safe_load(f))


def _build_model_from_cfg(cfg, device):
    """The trained architecture from a run's resolved config (shared by
    the generate and eval CLIs: a model-level dtype wins over the
    training compute dtype)."""
    from distributed_training_tpu_torch.models.registry import build_model

    model_kwargs = dict(cfg.model.kwargs)
    model_dtype = model_kwargs.pop("dtype", cfg.train.dtype)
    return build_model(cfg.model.name, loss=cfg.train.loss,
                       dtype=model_dtype, device=device, **model_kwargs)


def _restore_params(run_dir: str, snapshot_path: str, step: int | None,
                    device) -> tuple:
    """The newest (or given) step's whole params on ``device``. When the
    run's ``snapshot_path`` is gone (a copied run directory), the
    checkpoint directory inside ``run_dir`` is read instead."""
    from distributed_training_tpu_torch.checkpoint.export import (
        restore_step_local,
    )

    ckpt_dir = snapshot_path
    if not os.path.isdir(ckpt_dir):
        local = os.path.join(run_dir, os.path.basename(
            snapshot_path.rstrip(os.sep)) or "checkpoints")
        if not os.path.isdir(local):
            raise FileNotFoundError(
                f"no checkpoint dir at {snapshot_path} (from the run's "
                f"resolved config) nor at {local}")
        ckpt_dir = local
    state, step = restore_step_local(ckpt_dir, step)
    return _to_device(state["params"], device), step


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dtt-torch-generate",
        description="Sample from a trained checkpoint (the PyTorch port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-dir",
                     help="training run dir (holds resolved_config.yaml "
                          "and checkpoints)")
    src.add_argument("--artifact",
                     help="consolidated single-file export "
                          "(checkpoint/export.py); its meta names the "
                          "architecture, --model-name/--model-kwargs "
                          "override or fill in")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: newest)")
    prompt = p.add_mutually_exclusive_group(required=True)
    prompt.add_argument("--prompt",
                        help="UTF-8 text prompt (byte-vocab models)")
    prompt.add_argument("--prompt-ids", help="comma-separated token ids")
    p.add_argument("-n", "--max-new-tokens", type=int, default=64)
    p.add_argument("--decode", choices=("paged", "fused"), default="paged",
                   help="greedy decode path: 'paged' (default) runs the "
                        "serving engine's paged KV-cache decode, 'fused' "
                        "the model's dense-cache generate loop; sampling "
                        "(temperature > 0) always takes 'fused'")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-name", default=None)
    p.add_argument("--model-kwargs", default="{}",
                   help="JSON dict (with --artifact)")
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the CUDA card)")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line (tokens, timing, kernel "
                        "launches) instead of the text")
    return p


def _paged_engine(model, params, total: int, device):
    """A one-slot serving engine over pages of 16 for ``total`` tokens
    (prompt and new), or None when they do not fit the model's window
    floored to whole pages."""
    from distributed_training_tpu_torch.serving.engine import (
        Engine,
        EngineConfig,
    )

    page = 16
    model_cap = model.cfg.max_seq_len // page * page
    max_len = min(-(-total // page) * page, model_cap)
    if total > max_len:
        return None
    return Engine(model, params, EngineConfig(
        max_batch=1, page_size=page, num_pages=-(-max_len // page) + 1,
        max_seq_len=max_len, prefill_chunk=min(64, max_len)),
        device=device)


def _paged_generate(model, params, ids: np.ndarray, n: int, device):
    """Greedy tokens through a one-slot serving engine, or None when the
    request does not fit (``_paged_engine``)."""
    eng = _paged_engine(model, params, int(ids.size) + n, device)
    if eng is None:
        return None
    return np.asarray(eng.generate(ids, n), np.int32)


def main(argv: list[str] | None = None) -> int:
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)

    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.ops import kernel_launches

    if args.run_dir:
        cfg = _load_run_config(args.run_dir)
        model = _build_model_from_cfg(cfg, device)
        params, step = _restore_params(args.run_dir,
                                       cfg.train.snapshot_path, args.step,
                                       device)
    else:
        if args.step is not None:
            raise ValueError(
                "--step selects a step inside a run dir; a consolidated "
                "artifact holds exactly one step (re-export with "
                "checkpoint/export.py --step N)")
        from distributed_training_tpu_torch.checkpoint.consolidate import (
            load_consolidated,
        )
        state, meta = load_consolidated(args.artifact)
        name = args.model_name or meta.get("model_name")
        if not name:
            raise ValueError(
                "--artifact carries no architecture meta: pass "
                "--model-name and --model-kwargs")
        kwargs = dict(meta.get("model_kwargs") or {})
        kwargs.setdefault("dtype", meta.get("model_dtype", "float32"))
        kwargs.setdefault("loss", meta.get("loss", "auto"))
        kwargs.update(json.loads(args.model_kwargs))
        model = build_model(name, device=device, **kwargs)
        params = _to_device(state["params"], device)
        step = meta.get("step", -1)

    if not hasattr(model, "generate"):
        raise ValueError(
            f"model family '{type(model).__name__}' has no autoregressive "
            "decode path: generation needs a transformer-family "
            "checkpoint")
    vocab = model.cfg.vocab_size
    if args.prompt is not None:
        if vocab != 256:
            raise ValueError(
                f"--prompt is UTF-8 bytes, which needs a byte-vocab (256) "
                f"model; this one has vocab {vocab}: pass --prompt-ids")
        ids = np.frombuffer(args.prompt.encode("utf-8"),
                            dtype=np.uint8).astype(np.int32)
    else:
        ids = np.asarray([int(t) for t in args.prompt_ids.split(",")],
                         np.int32)
        if ids.size and (ids.min() < 0 or ids.max() >= vocab):
            raise ValueError(f"prompt ids must be in [0, {vocab}), got "
                             f"[{ids.min()}, {ids.max()}]")
    if ids.size == 0:
        raise ValueError("empty prompt")

    t0 = time.perf_counter()
    out_ids, decode = None, "fused"
    if (args.decode == "paged" and args.temperature <= 0
            and getattr(model.cfg, "moe_num_experts", 0) == 0):
        out_ids = _paged_generate(model, params, ids, args.max_new_tokens,
                                  device)
        decode = "paged" if out_ids is not None else "fused"
    if out_ids is None:
        out = model.generate(params, ids[None, :],
                             max_new_tokens=args.max_new_tokens,
                             temperature=args.temperature,
                             top_k=args.top_k, rng=args.seed)
        out_ids = out[0].cpu().numpy()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if args.json:
        print(json.dumps({"step": step, "decode": decode,
                          "prompt_tokens": int(ids.size),
                          "tokens": [int(t) for t in out_ids],
                          "seconds": seconds,
                          "tokens_per_s": out_ids.size / seconds,
                          "kernel_launches": kernel_launches()}))
        return 0
    print(f"# step={step} prompt_tokens={ids.size} sampled={out_ids.size} "
          f"decode={decode}", file=sys.stderr)
    if vocab == 256:
        print(bytes(out_ids.astype(np.uint8)).decode("utf-8",
                                                     errors="replace"))
    else:
        print(",".join(str(int(t)) for t in out_ids))
    return 0


if __name__ == "__main__":
    sys.exit(main())
