"""Training traffic: the program's ``Trainer`` stepped on rows of
random token ids drawn from the seed.

The mix (``traffic/<mix>.json``) gives the rows per chip of a step
(``batch_per_chip``), their length (``seq_len``), the ids' range
(``vocab_ids``), the rows the data set holds (``rows``; the window
wraps over them epoch after epoch) and the steps set-up takes
(``checked_steps`` compared with the reference, then ``warm_steps``).

Set-up builds one ``Trainer`` as ``train/cli.py`` builds it, from the
program's own ``conf/`` tree with the cell's overrides, gives it the
weights made from the seed (``weights.py``) and the program's
``ShardedDataLoader`` over the rows, and takes the first steps through
the same call and feed the window uses (``Trainer.train_step`` on the
loader's next batch), reading what the comparison needs on the way.
The window then steps until ``seconds`` have passed, synchronises, and
counts every step it ran: the samples per second are those steps' rows
over the window's seconds. With ``trace`` the first
``tracing.TRACE_S`` seconds run under the profiler.

After the window and the memory reading the program's state is freed
and the reference (``reference/check_train.py``) follows the checked
steps from the same weights and rows.
"""

from __future__ import annotations

import gc
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from portbench import harness, tracing, weights
from portbench.reference import check_train
from portbench.yardstick import flops


class Rows:
    """The data set: rows of ``seq_len + 1`` ids from the seed; the
    indices of each batch asked for are kept in order."""

    def __init__(self, tokens: np.ndarray, vocab: int):
        self.tokens = tokens
        self.seq_len = tokens.shape[1] - 1
        self.vocab_size = vocab
        self.asked: list = []

    def __len__(self) -> int:
        return len(self.tokens)

    def batch(self, indices: np.ndarray) -> dict:
        self.asked.append(np.array(indices))
        return {"tokens": self.tokens[indices]}


def make_rows(traffic: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, traffic["vocab_ids"],
                        size=(traffic["rows"], traffic["seq_len"] + 1),
                        dtype=np.int32)


def overrides(cell, opts: dict) -> list:
    """The program's config: the cell's ``program`` block and the
    configuration's sizes, as the trainer CLI would take them."""
    prog, run, tr = cell.spec["program"], cell.run_cfg, cell.traffic
    opt = cell.spec["optimizer"]
    out = [f"model={prog['model']}", f"train={prog['train']}",
           f"train.parallel_strategy={prog['strategy']}",
           f"train.batch_size={tr['batch_per_chip']}",
           f"train.dataset_kwargs.seq_len={tr['seq_len']}",
           f"train.dtype={prog['dtype']}", "train.shuffle=false",
           f"train.seed={opts['seed'] % (1 << 31)}",
           f"train.device={opts['device']}", "train.save_every=0",
           "train.straggler_every=0", "run.log_level=WARNING",
           f"train.optimizer={opt['kind']}",
           f"train.learning_rate={opt['learning_rate']}",
           f"train.b1={opt['b1']}", f"train.b2={opt['b2']}",
           f"train.weight_decay={opt['weight_decay']}",
           f"train.grad_clip_norm={opt['grad_clip_norm']}",
           f"train.warmup_steps={opt['warmup_steps']}",
           f"train.total_steps={opt['total_steps']}",
           f"train.decay_mask={opt['decay_mask']}",
           f"train.lr_schedule={opt['schedule']}"]
    model = {"vocab_size": run["vocab_rows"], "d_model": run["d_model"],
             "n_layers": run["n_layers"], "n_heads": run["n_heads"],
             "d_ff": run["d_ff"], "max_seq_len": run["max_seq_len"],
             "pos_encoding": run["pos_encoding"],
             "tie_embeddings": run["tie_embeddings"],
             "param_dtype": prog["param_dtype"], **prog["model_kwargs"]}
    if run.get("n_kv_heads"):
        model["n_kv_heads"] = run["n_kv_heads"]
    out += [f"+model.{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in model.items()]
    return out + list(opts.get("extra_overrides", ()))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(cell, opts: dict) -> None:
    """A process group of one where the cell's strategy runs in one
    (fsdp over NCCL on the card, gloo on the CPU)."""
    if not cell.spec["program"].get("process_group"):
        return
    backend = "nccl" if opts["device"] != "cpu" else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1, **kw)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    return {k: float(torch.linalg.vector_norm(t.detach().float())) * scale
            for k, t in tensors.items()}


class _Feed:
    """The loader's batches, epoch after epoch."""

    def __init__(self, loader):
        self.loader, self.epoch = loader, 0
        self.it = iter(loader.epoch(0))

    def next(self):
        batch = next(self.it, None)
        while batch is None:
            self.it.close()
            self.epoch += 1
            self.it = iter(self.loader.epoch(self.epoch))
            batch = next(self.it, None)
        return batch

    def close(self) -> None:
        self.it.close()


def _plant(trainer, fault: str | None):
    """A fault under the timed path (the tests and the fault readings):
    ``unchanged`` (a step that leaves the state as it was),
    ``half_batch`` (half of each batch's rows dropped, the mean taken
    over the rest). Returns an undo."""
    if fault is None:
        return lambda: None
    if fault == "unchanged":
        step = trainer._step_fn

        def unchanged(state, batch):
            shadow = {"params": state["params"], "step": state["step"],
                      "opt_state": state["opt_state"]}
            with torch.no_grad():
                saved = {k: v.detach().clone() for k, v in
                         weights.flat(state["params"]).items()}
            out = step(shadow, batch)
            with torch.no_grad():
                for k, v in weights.flat(state["params"]).items():
                    v.copy_(saved[k])
            return out

        trainer._step_fn = unchanged
        return lambda: setattr(trainer, "_step_fn", step)
    if fault == "half_batch":
        step = trainer._step_fn

        def half(state, batch):
            return step(state, {k: v[: v.shape[0] // 2]
                                for k, v in batch.items()})

        trainer._step_fn = half
        return lambda: setattr(trainer, "_step_fn", step)
    raise ValueError(f"unknown fault '{fault}'")


def setup(cell, opts: dict) -> dict:
    """Everything before the window: the trainer, its first steps and
    the readings the comparison needs."""
    from distributed_training_tpu_torch.config import load_config
    from distributed_training_tpu_torch.data import ShardedDataLoader
    from distributed_training_tpu_torch.models.registry import build_model
    from distributed_training_tpu_torch.runtime import initialize_runtime
    from distributed_training_tpu_torch.train.trainer import Trainer

    tr, prog = cell.traffic, cell.spec["program"]
    _start_group(cell, opts)
    cfg = load_config(overrides=overrides(cell, opts))
    rt = initialize_runtime(cfg)
    kwargs = dict(cfg.model.kwargs)
    dtype = kwargs.pop("dtype", cfg.train.dtype)
    model = build_model(cfg.model.name, loss=cfg.train.loss, dtype=dtype,
                        device=rt.device, **kwargs)
    rows = Rows(make_rows(tr, opts["seed"]), tr["vocab_ids"])
    loader = ShardedDataLoader(rows, rt, batch_size=tr["batch_per_chip"],
                               shuffle=False, seed=0)
    start = weights.make(cell.run_cfg, opts["seed"], rt.device,
                         getattr(torch, prog["param_dtype"]))
    trainer = Trainer(cfg, rt, model, loader, params=start)
    del start
    rows.asked.clear()  # the trainer's look at row 0 is not a step
    undo = _plant(trainer, opts.get("fault"))
    before = {k: v.detach().to("cpu", copy=True) for k, v in
              weights.flat(trainer.state["params"]).items()}
    feed = _Feed(loader)
    losses, first = [], None
    b1 = cell.spec["optimizer"]["b1"]
    for _ in range(tr["checked_steps"]):
        m = trainer.train_step(feed.next())
        losses.append(m["loss"])
        if first is None:
            first = _leaf_norms(trainer.state["opt_state"]["mu"],
                                1.0 / (1.0 - b1))
    change = {k: float(torch.linalg.vector_norm(
        v.detach().float() - before[k].to(v.device).float()))
        for k, v in weights.flat(trainer.state["params"]).items()}
    del before
    prog_read = {"losses": [float(x) for x in losses], "grad": first,
                 "change": change}
    for _ in range(tr["warm_steps"]):
        trainer.train_step(feed.next())
    _sync(rt.device)
    asked = rows.asked[: tr["checked_steps"]]
    return {"rt": rt, "trainer": trainer, "feed": feed, "prog": prog_read,
            "asked": asked, "rows": rows, "undo": undo}


def window(trainer, feed, device, seconds: float, trace: bool) -> dict:
    """Step until ``seconds`` have passed; host times of each call."""
    capture = tracing.Capture(device) if trace else None
    waits, steps_s = [], []
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if capture:
        capture.start()
    n = 0
    while True:
        on = capture is not None and capture.on
        a = time.perf_counter()
        with tracing.span("data_wait", on):
            batch = feed.next()
        b = time.perf_counter()
        with tracing.span("train_step", on):
            trainer.train_step(batch)
        c = time.perf_counter()
        waits.append(b - a)
        steps_s.append(c - b)
        n += 1
        if on and c - t0 >= min(tracing.TRACE_S, seconds):
            _sync(device)
            capture.stop()
            after = (n, time.perf_counter())
        if c - t0 >= seconds:
            break
    _sync(device)
    t1 = time.perf_counter()
    if capture is not None and capture.on:
        capture.stop()
        after = (n, t1)
    out = {"steps": n, "window_s": t1 - t0, "data_wait_s": waits,
           "host_step_s": steps_s}
    if capture is not None:
        # The untraced rest of the window: its steps and seconds.
        out["after"] = {"steps": n - after[0], "seconds": t1 - after[1]}
        out["traced"] = capture.read("train_step")
    if device.type == "cuda":
        out["window_peak"] = torch.cuda.max_memory_allocated(device)
    return out


def free(s: dict) -> None:
    """Drop the program's state (the trainer and its loader)."""
    s["feed"].close()
    s["undo"]()
    s.pop("trainer", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(cell, opts: dict, prog: dict, steps: list, device) -> dict:
    """The numbers compared: the program's readings against the
    reference's over the checked steps' global rows."""
    ref = check_train.train_reference(
        cell.run_cfg, cell.spec["optimizer"], opts["seed"], steps, device,
        cell.spec["reference"]["rows_per_block"])
    return check_train.compare(prog, ref)


def run(cell, opts: dict) -> dict:
    t_start = opts["t_start"]
    if opts["device"] != "cpu":
        torch.cuda.set_device(0)
    if opts["trace"]:
        tracing.warm(torch.device(opts["device"], 0)
                     if opts["device"] != "cpu" else torch.device("cpu"))
    s = setup(cell, opts)
    device = s["rt"].device
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    setup_s = time.perf_counter() - t_start
    w = window(s["trainer"], s["feed"], device, opts["seconds"],
               opts["trace"])
    peak = max(setup_peak, w.get("window_peak", 0))
    steps = [s["rows"].tokens[i] for i in s["asked"]]
    free(s)
    cfg, tr = cell.run_cfg, cell.traffic
    ok, checks = harness.judge(check(cell, opts, s["prog"], steps, device),
                               cell.spec["limits"])
    samples = w["steps"] * tr["batch_per_chip"]
    res = {"e2e": {"train_samples_per_s": samples / w["window_s"],
                   "setup_s": setup_s},
           "correct": ok, "attempted": w["steps"], "failed": 0,
           "checks": checks, "device": _device(device, peak)}
    if opts["trace"]:
        traced = w["traced"]
        att = traced["attribution"]
        res["device"].update(busy_s=att["busy_s"], window_s=att["window_s"])
        res["breakdown"] = tracing.breakdown(traced)
        res["ctx"] = {
            "cfg": cfg, "traffic": tr, "chips": 1,
            "host": {"data_wait_s": w["data_wait_s"],
                     "host_step_s": w["host_step_s"]},
            "traced": traced, "after": w["after"],
            "batch_per_chip": tr["batch_per_chip"],
            "window_peak": w.get("window_peak"),
            "flops_per_sample": flops.train_flops_per_sample(
                cfg, tr["seq_len"])}
    if dist.is_initialized():
        dist.destroy_process_group()
    return res


def readings(cell, opts: dict) -> dict:
    """One seed's numbers without a window (the limits' readings): the
    program's set-up steps, freed, then the reference."""
    if opts["device"] != "cpu":
        torch.cuda.set_device(0)
    s = setup(cell, opts)
    device = s["rt"].device
    steps = [s["rows"].tokens[i] for i in s["asked"]]
    free(s)
    out = check(cell, opts, s["prog"], steps, device)
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


def control(cell, opts: dict, half: bool = False) -> dict:
    """The reference in the program's place, in fp8 (``half``: instead
    at its own precision with each step's loss over half of its rows),
    against the reference: the control's numbers of one seed."""
    device = torch.device(opts["device"])
    tr, B = cell.traffic, cell.traffic["batch_per_chip"]
    tokens = make_rows(tr, opts["seed"])
    # The loader takes the rows in order, B of them a step.
    steps = [tokens[i * B:(i + 1) * B] for i in range(tr["checked_steps"])]
    args = (cell.run_cfg, cell.spec["optimizer"], opts["seed"], steps,
            device, cell.spec["reference"]["rows_per_block"])
    ref = check_train.train_reference(*args)
    other = check_train.train_reference(*args, low=not half, half=half)
    return check_train.compare(other, ref)


def _device(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
