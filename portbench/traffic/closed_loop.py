"""Serving traffic under a closed loop: ``clients`` callers, each sending
its next request the moment its last one completes, with no think time,
into the program's ``Engine`` driven in this process (``submit``,
``step``, token listeners).

The mix (``traffic/<mix>.json``) gives the clients, the law of the
prompt and of the output lengths (``law``: ``exponential`` with its
``mean``, clipped to ``min``–``max``), the study they come from
(``source``), the ids' range and how many served tokens the comparison
samples (``check_tokens``). The lengths are ``pool`` evenly spaced
quantiles of each law, prompts and outputs paired once by a
permutation the mix fixes; the requests go through that pool pass
after pass as the clients ask, each pass in an order drawn from the
seed, and the seed draws every token id. So every seed offers the same
set of requests, in an order of its own.

Set-up builds the engine from the cell's ``engine`` block on weights
made from the seed in the served type, runs ``Engine.warmup()`` (the
kernels and the resident graph), then starts every client and serves
until ``warm_requests`` have completed, so that the window opens on the
loop's steady state with the traffic's own shapes warm. The window runs
``Engine.step`` until ``seconds`` have passed; then no client sends
again and the requests in flight are served to the end (a minute at
most). ``serve_tokens_per_s`` counts the tokens delivered inside the
window; ``ttft_p95_ms`` is over every request sent in the window, from
its send to its first token (one never answered counts as failed, at an
infinite latency); and ``tpot_p95_ms`` over those completed, (last -
first token) / (tokens - 1).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import harness, tracing, weights
from portbench.reference import check_serve
from portbench.yardstick import flops


def _quantiles(law: dict, q: np.ndarray) -> np.ndarray:
    """Lengths at quantiles ``q`` of ``law``, rounded, clipped."""
    if law["law"] != "exponential":
        raise ValueError(f"unknown length law '{law['law']}'")
    x = -law["mean"] * np.log1p(-q)
    return np.clip(np.rint(x), law["min"], law["max"]).astype(int)


def length_pool(traffic: dict) -> np.ndarray:
    """(pool, 2) int: evenly spaced quantiles of the prompt and output
    length laws, paired by a permutation the mix fixes."""
    n = traffic["pool"]
    q = (np.arange(n) + 0.5) / n
    prompt = _quantiles(traffic["prompt"], q)
    out = _quantiles(traffic["output"], q)
    pair = np.random.default_rng(traffic["pairing"]).permutation(n)
    return np.stack([prompt, out[pair]], axis=1)


class Requests:
    """The run's requests: the pool's pairs pass after pass, each pass in
    an order drawn from the seed, the ids drawn from the seed as the
    requests are taken."""

    def __init__(self, traffic: dict, seed: int):
        self.pool = length_pool(traffic)
        self.orders, self.rng = (np.random.default_rng(s) for s in
                                 np.random.SeedSequence(seed).spawn(2))
        self.vocab = traffic["vocab_ids"]
        self.order: list = []

    def next(self) -> tuple:
        if not self.order:
            self.order = list(self.orders.permutation(len(self.pool)))
        p, o = self.pool[self.order.pop()]
        prompt = self.rng.integers(0, self.vocab, size=int(p),
                                   dtype=np.int64)
        return prompt, int(o)


def build(cell, opts: dict):
    from distributed_training_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from distributed_training_tpu_torch.serving.engine import (
        Engine,
        EngineConfig,
    )

    run, prog = cell.run_cfg, cell.spec["program"]
    device = torch.device(opts["device"])
    model = Transformer(TransformerConfig(
        vocab_size=run["vocab_rows"], d_model=run["d_model"],
        n_layers=run["n_layers"], n_heads=run["n_heads"], d_ff=run["d_ff"],
        n_kv_heads=run.get("n_kv_heads") or 0,
        max_seq_len=run["max_seq_len"], pos_encoding=run["pos_encoding"],
        tie_embeddings=run["tie_embeddings"], dtype=prog["dtype"],
        param_dtype=prog["dtype"]), device=device)
    params = weights.make(run, opts["seed"], device,
                          getattr(torch, prog["dtype"]))
    engine = Engine(model, params, EngineConfig(**cell.spec["engine"]),
                    device=device)
    del params
    return engine


def plant(engine, fault: str | None) -> None:
    """A fault under the timed path (the tests): ``token`` alters each
    request's fifth token where the engine emits it."""
    if fault is None:
        return
    if fault != "token":
        raise ValueError(f"unknown fault '{fault}'")
    emit, vocab = engine._emit_token, engine.model.cfg.vocab_size

    def altered(seq, token):
        if len(seq.generated) == 5:
            token = (int(token) + 1) % vocab
        return emit(seq, token)

    engine._emit_token = altered


class Loop:
    """The clients and what each request saw."""

    def __init__(self, engine, requests: Requests, clients: int):
        self.engine, self.requests, self.clients = engine, requests, clients
        self.open = True
        self.log: dict = {}
        self.n = 0
        self.completed = 0

    def send(self) -> None:
        from distributed_training_tpu_torch.serving.engine import Request

        prompt, out = self.requests.next()
        rid = f"r{self.n}"
        self.n += 1
        rec = {"prompt": prompt, "tokens": [], "times": [],
               "sent": time.perf_counter(), "done": False}
        self.log[rid] = rec

        def listen(token: int, done: bool, rec=rec):
            rec["tokens"].append(token)
            rec["times"].append(time.perf_counter())
            if done:
                rec["done"] = True
                self.completed += 1
                if self.open:
                    self.send()

        self.engine.add_token_listener(rid, listen)
        self.engine.submit(Request(id=rid, prompt=prompt,
                                   max_new_tokens=out))

    def start(self) -> None:
        for _ in range(self.clients):
            self.send()

    def busy(self) -> bool:
        return any(not r["done"] for r in self.log.values())


def _p95(xs: list) -> float:
    return float(np.percentile(np.asarray(xs, dtype=np.float64), 95)) \
        if xs else float("inf")


def _flops(cfg: dict, log: list, t_from: float, t_to: float) -> float:
    """Frozen forward FLOPs of the work of ``[t_from, t_to]``: each prompt
    answered in it (logits for its last token alone) and each token
    delivered in it (``yardstick/flops.py``)."""
    total = 0.0
    for r in log:
        P = len(r["prompt"])
        if r["times"] and t_from <= r["times"][0] <= t_to:
            total += (flops.forward_flops(cfg, 0, False) * P
                      + 4.0 * cfg["n_layers"] * cfg["d_model"]
                      * P * (P + 1) / 2 + 2.0 * cfg["d_model"]
                      * cfg["vocab_rows"])
        for j, t in enumerate(r["times"][1:], start=1):
            if t_from <= t <= t_to:
                total += flops.forward_flops(cfg, P + j, True)
    return total


def run(cell, opts: dict) -> dict:
    t_start, tr = opts["t_start"], cell.traffic
    device = torch.device(opts["device"])
    if opts["trace"]:
        tracing.warm(device)
    engine = build(cell, opts)
    engine.warmup()
    plant(engine, opts.get("fault"))
    loop = Loop(engine, Requests(tr, opts["seed"]), tr["clients"])
    loop.start()
    while loop.completed < tr["warm_requests"]:
        engine.step()
    launches0 = engine.prefill_launches + engine.decode_launches
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    capture = tracing.Capture(device) if opts["trace"] else None
    step_s, active = [], []
    t0 = time.perf_counter()
    if capture:
        capture.start()
    cap = engine.cfg.max_batch
    while True:
        on = capture is not None and capture.on
        a = time.perf_counter()
        active.append(engine.in_flight)
        with tracing.span("engine_step", on):
            engine.step()
        b = time.perf_counter()
        step_s.append(b - a)
        if on and b - t0 >= min(tracing.TRACE_S, opts["seconds"]):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            capture.stop()
            t_after = time.perf_counter()
        if b - t0 >= opts["seconds"]:
            break
    t_close = time.perf_counter()
    if capture is not None and capture.on:
        capture.stop()
        t_after = t_close
    launches = engine.prefill_launches + engine.decode_launches - launches0
    loop.open = False
    deadline = t_close + 60.0
    while loop.busy() and time.perf_counter() < deadline:
        engine.step()
    peak = (max(setup_peak, torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    log = list(loop.log.values())
    window_s = t_close - t0
    sent = [r for r in log if t0 <= r["sent"] < t_close]
    delivered = sum(1 for r in log for t in r["times"] if t0 <= t <= t_close)
    ttft = [(r["times"][0] - r["sent"]) * 1e3 if r["times"] else
            float("inf") for r in sent]
    tpot = [(r["times"][-1] - r["times"][0]) * 1e3 / (len(r["times"]) - 1)
            for r in sent if r["done"] and len(r["times"]) > 1]
    failed = sum(1 for r in sent if not r["done"])
    del engine, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    finished = [r for r in sent if r["done"]]
    ok, checks = harness.judge(
        {"served_gap": check(cell, opts, finished, device)},
        cell.spec["limits"])
    res = {"e2e": {"serve_tokens_per_s": delivered / window_s,
                   "ttft_p95_ms": _p95(ttft), "tpot_p95_ms": _p95(tpot),
                   "setup_s": setup_s},
           "correct": ok and not failed, "attempted": len(sent),
           "failed": failed, "checks": checks,
           "device": _device(device, peak)}
    if opts.get("keep"):
        res["finished"] = finished
    if capture is not None:
        traced = capture.read("engine_step")
        att = traced["attribution"]
        res["device"].update(busy_s=att["busy_s"], window_s=att["window_s"])
        res["breakdown"] = tracing.breakdown(traced)
        res["ctx"] = {
            "cfg": cell.run_cfg, "engine": cell.spec["engine"],
            "traced": traced,
            "host": {"engine_step_s": step_s, "active": active},
            "max_batch": cap, "launches": launches, "delivered": delivered,
            "flops": _flops(cell.run_cfg, log, t_after, t_close),
            "after_s": t_close - t_after,
            "tokens": {"traced": _delivered(log, t0, t_after),
                       "after": _delivered(log, t_after, t_close)},
            "decode_rows": _decode_rows(log, traced, t0)}
    return res


def _delivered(log: list, t_from: float, t_to: float) -> int:
    return sum(1 for r in log for t in r["times"] if t_from <= t < t_to)


def _decode_rows(log: list, traced: dict, t0: float) -> list:
    """The cached-key counts of the tokens decoded inside the traced
    stretch (a token at position p attends p + 1 keys)."""
    span = (traced["window"][1] - traced["window"][0]) * 1e-12
    rows = []
    for r in log:
        P = len(r["prompt"])
        for j, t in enumerate(r["times"][1:], start=1):
            if t - t0 <= span:
                rows.append(P + j)
    return rows


def check(cell, opts: dict, finished: list, device) -> float:
    """``served_gap`` over a sample of the finished requests."""
    picked = check_serve.sample(finished, opts["seed"],
                                cell.traffic["check_tokens"])
    params = check_serve.served_weights(cell.run_cfg, opts["seed"], device,
                                        cell.spec["program"]["dtype"])
    return check_serve.served_gap(
        check_serve.gaps(cell.run_cfg, params, picked, device))


def _device(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
