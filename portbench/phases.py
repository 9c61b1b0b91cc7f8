"""A cell's readings by the program's own telemetry: device time by the
program's spans (``yardstick/spans.py``), the engine's host time and KV
occupancy from the in-memory sink (``SpanTotals``,
``telemetry/events.py``), and what that sink costs.

    python3 portbench/phases.py --workload <cell> --seed <n> \
        [--seconds 10] [--rounds 2]

Set-up is the cell's generator's (``traffic/train.py::setup``;
``traffic/closed_loop.py::build``, ``Engine.warmup`` and the loop's
warm requests). Then ``--rounds`` pairs of untraced stretches of
``--seconds`` each, without and with the sink installed, in turn; then
one stretch with the sink installed: ``tracing.TRACE_S`` seconds under
``torch.profiler`` with the harness's spans, as a ``--trace 1`` window
opens, then ``--seconds`` more, over which the sink's totals, the rates
and the host times are taken. One JSON line a stretch, then a summary
line: ``cost`` is one less the rate with the sink over the rate without
(the medians of the rounds).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness, tracing  # noqa: E402
from portbench.yardstick import spans  # noqa: E402

# Device time read a step (training) or a launch (serving), in ms.
TRAIN_PHASES = ("forward", "backward", "optimizer", "fsdp.gather",
                "fsdp.reduce_scatter")
SERVE_PHASES = ("engine.prefill", "engine.decode")


def _events():
    from distributed_training_tpu_torch.telemetry import events

    return events


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reduce(capture, step_span: str) -> dict:
    """The capture's trace by the program's spans: busy, attribution,
    the traced steps and the idle gaps, each gap named by its innermost
    annotation."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        capture.prof.export_chrome_trace(path)
        trace = spans.load(path)
    finally:
        os.remove(path)
    ours = [s for s in trace.spans if s.name in tracing.SPANS]
    edges = [(s.start_ps, s.end_ps) for s in ours] + [
        (d.start_ps, d.end_ps) for d in trace.device]
    window = ((min(e[0] for e in edges), max(e[1] for e in edges))
              if edges else (0, 0))
    program = [s for s in trace.spans if s.name not in tracing.SPANS]
    att = spans.attribute(trace, program, window)
    att["steps"] = sum(1 for s in ours if s.name == step_span)
    att["window_s"] = (window[1] - window[0]) * 1e-12
    att["idle_gaps"] = spans.idle_gaps(trace.device, trace.spans, window)
    return att


def _per(total: float, n: int):
    return 1e3 * total / n if n else None


class _Stretch:
    """One stretch's sink, capture and clocks."""

    def __init__(self, device, sink: bool, trace: bool):
        events = _events()
        self.device = device
        self.tel = events.install(events.SpanTotals()) if sink else None
        self.capture = tracing.Capture(device) if trace else None

    def start(self) -> None:
        _sync(self.device)
        self.t0 = self.t_after = time.perf_counter()
        if self.capture:
            self.capture.start()

    @property
    def on(self) -> bool:
        return self.capture is not None and self.capture.on

    def poll(self, now: float) -> bool:
        """Close the traced part once its seconds have passed; True when
        it closed now (the caller marks its counters there)."""
        if self.on and now - self.t0 >= tracing.TRACE_S:
            _sync(self.device)
            self.capture.stop()
            self.t_after = time.perf_counter()
            if self.tel is not None:
                self.tel.reset()
            return True
        return False

    def done(self, now: float, seconds: float) -> bool:
        """``seconds`` have passed since the traced part closed (since
        the start, untraced)."""
        return not self.on and now - self.t_after >= seconds

    def close(self) -> dict:
        _sync(self.device)
        t1 = time.perf_counter()
        if self.on:
            self.capture.stop()
            self.t_after = t1
        out = {"seconds": t1 - self.t0, "after_s": t1 - self.t_after,
               "totals": self.tel.totals() if self.tel else None}
        if self.tel is not None:
            _events().uninstall()
        return out


def train_stretch(trainer, feed, device, seconds: float, sink: bool,
                  trace: bool, step_span: str = "train_step") -> dict:
    st = _Stretch(device, sink, trace)
    st.start()
    n = after = 0
    while True:
        on = st.on
        with tracing.span("data_wait", on):
            batch = feed.next()
        with tracing.span(step_span, on):
            trainer.train_step(batch)
        n += 1
        if st.poll(time.perf_counter()):
            after = n
        if st.done(time.perf_counter(), seconds):
            break
    out = st.close()
    out.update(steps=n, after_steps=n - after if trace else n)
    if trace:
        att = _reduce(st.capture, step_span)
        k = att["steps"]
        out["device_ms"] = {p: _per(att["inclusive"].get(p, 0.0), k)
                            for p in TRAIN_PHASES}
        out["step_device_ms"] = _per(att["busy"], k)
        out["unattributed_share"] = (att["unattributed"] / att["busy"]
                                     if att["busy"] else None)
        out["idle_gaps"] = att["idle_gaps"]
        out["traced_steps"] = k
        if k and out["after_steps"] and out["after_s"] > 0:
            out["idle_share"] = 100.0 * (1.0 - att["busy"] / k
                                         * out["after_steps"]
                                         / out["after_s"])
    return out


def _delivered(loop, t_from: float, t_to: float) -> int:
    return sum(1 for r in loop.log.values() for t in r["times"]
               if t_from <= t < t_to)


def serve_stretch(engine, loop, device, seconds: float, sink: bool,
                  trace: bool) -> dict:
    st = _Stretch(device, sink, trace)
    marks = (engine.engine_steps, engine.kv_pages_used)
    st.start()
    host = []
    while True:
        on = st.on
        a = time.perf_counter()
        with tracing.span("engine_step", on):
            engine.step()
        b = time.perf_counter()
        if not on:
            host.append(b - a)
        if st.poll(b):
            marks = (engine.engine_steps, engine.kv_pages_used)
        if st.done(time.perf_counter(), seconds):
            break
    out = st.close()
    t_close = st.t0 + out["seconds"]
    steps = engine.engine_steps - marks[0]
    usable = engine.cache.cfg.usable_pages_total
    out.update(
        steps=len(host), host_step_ms=1e3 * statistics.fmean(host),
        tokens_per_s=(_delivered(loop, st.t_after, t_close)
                      / out["after_s"] if out["after_s"] > 0 else None),
        kv_occupancy=(100.0 * (engine.kv_pages_used - marks[1]) / steps
                      / usable if steps else None))
    tot = out["totals"]
    if tot and tot["spans"].get("engine.step"):
        sp = tot["spans"]
        n = sp["engine.step"]["count"]
        device_side = sum(v["total_s"] for k, v in sp.items()
                          if k.endswith((".launch", ".fetch")))
        out["engine_bookkeeping_ms"] = 1e3 * (
            sp["engine.step"]["total_s"] - device_side) / n
        out["host_ms_a_step"] = {k: 1e3 * v["self_s"] / n
                                 for k, v in sorted(sp.items())}
    if trace:
        att = _reduce(st.capture, "engine_step")
        out["device_ms"] = {
            p: _per(att["inclusive"].get(p, 0.0), att["counts"].get(p, 0))
            for p in SERVE_PHASES}
        covered = sum(att["inclusive"].get(p, 0.0) for p in SERVE_PHASES)
        out["phases_over_busy"] = (covered / att["busy"] if att["busy"]
                                   else None)
        out["unattributed_share"] = (att["unattributed"] / att["busy"]
                                     if att["busy"] else None)
        out["launches"] = {p: att["counts"].get(p, 0) for p in SERVE_PHASES}
        out["busy_s"] = att["busy"]
        out["traced_window_s"] = att["window_s"]
        out["idle_gaps"] = att["idle_gaps"]
    return out


def _emit(**rec) -> None:
    print(json.dumps(rec), flush=True)


def _rounds(run, rounds: int, rate: str) -> dict:
    """``rounds`` pairs without and with the sink, then the traced
    stretch; the summary's cost from the rate named ``rate``."""
    got = {False: [], True: []}
    for r in range(rounds):
        for sink in (False, True) if r % 2 == 0 else (True, False):
            out = run(sink, False)
            got[sink].append(out[rate])
            _emit(kind="stretch", sink=sink, **out)
    out = run(True, True)
    _emit(kind="traced", sink=True, **out)
    off, on = (statistics.median(got[k]) for k in (False, True))
    return {"rate": rate, "off": got[False], "on": got[True],
            "cost": 1.0 - on / off if off else None}


def train(cell, opts: dict) -> dict:
    import torch

    generator = harness.load_module("traffic", "train")
    if opts["device"] != "cpu":
        torch.cuda.set_device(0)
    tracing.warm(torch.device(opts["device"], 0)
                 if opts["device"] != "cpu" else torch.device("cpu"))
    s = generator.setup(cell, opts)
    device = s["rt"].device
    B = cell.traffic["batch_per_chip"]

    def run(sink, trace):
        out = train_stretch(s["trainer"], s["feed"], device,
                            opts["seconds"], sink, trace)
        out["samples_per_s"] = (out["after_steps"] * B / out["after_s"]
                                if out["after_s"] > 0 else None)
        return out

    try:
        return _rounds(run, opts["rounds"], "samples_per_s")
    finally:
        generator.free(s)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def serve(cell, opts: dict) -> dict:
    import torch

    generator = harness.load_module("traffic", "closed_loop")
    device = torch.device(opts["device"])
    tracing.warm(device)
    engine = generator.build(cell, opts)
    engine.warmup()
    loop = generator.Loop(engine, generator.Requests(cell.traffic,
                                                     opts["seed"]),
                          cell.traffic["clients"])
    loop.start()
    while loop.completed < cell.traffic["warm_requests"]:
        engine.step()

    def run(sink, trace):
        return serve_stretch(engine, loop, device, opts["seconds"], sink,
                             trace)

    return _rounds(run, opts["rounds"], "tokens_per_s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    harness.set_cache_env()
    cell = harness.load_cell(args.workload)
    kind = harness.check_device(cell.chips)
    opts = {"seed": args.seed, "seconds": args.seconds,
            "rounds": args.rounds, "device": "cuda",
            "t_start": time.perf_counter()}
    run = train if cell.traffic["generator"] == "train" else serve
    _emit(kind="summary", workload=cell.name, device=kind, **run(cell, opts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
