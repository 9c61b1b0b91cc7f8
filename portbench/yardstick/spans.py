"""Device time by the program's telemetry spans, from a ``torch.profiler``
Chrome trace.

Every span of the program opens a ``record_function`` range while a
profiler runs (``telemetry/events.py``), on Kineto's clock, which the
card's events share. A device event (``kernel``, ``gpu_memcpy``,
``gpu_memset``) carries the correlation id of the CUDA call that issued
it (``cudaLaunchKernel``, ``cudaGraphLaunch`` for every kernel of a
graph, ``cudaMemcpyAsync``, a driver launch); that call is a host event
with a timestamp and a thread. The event belongs to every span, on any
thread, whose interval holds the call's timestamp: so a kernel that the
autograd engine's device thread launches during the main thread's
``backward`` belongs to ``backward``. Its innermost span is the shortest
of them. An event with no such span, or with no call found, is
unattributed.

Times are integer picoseconds, as in ``timeline.py``; device time of a
set of events is the union of their intervals clipped to the window.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from portbench.yardstick import timeline

# Host events that issue device work and carry its correlation id.
LAUNCH_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})


@dataclass
class Span:
    """One ``record_function`` range of a host thread."""

    name: str
    start_ps: int
    dur_ps: int
    tid: object

    @property
    def end_ps(self) -> int:
        return self.start_ps + self.dur_ps


@dataclass
class Trace:
    """``device``: the card's events; ``launch``: each device event's
    issuing call's timestamp (None: not found), by index into
    ``device``; ``spans``: every host annotation."""

    device: list
    launch: list
    spans: list


def load(path: str) -> Trace:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    records = data.get("traceEvents", []) if isinstance(data, dict) else data
    device, corr, spans, calls = [], [], [], {}
    for r in records:
        if not isinstance(r, dict) or r.get("ph") != "X":
            continue
        if not isinstance(r.get("ts"), (int, float)) or not isinstance(
                r.get("dur"), (int, float)):
            continue
        cat = r.get("cat")
        args = r.get("args") or {}
        start, dur = timeline._ps(r["ts"]), timeline._ps(r["dur"])
        if cat in timeline.DEVICE_CATEGORIES:
            device.append(timeline.Event(str(r.get("name", "")), start,
                                         dur))
            corr.append(args.get("correlation"))
        elif cat in LAUNCH_CATEGORIES and "correlation" in args:
            calls[args["correlation"]] = start
        elif cat == timeline.ANNOTATION_CATEGORY:
            spans.append(Span(str(r.get("name", "")), start, dur,
                              r.get("tid")))
    return Trace(device, [calls.get(c) for c in corr], spans)


def covering(times: list, spans: list) -> list:
    """For each time (ps, or None), the spans whose ``[start, end)``
    holds it (one sweep over both sorted)."""
    out: list = [[] for _ in times]
    order = sorted((t, i) for i, t in enumerate(times) if t is not None)
    ranked = sorted(spans, key=lambda s: s.start_ps)
    active: list = []
    j = 0
    for t, i in order:
        while j < len(ranked) and ranked[j].start_ps <= t:
            active.append(ranked[j])
            j += 1
        active = [s for s in active if s.end_ps > t]
        out[i] = list(active)
    return out


def _clipped(events, window) -> list:
    t0, t1 = window
    return [(max(ev.start_ps, t0), min(ev.end_ps, t1)) for ev in events]


def attribute(trace: Trace, spans: list, window: tuple) -> dict:
    """Device seconds inside ``window`` by span name: ``inclusive`` (the
    events that any span of the name holds), ``innermost`` (the events
    whose shortest holding span has the name), ``unattributed`` (busy
    time no attributed event covers, so that the union of the attributed
    events plus it is ``busy``) and ``counts`` (the spans of each name
    that start inside the window)."""
    held = covering(trace.launch, spans)
    inclusive: dict = {}
    innermost: dict = {}
    attributed, rest = [], []
    for ev, hs in zip(trace.device, held):
        if not hs:
            rest.append(ev)
            continue
        attributed.append(ev)
        inner = min(hs, key=lambda s: (s.dur_ps, -s.start_ps))
        innermost.setdefault(inner.name, []).append(ev)
        for name in {s.name for s in hs}:
            inclusive.setdefault(name, []).append(ev)
    ps = 1e-12

    def busy(events) -> float:
        return timeline.measure(timeline.union(_clipped(events, window))) \
            * ps

    total = busy(trace.device)
    t0, t1 = window
    counts: dict = {}
    for s in spans:
        if t0 <= s.start_ps < t1:
            counts[s.name] = counts.get(s.name, 0) + 1
    return {"inclusive": {k: busy(v) for k, v in inclusive.items()},
            "innermost": {k: busy(v) for k, v in innermost.items()},
            "unattributed": total - busy(attributed), "busy": total,
            "counts": counts}


def idle_gaps(device: list, spans: list, window: tuple,
              top: int = 10) -> list:
    """``timeline.idle_gaps``, each gap named by the shortest annotation,
    on any thread, that holds its middle (``host`` where none does)."""
    busy = timeline.union((ev.start_ps, ev.end_ps) for ev in device)
    gaps, cur = [], window[0]
    for s, e in busy + [(window[1], window[1])]:
        s, e = max(s, window[0]), min(e, window[1])
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:top]
    held = covering([(s + e) // 2 for s, e in gaps], spans)
    return [[min(hs, key=lambda h: h.dur_ps).name if hs else "host",
             (e - s) * 1e-12] for (s, e), hs in zip(gaps, held)]
