"""Reduction of a ``torch.profiler`` Chrome trace to device time.

The interval arithmetic is that of the program's
``telemetry/kineto.py`` (itself JAX's ``xplane.py``), copied so that a
change to the program cannot move the ruler: device events are the
trace's ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` records, times are
integer picoseconds, busy time is the union over every stream, NCCL
kernels are collectives, and a collective's exposed time is the part of
it no compute kernel covers.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
ANNOTATION_CATEGORY = "user_annotation"
COLLECTIVE_PATTERNS = ("nccl", "c10d::", "gloo:", "all-to-all",
                       "all-reduce", "all-gather", "reduce-scatter",
                       "collective-permute")


@dataclass
class Event:
    """One timeline event; absolute times in integer picoseconds."""

    name: str
    start_ps: int
    dur_ps: int

    @property
    def end_ps(self) -> int:
        return self.start_ps + self.dur_ps


def _ps(us) -> int:
    """Kineto microseconds (nanosecond decimals) to integer ps."""
    return round(float(us) * 1000) * 1000


def load(path: str) -> tuple[list[Event], list[Event]]:
    """(device events, host annotations) of a Chrome-trace file."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    records = data.get("traceEvents", []) if isinstance(data, dict) else data
    device, host = [], []
    for r in records:
        if not isinstance(r, dict) or r.get("ph") != "X":
            continue
        if not isinstance(r.get("ts"), (int, float)) or not isinstance(
                r.get("dur"), (int, float)):
            continue
        ev = Event(str(r.get("name", "")), _ps(r["ts"]), _ps(r["dur"]))
        if r.get("cat") in DEVICE_CATEGORIES:
            device.append(ev)
        elif r.get("cat") == ANNOTATION_CATEGORY:
            host.append(ev)
    return device, host


def is_collective(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in COLLECTIVE_PATTERNS)


def union(intervals) -> list[tuple[int, int]]:
    """Merged, sorted, disjoint intervals."""
    out: list[tuple[int, int]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def measure(merged) -> int:
    return sum(e - s for s, e in merged)


def intersect_measure(a, b) -> int:
    """Total overlap of two merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribution(device: list[Event], window: tuple[int, int]) -> dict:
    """Busy, compute, collective and exposed-collective seconds of the
    device events inside ``window`` (ps), clipped to it."""
    t0, t1 = window
    comp, coll = [], []
    for ev in device:
        s, e = max(ev.start_ps, t0), min(ev.end_ps, t1)
        if e > s:
            (coll if is_collective(ev.name) else comp).append((s, e))
    comp_u, coll_u = union(comp), union(coll)
    busy = measure(union(comp + coll))
    coll_total = measure(coll_u)
    overlap = intersect_measure(comp_u, coll_u)
    ps = 1e-12
    return {"window_s": (t1 - t0) * ps, "busy_s": busy * ps,
            "compute_s": measure(comp_u) * ps,
            "collective_s": coll_total * ps,
            "exposed_collective_s": (coll_total - overlap) * ps}


def idle_gaps(device: list[Event], host: list[Event],
              window: tuple[int, int], top: int = 10) -> list:
    """The longest stretches of the window with no device work, each
    named by the host annotation that covers its middle (``host`` where
    none does): ``[[name, seconds], ...]``, longest first."""
    busy = union((ev.start_ps, ev.end_ps) for ev in device)
    gaps, cur = [], window[0]
    for s, e in busy + [(window[1], window[1])]:
        s, e = max(s, window[0]), min(e, window[1])
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:top]:
        mid = (s + e) // 2
        names = [h.name for h in host if h.start_ps <= mid < h.end_ps]
        out.append([names[-1] if names else "host", (e - s) * 1e-12])
    return out


def device_ops(device: list[Event], window: tuple[int, int],
               top: int = 10) -> list:
    """Device time by kernel name inside the window, most first:
    ``[[name, seconds], ...]`` (names cut to 120 characters)."""
    t0, t1 = window
    acc: dict = {}
    for ev in device:
        s, e = max(ev.start_ps, t0), min(ev.end_ps, t1)
        if e > s:
            key = ev.name[:120]
            acc[key] = acc.get(key, 0) + (e - s)
    rows = sorted(acc.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v * 1e-12] for k, v in rows]
