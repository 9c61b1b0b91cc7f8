"""Kineto trace access: the port's counterpart of ``telemetry/xplane.py``.

The JAX package's ``xplane.py`` (614 lines) decodes ``jax.profiler``'s
XSpace protobufs with a stdlib wire-format reader and decomposes the
captured device timeline. ``torch.profiler`` writes a Chrome-trace JSON
(``export_chrome_trace``) instead, so this module reads that:

- ``load_trace`` / ``find_trace`` — the trace file of a capture;
- ``timeline_events`` — the device lanes: events of category ``kernel``,
  ``gpu_memcpy`` and ``gpu_memset``, one lane per (device, stream).
  ``record_function`` ranges (the telemetry spans) appear on the device
  timeline too, as ``gpu_user_annotation``; they are not work and are
  left out. A trace without device events (a CPU run) falls back to the
  host's ``cpu_op`` events;
- ``classify_event`` — NCCL kernels (and XLA's collective names) are
  ``collective``, every other op ``compute``;
- ``annotation_window`` — the extent of the capture's ``step``,
  ``data_wait`` and ``compile`` ranges on the host, which widens the
  window so host and data time before the first kernel counts;
- ``attribution_of_events`` — the interval arithmetic of JAX's
  ``xplane.attribution_of_events`` (union across lanes, exposed
  collective time, overlap fraction), in integer picoseconds, with the
  same report keys as JAX's ``attribution_of_planes``.

Kineto stores ``ts``/``dur`` as microseconds with nanosecond decimals;
they are read into integer nanoseconds, then picoseconds, so the
arithmetic is exact.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass

SCHEMA = 1

# Chrome-trace categories of work on the card.
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
# The host's operator events: the fallback timeline of a CPU run.
HOST_OP_CATEGORY = "cpu_op"
# Host ranges opened by ``record_function`` (the telemetry spans).
ANNOTATION_CATEGORY = "user_annotation"

# Collective names: NCCL's kernels on the card, the c10d/gloo ops of a
# CPU trace, and XLA's spellings, so a timeline of JAX's op names reads
# the same in both packages. (A bare "permute" would take aten::permute.)
COLLECTIVE_PATTERNS = ("nccl", "c10d::", "gloo:", "all-to-all",
                       "all-reduce", "all-gather", "reduce-scatter",
                       "collective-permute")

# The repo's own telemetry span names: window markers, never op work.
_TELEMETRY_SPANS = frozenset({
    "step", "compile", "data_wait", "data_assemble", "eval",
    "ckpt_save", "ckpt_restore", "ckpt_wait", "collectives_audit"})

# The span names whose host ranges bound a captured step.
WINDOW_MARKERS = frozenset({"step", "data_wait", "compile"})


class KinetoError(RuntimeError):
    """A trace that cannot be found or read (the runtime attribution
    turns it into an ``error`` field on its event)."""


@dataclass
class Event:
    """One timeline event, absolute times in integer picoseconds."""

    name: str
    start_ps: int
    dur_ps: int
    lane: tuple = ()

    @property
    def end_ps(self) -> int:
        return self.start_ps + self.dur_ps


def _ps(us) -> int:
    """Kineto microseconds (nanosecond decimals) → integer ps."""
    return round(float(us) * 1000) * 1000


def find_trace(trace_dir: str) -> str:
    """The newest Chrome-trace JSON under ``trace_dir``."""
    hits = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise KinetoError(f"no trace .json under {trace_dir}")
    return hits[-1]


def load_trace(path: str) -> list[dict]:
    """The complete (``ph`` "X") events of a Chrome-trace file."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        raise KinetoError(f"cannot read {path} as a Chrome trace "
                          f"({type(e).__name__}: {e})") from e
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list):
        raise KinetoError(f"{path} holds no traceEvents list")
    return [e for e in events if isinstance(e, dict) and e.get("ph") == "X"
            and isinstance(e.get("ts"), (int, float))
            and isinstance(e.get("dur"), (int, float))]


def _event(rec: dict) -> Event:
    return Event(name=str(rec.get("name", "")), start_ps=_ps(rec["ts"]),
                 dur_ps=_ps(rec["dur"]),
                 lane=(rec.get("pid"), rec.get("tid")))


def timeline_events(records: list[dict]) -> tuple[list[Event], str, int]:
    """The op events attribution measures: ``(events, source, lanes)``,
    ``source`` "device" when the trace holds device work, else "host"
    (the CPU's operator events)."""
    device = [_event(r) for r in records
              if r.get("cat") in DEVICE_CATEGORIES]
    if device:
        return device, "device", len({ev.lane for ev in device})
    host = [_event(r) for r in records if r.get("cat") == HOST_OP_CATEGORY]
    return host, "host", len({ev.lane for ev in host})


def classify_event(name: str) -> str | None:
    """``"collective"`` / ``"compute"`` for op events, None for the
    telemetry spans."""
    if not name or name in _TELEMETRY_SPANS:
        return None
    low = name.lower()
    for p in COLLECTIVE_PATTERNS:
        if p in low:
            return "collective"
    return "compute"


def annotation_window(records: list[dict]) -> tuple[int, int] | None:
    """Extent of the capture's step/data_wait/compile ranges on the
    host; None when the trace has none."""
    t0 = t1 = None
    for r in records:
        if (r.get("cat") != ANNOTATION_CATEGORY
                or r.get("name") not in WINDOW_MARKERS):
            continue
        ev = _event(r)
        t0 = ev.start_ps if t0 is None else min(t0, ev.start_ps)
        t1 = ev.end_ps if t1 is None else max(t1, ev.end_ps)
    return None if t0 is None else (t0, t1)


# ---------------------------------------------------------------------------
# interval arithmetic (integer picoseconds, exact; JAX xplane.py's)
# ---------------------------------------------------------------------------


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merged, sorted, disjoint intervals."""
    out: list[tuple[int, int]] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _measure(merged: list[tuple[int, int]]) -> int:
    return sum(e - s for s, e in merged)


def _intersect_measure(a: list[tuple[int, int]],
                       b: list[tuple[int, int]]) -> int:
    """Total overlap between two merged interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribution_of_events(events: list[Event], source: str = "",
                          lanes: int = 0, classify=classify_event,
                          window: tuple[int, int] | None = None) -> dict:
    """Decompose a captured window into compute / collective / host
    (unions taken across lanes, so concurrent streams count once):

    - window = [earliest op start, latest op end], widened (never
      narrowed) by ``window``, the capture's annotation extent;
    - compute = union of compute-op intervals, including time a
      collective ran beside it (comms the schedule hid);
    - collective (exposed) = collective time not under compute;
    - host = window minus all op time: the card waiting on the host;
    - overlap_frac = (collective ∩ compute) / collective time.

    ``compute_frac + collective_frac + host_frac == 1`` by
    construction."""
    comp: list[tuple[int, int]] = []
    coll: list[tuple[int, int]] = []
    n_events = 0
    for ev in events:
        kind = classify(ev.name)
        if kind is None:
            continue
        n_events += 1
        (coll if kind == "collective" else comp).append(
            (ev.start_ps, ev.end_ps))
    comp_u, coll_u = _union(comp), _union(coll)
    busy_u = _union(comp + coll)
    base = {"schema": SCHEMA, "source": source, "lanes": lanes}
    if not busy_u:
        w = ((window[1] - window[0]) * 1e-12) if window else 0.0
        return {**base, "window_s": round(w, 9), "busy_s": 0.0,
                "compute_s": 0.0, "collective_s": 0.0,
                "overlap_s": 0.0, "compute_frac": 0.0,
                "collective_frac": 0.0, "host_frac": 1.0,
                "overlap_frac": 0.0, "events": 0}
    t0, t1 = busy_u[0][0], busy_u[-1][1]
    if window is not None:
        t0, t1 = min(t0, window[0]), max(t1, window[1])
    span = t1 - t0
    compute_ps = _measure(comp_u)
    coll_total_ps = _measure(coll_u)
    overlap_ps = _intersect_measure(comp_u, coll_u)
    busy_ps = _measure(busy_u)
    ps = 1e-12

    def frac(x: int) -> float:
        return round(x / span, 6) if span else 0.0

    return {
        **base,
        "window_s": round(span * ps, 9),
        "busy_s": round(busy_ps * ps, 9),
        "compute_s": round(compute_ps * ps, 9),
        "collective_s": round(coll_total_ps * ps, 9),
        "overlap_s": round(overlap_ps * ps, 9),
        "compute_frac": frac(compute_ps),
        "collective_frac": frac(coll_total_ps - overlap_ps),
        "host_frac": frac(span - busy_ps),
        "overlap_frac": (round(overlap_ps / coll_total_ps, 6)
                         if coll_total_ps else 0.0),
        "events": n_events,
    }


def attribution_of_trace(records: list[dict]) -> dict:
    """Attribution straight from a trace's events: lane selection,
    annotation window and arithmetic in one composition (the port's
    ``attribution_of_planes``)."""
    events, source, lanes = timeline_events(records)
    return attribution_of_events(events, source=source, lanes=lanes,
                                 window=annotation_window(records))


def top_kernels(records: list[dict], n: int = 8) -> list[dict]:
    """The ``n`` device ops that took the most time, by name."""
    events, _, _ = timeline_events(records)
    per: dict[str, list] = {}
    for ev in events:
        if classify_event(ev.name) is None:
            continue
        tot = per.setdefault(ev.name, [0, 0])
        tot[0] += ev.dur_ps
        tot[1] += 1
    rows = sorted(per.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:120], "s": round(v[0] * 1e-12, 9), "count": v[1]}
            for k, v in rows]
