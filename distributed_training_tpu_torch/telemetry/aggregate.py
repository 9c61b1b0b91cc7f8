"""Cross-host telemetry aggregation: N per-host streams → one report.

The port of ``telemetry/aggregate.py``, which is framework-free; this is the
port's own copy, so a run dir of either package reads the same.

In a world of several processes every process writes its own event stream
(``<run_dir>/host_<i>/events.jsonl``, train/cli.py), because a central
writer would put a network hop inside the instrumentation path and a
crashed coordinator would take every host's evidence with it. This
module is the offline other half: merge the per-host streams into one
clock-aligned timeline and answer the questions a single stream cannot
— which host a slow step belongs to, how the goodput buckets differ
per host, and who everyone else was waiting for (the per-worker skew
measurement arXiv:2505.12832 argues scaling work is blind without).

Clock alignment: every host's stream carries a ``clock_sync`` record
whose ``t_sync`` was read immediately after a cross-host barrier at
runtime setup (``runtime.py::clock_sync_record``), i.e. N readings of the same
instant. The
offset of host h is ``t_sync_h - median(t_sync)``; subtracting it puts
all streams on the median host's clock to within collective latency —
enough to order step-level events, not profiler-grade. Streams without a
sync record merge with zero correction.

Straggler attribution reuses ``straggler.flag_stragglers`` — the SAME
rule the runtime detector applies in the run — so a post-hoc skew report
and a live ``straggler`` event can never disagree about what counts as
a straggler. Per-host goodput reuses ``goodput.goodput_of_stream`` for
the same reason.

Entry point: ``python -m distributed_training_tpu_torch.telemetry <run_dir>``
auto-detects per-host subdirs and renders the merged report
(summarize.py dispatches here).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

from distributed_training_tpu_torch.telemetry import collectives as collectives_lib
from distributed_training_tpu_torch.telemetry.goodput import goodput_of_stream
from distributed_training_tpu_torch.telemetry.straggler import flag_stragglers
from distributed_training_tpu_torch.telemetry.summarize import (
    _attribution, _attribution_static, _loss_stats, _recovery,
    load_jsonl, render_attribution_lines, render_recovery_lines)

# Bump when the aggregate summary's keys change meaning.
SCHEMA = 1

_HOST_DIR = re.compile(r"host_(\d+)$")


def host_dirs(run_dir: str) -> dict[int, str]:
    """``host_<i>`` subdirs that actually hold an event stream."""
    out: dict[int, str] = {}
    for name in os.listdir(run_dir):
        m = _HOST_DIR.fullmatch(name)
        path = os.path.join(run_dir, name)
        if m and os.path.isfile(os.path.join(path, "events.jsonl")):
            out[int(m.group(1))] = path
    return dict(sorted(out.items()))


def is_multihost_run_dir(run_dir: str) -> bool:
    return bool(host_dirs(run_dir))


def load_host_streams(run_dir: str) -> dict[int, list[dict]]:
    return {h: load_jsonl(os.path.join(d, "events.jsonl"))
            for h, d in host_dirs(run_dir).items()}


def clock_offsets(streams: dict[int, list[dict]]) -> dict[int, float]:
    """Per-host clock offset (seconds AHEAD of the reference clock),
    from each stream's first ``clock_sync`` record. Median host is the
    reference so one host with a wild clock cannot skew everyone."""
    syncs = {
        h: next((e["t_sync"] for e in evs
                 if e.get("kind") == "clock_sync"
                 and isinstance(e.get("t_sync"), (int, float))), None)
        for h, evs in streams.items()}
    known = [v for v in syncs.values() if v is not None]
    if not known:
        return {h: 0.0 for h in streams}
    ref = float(np.median(known))
    return {h: (float(v) - ref if v is not None else 0.0)
            for h, v in syncs.items()}


def merge_streams(streams: dict[int, list[dict]],
                  offsets: dict[int, float] | None = None) -> list[dict]:
    """One clock-aligned timeline, sorted by corrected ``t``. Every
    record carries ``host`` (kept if the sink already stamped it,
    else the stream's directory index)."""
    offsets = offsets if offsets is not None else clock_offsets(streams)
    merged: list[dict] = []
    for h, evs in streams.items():
        off = offsets.get(h, 0.0)
        last_t = 0.0
        for e in evs:
            rec = dict(e)
            rec.setdefault("host", h)
            if isinstance(rec.get("t"), (int, float)):
                rec["t"] = rec["t"] - off
                last_t = rec["t"]
            else:
                # Torn record without a timestamp: anchor it where the
                # stream was, so the sort cannot fling it to t=0.
                rec["t"] = last_t
            merged.append(rec)
    merged.sort(key=lambda r: r["t"])
    return merged


def write_merged(run_dir: str, path: str) -> int:
    """Write the merged, clock-aligned timeline as jsonl; returns the
    record count. (This is a derived artifact of already-emitted
    records, not an emission path — the sink rule does not apply.)"""
    streams = load_host_streams(run_dir)
    merged = merge_streams(streams)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for rec in merged:
            f.write(json.dumps(rec) + "\n")
    return len(merged)


def _span_durs(events: list[dict], name: str) -> list[float]:
    return [e["dur_s"] for e in events
            if e.get("kind") == "span" and e.get("name") == name
            and isinstance(e.get("dur_s"), (int, float))]


def _mean(vals: list[float]) -> float | None:
    return round(float(np.mean(vals)), 6) if vals else None


def skew_report(streams: dict[int, list[dict]]) -> dict:
    """Per-host timing skew from the raw streams (duration-based, so
    clock offsets cannot contaminate it).

    - ``per_host``: mean step / mean+total data_wait / total
      checkpoint seconds per host;
    - ``step_spread``: for every step number timed on >= 2 hosts, the
      max-min duration spread — plus which host was slowest most
      often (``worst_host``), the straggler fingerprint;
    - ``ckpt_barrier_spread_s``: max-min of per-host checkpoint
      seconds. Collective saves make every host wait for the slowest
      participant, so a large spread means the FAST hosts burned that
      time blocked at the barrier.
    """
    per_host: dict[int, dict] = {}
    by_step: dict[int, dict[int, float]] = {}
    for h, evs in streams.items():
        steps = _span_durs(evs, "step")
        waits = _span_durs(evs, "data_wait")
        ckpt = sum(_span_durs(evs, "ckpt_save")
                   + _span_durs(evs, "ckpt_wait")
                   + _span_durs(evs, "ckpt_restore"))
        per_host[h] = {
            "step": _mean(steps),
            "data_wait": _mean(waits),
            "data_wait_total_s": round(sum(waits), 4),
            "checkpoint_total_s": round(ckpt, 4),
            "steps": len(steps),
        }
        for e in evs:
            if (e.get("kind") == "span" and e.get("name") == "step"
                    and isinstance(e.get("step"), int)
                    and isinstance(e.get("dur_s"), (int, float))):
                by_step.setdefault(e["step"], {})[h] = e["dur_s"]
    spreads = []
    slowest_count: dict[int, int] = {}
    worst = None
    for step, durs in sorted(by_step.items()):
        if len(durs) < 2:
            continue
        spread = max(durs.values()) - min(durs.values())
        slow_host = max(durs, key=durs.get)
        slowest_count[slow_host] = slowest_count.get(slow_host, 0) + 1
        spreads.append(spread)
        if worst is None or spread > worst["spread_s"]:
            worst = {"step": step, "spread_s": round(spread, 6),
                     "slowest_host": slow_host}
    ckpts = [d["checkpoint_total_s"] for d in per_host.values()]
    out: dict = {
        "per_host": per_host,
        "steps_compared": len(spreads),
        "ckpt_barrier_spread_s": (round(max(ckpts) - min(ckpts), 4)
                                  if len(ckpts) >= 2 else None),
    }
    if spreads:
        out["step_spread"] = {
            "mean_s": round(float(np.mean(spreads)), 6),
            "max_s": round(float(np.max(spreads)), 6),
            "worst": worst,
            "worst_host": max(slowest_count, key=slowest_count.get),
        }
    return out


def _configured_threshold(run_dir: str) -> float | None:
    """The run's own ``train.straggler_threshold`` from its
    resolved_config.yaml, or None when absent/unreadable. The offline
    pass must judge by the same threshold the runtime detector used —
    a run tuned to 3.0 for heterogeneous input shards must not sprout
    offline verdicts the live detector rejected."""
    try:
        import yaml
        with open(os.path.join(run_dir, "resolved_config.yaml")) as f:
            v = (yaml.safe_load(f) or {}).get(
                "train", {}).get("straggler_threshold")
        return float(v) if isinstance(v, (int, float)) else None
    except Exception:  # noqa: BLE001 — a foreign/partial run dir
        # still gets a report, on the default threshold.
        return None


def aggregate_run(run_dir: str, threshold: float | None = None) -> dict:
    """The merged multi-host summary (JSON-stable; render with
    ``render_multihost``). ``threshold`` defaults to the run's own
    configured ``train.straggler_threshold`` (resolved_config.yaml),
    then 1.5."""
    if threshold is None:
        threshold = _configured_threshold(run_dir)
    if threshold is None:
        threshold = 1.5
    streams = load_host_streams(run_dir)
    offsets = clock_offsets(streams)
    merged = merge_streams(streams, offsets)
    skew = skew_report(streams)
    # Offline straggler pass: same rule as the runtime detector, over
    # whole-run per-host means.
    offline = flag_stragglers(
        {h: {"step": d.get("step"), "data_wait": d.get("data_wait")}
         for h, d in skew["per_host"].items()},
        threshold=threshold)
    # Runtime verdicts: every host computes identical summaries from
    # the same all-gathered table, so the last event seen is THE
    # latest cross-host state.
    runtime_events = [e for e in merged if e.get("kind") == "straggler"]
    # The collectives audit (coordinator-emitted: the same step on every
    # host).
    coll = next((e for e in merged if e.get("kind") == "collectives"),
                None)
    if coll is not None:
        coll = collectives_lib.summary_of_event(coll)
    postmortems = {}
    for h, d in host_dirs(run_dir).items():
        pm = os.path.join(d, "postmortem")
        if os.path.isdir(pm) and os.listdir(pm):
            postmortems[str(h)] = sorted(os.listdir(pm))
    return {
        "schema": SCHEMA,
        "run_dir": run_dir,
        "multihost": True,
        "hosts": sorted(streams),
        "event_rows": len(merged),
        "clock_offsets_s": {str(h): round(o, 6)
                            for h, o in offsets.items()},
        "loss": _loss_stats(
            load_jsonl(os.path.join(run_dir, "metrics.jsonl"))),
        "goodput_by_host": {str(h): goodput_of_stream(evs)
                            for h, evs in streams.items()},
        "skew": skew,
        "stragglers": {
            "offline": offline,
            "threshold": threshold,
            "runtime_exchanges": len(runtime_events),
            "runtime_last": (runtime_events[-1]
                             if runtime_events else None),
        },
        "collectives": coll,
        # Step-time attribution (coordinator-emitted, telemetry/
        # attribution.py): the measured capture + the static schedule
        # audit. Additive keys — SCHEMA stays 1 (pinned by test).
        "attribution": _attribution(merged),
        "attribution_static": _attribution_static(merged),
        # Recovery/elastic accounting from the COORDINATOR's stream:
        # every host appends its own run_start/resume per incarnation,
        # so segmenting the merged timeline would count one restart N
        # times. Host 0 always exists (process indices refill after an
        # elastic shrink) and tells the one canonical story. Additive
        # key — SCHEMA stays 1 (pinned by test).
        "recovery": _recovery(
            min(streams.items())[1] if streams else []),
        "watchdog_firings": [e for e in merged
                             if e.get("kind") == "watchdog_fired"],
        "postmortems": postmortems,
    }


def render_multihost(summary: dict) -> str:
    """Human-readable merged report (the --json flag skips this)."""
    hosts = summary["hosts"]
    lines = [f"multi-host run: {summary['run_dir']}   "
             f"hosts: {len(hosts)}   "
             f"merged events: {summary['event_rows']}"]
    offs = summary.get("clock_offsets_s") or {}
    if any(offs.values()):
        lines.append("clock offsets vs median host: " + "  ".join(
            f"host{h} {offs[str(h)]:+.3f}s" for h in hosts))
    loss = summary.get("loss")
    if loss:
        lines.append(
            f"loss: {loss['first']:.6g} -> {loss['last']:.6g} "
            f"(min {loss['min']:.6g}) over steps "
            f"{loss['first_step']}..{loss['last_step']}")
    lines.append("goodput by host:")
    for h in hosts:
        gp = (summary.get("goodput_by_host") or {}).get(str(h))
        if not gp:
            lines.append(f"  host {h}: no goodput data")
            continue
        tag = " (reconstructed)" if gp.get("reconstructed") else ""
        buckets = "  ".join(f"{k} {v:.2f}s"
                            for k, v in gp["buckets"].items() if v)
        lines.append(f"  host {h}: {gp['goodput']:.1%} of "
                     f"{gp['wall_s']:.1f}s wall, {gp['steps']} "
                     f"steps{tag}   [{buckets}]")
    skew = summary.get("skew") or {}
    per_host = skew.get("per_host") or {}
    if per_host:
        lines.append("skew (per-host means):")
        for h in hosts:
            d = per_host.get(h, per_host.get(str(h), {}))
            step = d.get("step")
            wait = d.get("data_wait")
            lines.append(
                f"  host {h}: step "
                f"{step * 1e3:.1f}ms" if step is not None else
                f"  host {h}: step -")
            if wait is not None:
                lines[-1] += (f"   data_wait {wait * 1e3:.1f}ms "
                              f"(total {d['data_wait_total_s']:.2f}s)")
            if d.get("checkpoint_total_s"):
                lines[-1] += f"   ckpt {d['checkpoint_total_s']:.2f}s"
        spread = skew.get("step_spread")
        if spread:
            w = spread["worst"]
            lines.append(
                f"  step spread over {skew['steps_compared']} common "
                f"steps: mean {spread['mean_s'] * 1e3:.1f}ms  max "
                f"{spread['max_s'] * 1e3:.1f}ms (step {w['step']}, "
                f"host {w['slowest_host']}); slowest most often: "
                f"host {spread['worst_host']}")
        if skew.get("ckpt_barrier_spread_s"):
            lines.append(f"  checkpoint barrier spread: "
                         f"{skew['ckpt_barrier_spread_s']:.2f}s")
    sv = summary.get("stragglers") or {}
    for v in sv.get("offline") or []:
        lines.append(f"STRAGGLER (offline): {v['text']}")
    last = sv.get("runtime_last")
    if last:
        for text in last.get("persistent", []):
            lines.append(f"STRAGGLER (runtime): {text}")
        if not last.get("persistent"):
            lines.append(
                f"straggler exchanges: {sv['runtime_exchanges']} "
                "(no persistent verdicts)")
    coll = summary.get("collectives")
    if coll:
        lines.extend(collectives_lib.render_lines(coll))
    lines.extend(render_attribution_lines(
        summary.get("attribution"), summary.get("attribution_static")))
    rec = summary.get("recovery")
    if rec:
        lines.extend(render_recovery_lines(rec))
    for w in summary.get("watchdog_firings", []):
        lines.append(f"WATCHDOG FIRED on host {w.get('host', '?')}: "
                     f"{w.get('postmortem')}")
    for h, bundles in (summary.get("postmortems") or {}).items():
        for b in bundles:
            lines.append(f"postmortem bundle: host_{h}/postmortem/{b}")
    return "\n".join(lines)
