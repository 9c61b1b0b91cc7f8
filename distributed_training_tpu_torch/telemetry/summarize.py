"""Run summarizer: render a run_dir's jsonl streams as one report (port
of ``telemetry/summarize.py``, which is framework-free; this is the
port's own copy, reading the same streams).

    python -m distributed_training_tpu_torch.telemetry <run_dir> [--json]
        [--doctor] [--serving-report]

Reads ``metrics.jsonl`` (loss/throughput/MFU trajectory, written by
utils/metrics.py) and ``events.jsonl`` (spans, goodput windows, hbm
samples, watchdog firings — written by this package) and prints the
answers a post-run triage actually asks: did the loss move, where did
the wall-clock go, how close to the HBM ceiling did it run, and did
anything hang. Works on partial streams (a crashed run's artifacts are
exactly when this gets used), and lists any ``postmortem/`` bundles it
finds. A JAX run's ``collectives`` event is carried into the JSON summary
but not rendered: the port's own collectives audit is ROADMAP.md queue A
item 17's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from distributed_training_tpu_torch.telemetry.goodput import (
    goodput_of_stream)


def load_jsonl(path: str) -> list[dict]:
    """Tolerant jsonl reader: skips torn/corrupt lines (a crashed
    writer's last line is often half-flushed)."""
    rows: list[dict] = []
    if not os.path.exists(path):
        return rows
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                rows.append(rec)
    return rows


def _loss_stats(rows: list[dict]) -> dict | None:
    pts = [(r["step"], r["loss"]) for r in rows
           if isinstance(r.get("loss"), (int, float))
           and isinstance(r.get("step"), int)]
    if not pts:
        return None
    losses = [v for _, v in pts]
    return {"first": losses[0], "last": losses[-1],
            "min": min(losses), "points": len(pts),
            "first_step": pts[0][0], "last_step": pts[-1][0]}


def _trajectory(rows: list[dict], key: str) -> dict | None:
    vals = [r[key] for r in rows
            if isinstance(r.get(key), (int, float))
            and not r.get("warmup")]
    if not vals:
        return None
    return {"first": vals[0], "last": vals[-1], "max": max(vals)}


def _goodput(events: list[dict]) -> dict | None:
    """Run-scope ledger report, or span reconstruction for killed
    runs — shared with the multi-host aggregator (goodput.py)."""
    return goodput_of_stream(events)


# The summary keys of the JAX trainer's ``collectives`` event (its
# telemetry/collectives.py schema).
COLLECTIVES_KEYS = ("schema", "total_collectives", "bytes_per_step",
                    "by_kind", "by_axis", "mesh", "spmd_reshard_warnings",
                    "sharding_plan")


def _collectives(events: list[dict]) -> dict | None:
    """Latest static collective-traffic audit (a JAX run's
    ``collectives`` event)."""
    rows = [e for e in events if e.get("kind") == "collectives"]
    if not rows:
        return None
    return {k: rows[-1][k] for k in COLLECTIVES_KEYS if k in rows[-1]}


def _attribution(events: list[dict]) -> dict | None:
    """Latest in-run step-time attribution (trainer-emitted
    ``attribution`` event, telemetry/attribution.py schema)."""
    rows = [e for e in events if e.get("kind") == "attribution"]
    if not rows:
        return None
    from distributed_training_tpu_torch.telemetry.attribution import (
        summary_of_event)
    return summary_of_event(rows[-1])


def _attribution_static(events: list[dict]) -> dict | None:
    """Latest compiled-schedule overlap audit (``attribution_static``
    event — one-shot after first compile)."""
    rows = [e for e in events
            if e.get("kind") == "attribution_static"]
    if not rows:
        return None
    from distributed_training_tpu_torch.telemetry.attribution import (
        STATIC_SUMMARY_KEYS, summary_of_event)
    return summary_of_event(rows[-1], keys=STATIC_SUMMARY_KEYS)


def render_attribution_lines(att: dict | None,
                             static: dict | None) -> list[str]:
    """Attribution lines — shared by the single-run report and the
    multi-host aggregate so the two renderings cannot drift."""
    lines: list[str] = []
    if att and att.get("error"):
        lines.append(
            f"attribution (step {att.get('step')}): capture failed — "
            f"{att['error']}")
    elif att:
        lines.append(
            f"attribution (step {att.get('step')}, "
            f"{att.get('steps_captured')} step(s), "
            f"{att.get('source')} timeline): "
            f"compute {att.get('compute_frac', 0):.1%} / "
            f"collective {att.get('collective_frac', 0):.1%} / "
            f"host+data {att.get('host_frac', 0):.1%}; "
            f"overlap {att.get('overlap_frac', 0):.1%} of collective "
            f"time hidden")
        if att.get("trace_dir"):
            lines.append(f"  trace: {att['trace_dir']}")
    if static and static.get("scored"):
        line = (
            f"static overlap (compiled schedule): "
            f"{static['overlap_score']:.2f} of {static['scored']} "
            f"collective(s) scheduled with independent compute "
            f"(mean {static.get('mean_compute_between', 0):.1f} "
            f"op(s))")
        if isinstance(static.get("expected_comms_s"), (int, float)):
            line += (f"; roofline expects comms "
                     f"{static['expected_comms_s'] * 1e3:.3f}ms vs "
                     f"compute "
                     f"{static.get('expected_compute_s', 0) * 1e3:.3f}"
                     "ms/step")
        lines.append(line)
    return lines


def _hbm(events: list[dict]) -> dict | None:
    """Per-device high-water marks over all hbm samples."""
    peak: dict[int, int] = {}
    estimate = None
    samples = 0
    for e in events:
        if e.get("kind") != "hbm":
            continue
        samples += 1
        estimate = e.get("estimate_bytes", estimate)
        for d in e.get("devices", []):
            stats = d.get("stats") or {}
            v = stats.get("peak_bytes_in_use",
                          stats.get("bytes_in_use"))
            if isinstance(v, int):
                peak[d.get("id", -1)] = max(
                    peak.get(d.get("id", -1), 0), v)
    if not samples:
        return None
    out: dict = {"samples": samples}
    if peak:
        out["peak_bytes_by_device"] = peak
        out["peak_gib"] = round(max(peak.values()) / 1024 ** 3, 3)
    if estimate:
        out["estimate_bytes"] = estimate
    return out


def _segment_world(seg: dict) -> int | None:
    """World size a segment ran at: the resume event's ``world_size``
    (elastic-aware incarnations) or the segment's ``clock_sync``
    ``process_count`` (every incarnation emits one at setup)."""
    resume = seg.get("resume") or {}
    if isinstance(resume.get("world_size"), int):
        return resume["world_size"]
    if isinstance(seg.get("process_count"), int):
        return seg["process_count"]
    return None


def _recovery(events: list[dict]) -> dict | None:
    """Recovery table (docs/robustness.md): every restart appends a
    new ``run_start`` marker to the same stream, so incidents are the
    segment boundaries — time-to-recover is the gap between a
    segment's last record and the next ``run_start``, and steps lost
    is the crashed segment's high-water step minus the step the next
    incarnation resumed from. Quarantines, injected faults, data
    retries, and elastic world resizes (an incarnation resuming at a
    different world size than its predecessor ran at) ride along.
    None when the run had nothing to recover from (the common case —
    the section stays out of the report)."""
    segments: list[dict] = []
    for e in events:
        t = e.get("t")
        if e.get("kind") == "run_start" or not segments:
            segments.append({"t_start": t, "t_last": t,
                             "start_step": e.get("step"),
                             "max_step": None, "resume": None,
                             "process_count": None})
        seg = segments[-1]
        if isinstance(t, (int, float)):
            seg["t_last"] = max(seg["t_last"] or t, t)
        if e.get("kind") == "resume" and seg["resume"] is None:
            seg["resume"] = e
        if (e.get("kind") == "clock_sync"
                and seg["process_count"] is None):
            seg["process_count"] = e.get("process_count")
        step = e.get("step")
        if isinstance(step, int):
            seg["max_step"] = max(seg["max_step"] or 0, step)
    incidents = []
    for prev, cur in zip(segments, segments[1:]):
        if cur["resume"] is None:
            # A later session appended to the stream without resuming
            # training (e.g. an offline eval, PR2 semantics) is not a
            # recovery incident.
            continue
        resume_step = cur["resume"].get("step", cur["start_step"])
        lost = None
        if (isinstance(prev["max_step"], int)
                and isinstance(resume_step, int)):
            lost = max(0, prev["max_step"] - resume_step)
        gap = None
        if (isinstance(prev["t_last"], (int, float))
                and isinstance(cur["t_start"], (int, float))):
            gap = round(max(0.0, cur["t_start"] - prev["t_last"]), 3)
        incident = {
            "resumed_at_step": resume_step,
            "prev_max_step": prev["max_step"],
            "steps_lost": lost,
            "time_to_recover_s": gap,
            "restarts": (cur["resume"] or {}).get("restarts"),
        }
        # Exactly-once columns (docs/data.md): the resume event
        # carries the restored pipeline cursor; relative to the
        # restored optimizer step, every divergence is either a
        # replay (cursor behind step * global_batch — the optimizer
        # will re-consume samples it already saw) or a skip (cursor
        # ahead). Both must be 0 for a loader whose state rides the
        # checkpoint; the legacy epoch-replay resume shows its replay
        # count here honestly. Additive keys — consumers of the old
        # incident shape are unaffected.
        cursor = cur["resume"].get("samples_consumed")
        gb = cur["resume"].get("global_batch")
        if (isinstance(cursor, int) and isinstance(gb, int)
                and isinstance(resume_step, int)):
            expected = resume_step * gb
            incident["samples_replayed"] = max(0, expected - cursor)
            incident["samples_skipped"] = max(0, cursor - expected)
        realized = cur["resume"].get("realized_mixture")
        target = cur["resume"].get("target_mixture")
        if isinstance(realized, dict) and isinstance(target, dict):
            incident["mixture_drift"] = round(max(
                (abs(float(realized.get(k, 0.0))
                     - float(target.get(k, 0.0)))
                 for k in set(realized) | set(target)),
                default=0.0), 6)
        old_w, new_w = _segment_world(prev), _segment_world(cur)
        if (isinstance(old_w, int) and isinstance(new_w, int)
                and old_w != new_w):
            # An elastic resize: the incarnation re-formed at a
            # different world size (shrink on host loss/eviction,
            # grow-back at a checkpoint boundary).
            incident["old_world"] = old_w
            incident["new_world"] = new_w
            evicted = (cur["resume"] or {}).get("evicted_hosts")
            if evicted:
                incident["evicted_hosts"] = evicted
        incidents.append(incident)
    quarantined = [e for e in events
                   if e.get("kind") == "ckpt_quarantined"]
    faults = [e for e in events if e.get("kind") == "fault_injected"]
    retries = [e for e in events if e.get("kind") == "data_retry"]
    evictions = [e for e in events
                 if e.get("kind") == "eviction_request"]
    # Deliberate skip-and-record corrupt-sample skips (data/stream.py
    # ``data_skip`` events) — distinct from the incident-level
    # samples_skipped column, which measures RESUME skips.
    skips = [e for e in events if e.get("kind") == "data_skip"]
    elastic = [i for i in incidents if "new_world" in i]
    if not incidents and not quarantined and not faults \
            and not retries and not evictions and not skips:
        return None
    return {
        "restarts": len(incidents),
        "incidents": incidents,
        "elastic": elastic,
        "quarantined": [{"step": e.get("step"), "path": e.get("path")}
                        for e in quarantined],
        "faults_injected": [e.get("fault") for e in faults],
        "eviction_requests": [
            {"host": e.get("host"), "step": e.get("step"),
             "metric": e.get("metric"), "ratio": e.get("ratio")}
            for e in evictions],
        "data_retries": len(retries),
        "data_skips": [
            {"source": e.get("source"), "sample_id": e.get("sample_id"),
             "step": e.get("step")} for e in skips],
    }


def _serving(events: list[dict],
             slo: tuple[float, float] | None = None) -> dict | None:
    """Per-tenant serving SLO ledger reconstructed from the
    ``serving_trace`` stream (telemetry/serving_trace.py — the same
    analyzer bench_serving.py ledgers with, so the report and
    SERVING_rNN.json cannot disagree). None when the run served
    nothing."""
    from distributed_training_tpu_torch.telemetry.serving_trace import (
        analyze_traces, slo_deadlines_from_conf)
    ttft_s, per_token_s = slo if slo is not None \
        else slo_deadlines_from_conf()
    return analyze_traces(events, ttft_deadline_s=ttft_s,
                          per_token_deadline_s=per_token_s)


def _spans(events: list[dict]) -> dict:
    agg: dict[str, dict] = {}
    for e in events:
        if e.get("kind") != "span":
            continue
        a = agg.setdefault(e.get("name", "?"),
                           {"count": 0, "total_s": 0.0, "max_s": 0.0})
        dur = e.get("dur_s") or 0.0
        a["count"] += 1
        a["total_s"] = round(a["total_s"] + dur, 4)
        a["max_s"] = round(max(a["max_s"], dur), 4)
    return agg


def summarize_run(run_dir: str) -> dict:
    metrics = load_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    events = load_jsonl(os.path.join(run_dir, "events.jsonl"))
    pm_dir = os.path.join(run_dir, "postmortem")
    postmortems = (sorted(os.listdir(pm_dir))
                   if os.path.isdir(pm_dir) else [])
    summary: dict = {
        "run_dir": run_dir,
        "metrics_rows": len(metrics),
        "event_rows": len(events),
        "loss": _loss_stats(metrics),
        "samples_per_sec_per_chip": _trajectory(
            metrics, "samples_per_sec_per_chip"),
        "mfu": _trajectory(metrics, "mfu"),
        "goodput": _goodput(events),
        "hbm": _hbm(events),
        "collectives": _collectives(events),
        "attribution": _attribution(events),
        "attribution_static": _attribution_static(events),
        "recovery": _recovery(events),
        "serving": _serving(events),
        "spans": _spans(events),
        "watchdog_firings": [e for e in events
                             if e.get("kind") == "watchdog_fired"],
        "postmortems": postmortems,
    }
    return summary


def render_recovery_lines(rec: dict) -> list[str]:
    """Recovery-table lines — shared by the single-host report and the
    multi-host aggregate so the two renderings cannot drift. Elastic
    incidents (world resizes) annotate their incident line with the
    old→new world size; eviction requests get their own lines."""
    skips = rec.get("data_skips") or []
    lines = [
        f"recovery: {rec['restarts']} restart(s), "
        f"{len(rec['quarantined'])} checkpoint(s) quarantined, "
        f"{rec['data_retries']} data retr"
        f"{'y' if rec['data_retries'] == 1 else 'ies'}"
        + (f", {len(rec['elastic'])} elastic resize(s)"
           if rec.get("elastic") else "")
        + (f", {len(skips)} corrupt sample(s) skipped"
           if skips else "")]
    for i, inc in enumerate(rec["incidents"]):
        ttr = inc.get("time_to_recover_s")
        lost = inc.get("steps_lost")
        line = (
            f"  incident {i}: resumed at step "
            f"{inc.get('resumed_at_step')}"
            + (f" ({lost} step(s) lost)" if lost is not None else "")
            + (f", recovered in {ttr:.1f}s" if ttr is not None
               else ""))
        if "samples_replayed" in inc:
            # The exactly-once proof line: a loader whose state rides
            # the checkpoint reports 0 / 0 here.
            line += (f", {inc['samples_replayed']} sample(s) replayed"
                     f" / {inc.get('samples_skipped', 0)} skipped")
        if inc.get("mixture_drift") is not None:
            line += f", mixture drift {inc['mixture_drift']:.4f}"
        if "new_world" in inc:
            line += (f", world {inc.get('old_world')} -> "
                     f"{inc['new_world']}")
            if inc.get("evicted_hosts"):
                line += (" (evicted host(s) "
                         + ",".join(map(str, inc["evicted_hosts"]))
                         + ")")
        lines.append(line)
    for ev in rec.get("eviction_requests", []):
        lines.append(
            f"  EVICTION REQUESTED: host {ev.get('host')} at step "
            f"{ev.get('step')} ({ev.get('ratio')}x median on "
            f"{ev.get('metric')})")
    for q in rec["quarantined"]:
        lines.append(f"  QUARANTINED step {q.get('step')}: "
                     f"{q.get('path')}")
    for s in skips:
        lines.append(
            f"  SKIPPED corrupt sample {s.get('source')}"
            f"[{s.get('sample_id')}] at step {s.get('step')}")
    if rec["faults_injected"]:
        lines.append("  faults injected: "
                     + ", ".join(map(str, rec["faults_injected"])))
    return lines


def render(summary: dict) -> str:
    """Human-readable report (the --json flag skips this)."""
    lines = [f"run: {summary['run_dir']}",
             f"  metrics rows: {summary['metrics_rows']}   "
             f"event rows: {summary['event_rows']}"]
    loss = summary.get("loss")
    if loss:
        lines.append(
            f"loss: {loss['first']:.6g} -> {loss['last']:.6g} "
            f"(min {loss['min']:.6g}) over steps "
            f"{loss['first_step']}..{loss['last_step']}")
    for key, label in (("samples_per_sec_per_chip",
                        "samples/s/chip"), ("mfu", "mfu")):
        t = summary.get(key)
        if t:
            lines.append(f"{label}: first {t['first']:.4g}  "
                         f"last {t['last']:.4g}  max {t['max']:.4g}")
    gp = summary.get("goodput")
    if gp:
        tag = " (reconstructed from spans)" if gp.get(
            "reconstructed") else ""
        lines.append(f"goodput: {gp['goodput']:.1%} of "
                     f"{gp['wall_s']:.1f}s wall, {gp['steps']} "
                     f"steps{tag}")
        width = max(len(k) for k in gp["buckets"])
        for k, v in gp["buckets"].items():
            pct = v / gp["wall_s"] if gp["wall_s"] else 0.0
            lines.append(f"  {k.ljust(width)}  {v:9.3f}s  {pct:6.1%}")
        for k in ("mfu_wall", "mfu_step"):
            if k in gp:
                lines.append(f"  {k}: {gp[k]:.4f}")
    hbm = summary.get("hbm")
    if hbm:
        line = f"hbm: {hbm['samples']} samples"
        if "peak_gib" in hbm:
            line += f", peak {hbm['peak_gib']} GiB"
        if "estimate_bytes" in hbm:
            line += (f" (state estimate "
                     f"{hbm['estimate_bytes'] / 1024 ** 3:.3f} GiB)")
        lines.append(line)
    spans = summary.get("spans") or {}
    # Step-time attribution next to MFU: where the measured step went
    # (compute / exposed collective / host+data, overlap hidden) and
    # what the compiled schedule statically promises.
    lines.extend(render_attribution_lines(
        summary.get("attribution"), summary.get("attribution_static")))
    if spans:
        lines.append("spans (count / total / max):")
        for name in sorted(spans, key=lambda n: -spans[n]["total_s"]):
            a = spans[name]
            lines.append(f"  {name:14s} {a['count']:5d}  "
                         f"{a['total_s']:9.3f}s  {a['max_s']:8.3f}s")
    rec = summary.get("recovery")
    if rec:
        lines.extend(render_recovery_lines(rec))
    srv = summary.get("serving")
    if srv:
        from distributed_training_tpu_torch.telemetry.serving_trace import (
            render_serving_lines)
        lines.extend(render_serving_lines(srv))
    for w in summary.get("watchdog_firings", []):
        lines.append(f"WATCHDOG FIRED: {w.get('postmortem')}")
    for p in summary.get("postmortems", []):
        lines.append(f"postmortem bundle: postmortem/{p}")
    if not summary["metrics_rows"] and not summary["event_rows"]:
        lines.append("no metrics.jsonl / events.jsonl rows found")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.telemetry",
        description="Summarize a run_dir's metrics/events streams "
                    "(multi-host run dirs with host_<i>/ subdirs get "
                    "the merged cross-host report)")
    p.add_argument("run_dir")
    p.add_argument("--json", action="store_true",
                   help="emit the summary as one JSON object")
    p.add_argument("--write-merged", default=None, metavar="PATH",
                   help="multi-host only: also write the merged, "
                        "clock-aligned event timeline as jsonl")
    p.add_argument("--doctor", action="store_true",
                   help="rule-based diagnosis of a run dir OR an "
                        "incident bundle: classify input-bound / "
                        "exposed-comms / compute-bound / straggler / "
                        "data-skip storm / preemption thrash / "
                        "serving SLO breach, citing the exact "
                        "events and attribution fractions")
    p.add_argument("--serving-report", action="store_true",
                   help="print ONLY the serving SLO ledger "
                        "reconstructed from serving_trace records "
                        "(per-tenant p50/p95/p99 TTFT/e2e, SLO "
                        "attainment, preemption retry cost)")
    p.add_argument("--slo-ttft-s", type=float, default=None,
                   help="TTFT deadline for --serving-report "
                        "(default: conf/serving/default.yaml slo:)")
    p.add_argument("--slo-per-token-s", type=float, default=None,
                   help="per-token decode deadline for "
                        "--serving-report (default: conf/serving/"
                        "default.yaml slo:)")
    args = p.parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"not a directory: {args.run_dir}", file=sys.stderr)
        return 2
    if args.doctor:
        from distributed_training_tpu_torch.telemetry.doctor import (
            diagnose_path, render_doctor)
        slo = None
        if (args.slo_ttft_s is not None
                and args.slo_per_token_s is not None):
            slo = (args.slo_ttft_s, args.slo_per_token_s)
        report = diagnose_path(args.run_dir, slo=slo)
        if args.json:
            print(json.dumps(report))
        else:
            print(render_doctor(report))
        return 0
    if args.serving_report:
        from distributed_training_tpu_torch.telemetry.serving_trace import (
            render_serving_lines, slo_deadlines_from_conf)
        ttft_s, per_token_s = slo_deadlines_from_conf()
        if args.slo_ttft_s is not None:
            ttft_s = args.slo_ttft_s
        if args.slo_per_token_s is not None:
            per_token_s = args.slo_per_token_s
        # serving_trace records are self-contained (span times are
        # arrival-relative), so multi-host dirs just concatenate —
        # no clock alignment needed.
        events = load_jsonl(os.path.join(args.run_dir,
                                         "events.jsonl"))
        for name in sorted(os.listdir(args.run_dir)):
            sub = os.path.join(args.run_dir, name, "events.jsonl")
            if name.startswith("host_") and os.path.exists(sub):
                events.extend(load_jsonl(sub))
        rep = _serving(events, slo=(ttft_s, per_token_s))
        if rep is None:
            print("no serving_trace records in "
                  f"{args.run_dir}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(rep))
        else:
            print("\n".join(render_serving_lines(rep)))
        return 0
    from distributed_training_tpu_torch.telemetry import aggregate
    if aggregate.is_multihost_run_dir(args.run_dir):
        summary = aggregate.aggregate_run(args.run_dir)
        if args.write_merged:
            aggregate.write_merged(args.run_dir, args.write_merged)
        if args.json:
            print(json.dumps(summary))
        else:
            print(aggregate.render_multihost(summary))
        return 0
    summary = summarize_run(args.run_dir)
    if args.json:
        print(json.dumps(summary))
    else:
        print(render(summary))
    return 0
