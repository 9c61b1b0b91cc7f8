"""Offline run doctor: rule-based classification of what went wrong.

The port of ``telemetry/doctor.py``, which is framework-free; this is the
port's own copy, so a run dir of either package reads the same.

    python -m distributed_training_tpu_torch.telemetry <path> --doctor

``<path>`` is either a run dir (events.jsonl, plus host_<i>/ streams
on multi-host runs) or one incident bundle (telemetry/incident.py —
``meta.json`` + ``events_tail.jsonl``, with ``anomaly.json`` /
``attribution.json`` when the recorder had them). The doctor folds
the same derived sections the summarizer computes (attribution,
recovery, goodput, serving SLO ledger) together with the online
detector's ``anomaly`` events and classifies the run into one of:

    serving_engine_crash | preemption_thrash | data_skip_storm |
    straggler | serving_slo_breach | input_bound | exposed_comms |
    compute_bound

Every verdict cites its evidence — the exact anomaly events (value vs
baseline in MADs), the attribution fractions, the recovery table rows
— and the evidence lines are rendered by the SAME functions the
summarizer uses (``render_attribution_lines``,
``render_recovery_lines``), so online and offline verdicts cannot
drift. Rules are ordered: the first matching rule is THE verdict, all
other matches are reported as secondary findings, and
``compute_bound`` is the healthy fallback (nothing pathological
matched, compute dominates by construction).
"""

from __future__ import annotations

import json
import os

SCHEMA = 1

# Priority-ordered rule ids (first match wins the verdict).
RULES = ("serving_engine_crash", "preemption_thrash",
         "data_skip_storm", "straggler", "serving_slo_breach",
         "input_bound", "exposed_comms", "compute_bound")

# Rule thresholds — module constants so tests pin them and the doc
# table in docs/observability.md can cite them.
THRASH_RESTARTS = 3
SKIP_STORM_MIN = 5
SLO_ATTAINED_MIN = 0.95
DATA_WAIT_FRAC = 0.15
HOST_FRAC = 0.40
EXPOSED_COLLECTIVE_FRAC = 0.30


def _anomaly_lines(anoms: list[dict], signal: str,
                   limit: int = 3) -> list[str]:
    """Evidence lines citing the exact online-detector events."""
    rows = [a for a in anoms if a.get("signal") == signal]
    out = []
    for a in rows[:limit]:
        if a.get("detail"):
            out.append(f"  anomaly at step {a.get('step')}: {signal} "
                       f"— {a['detail']}")
        else:
            out.append(
                f"  anomaly at step {a.get('step')}: {signal} "
                f"{a.get('value'):.4g} vs median "
                f"{a.get('median'):.4g} "
                f"({a.get('deviation')} MADs, window "
                f"{a.get('window')})")
    if len(rows) > limit:
        out.append(f"  ... and {len(rows) - limit} more {signal} "
                   f"anomalies")
    return out


def load_target(path: str) -> dict:
    """Resolve ``path`` into {source, events, anomaly, meta}.

    An incident bundle contributes its events tail, its recorded
    anomaly verdict and its cached attribution; a run dir contributes
    the full event stream (host_<i>/ streams concatenated on
    multi-host layouts) and any on-disk bundles' names."""
    from distributed_training_tpu_torch.telemetry.incident import (
        is_incident_bundle)
    from distributed_training_tpu_torch.telemetry.summarize import \
        load_jsonl
    if is_incident_bundle(path):
        meta, anomaly, attribution = {}, None, None
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass
        for name, slot in (("anomaly.json", "anomaly"),
                           ("attribution.json", "attribution")):
            fp = os.path.join(path, name)
            if os.path.exists(fp):
                try:
                    with open(fp) as f:
                        if slot == "anomaly":
                            anomaly = json.load(f)
                        else:
                            attribution = json.load(f)
                except (OSError, ValueError):
                    pass
        events = load_jsonl(os.path.join(path, "events_tail.jsonl"))
        if attribution is not None and not any(
                e.get("kind") == "attribution" for e in events):
            events.append(attribution)
        return {"source": "bundle", "path": path, "meta": meta,
                "events": events, "anomaly": anomaly, "bundles": []}
    events = load_jsonl(os.path.join(path, "events.jsonl"))
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            sub = os.path.join(path, name, "events.jsonl")
            if name.startswith("host_") and os.path.exists(sub):
                events.extend(load_jsonl(sub))
    bundles = []
    for sub in ("incidents", "postmortem"):
        d = os.path.join(path, sub)
        if os.path.isdir(d):
            bundles += [f"{sub}/{n}" for n in sorted(os.listdir(d))
                        if os.path.isdir(os.path.join(d, n))]
    return {"source": "run_dir", "path": path, "meta": {},
            "events": events, "anomaly": None, "bundles": bundles}


def diagnose(events: list[dict], anomaly: dict | None = None,
             slo: tuple[float, float] | None = None,
             incident: dict | None = None) -> dict:
    """Classify one event stream. Returns the report dict:
    ``verdict`` (a RULES member), ``findings`` (every matched rule,
    verdict first, each with its evidence lines), and the per-signal
    anomaly counts."""
    from distributed_training_tpu_torch.telemetry.summarize import (
        _attribution, _attribution_static, _goodput, _recovery,
        _serving, render_attribution_lines, render_recovery_lines)
    anoms = [e for e in events if e.get("kind") == "anomaly"]
    counts: dict[str, int] = {}
    for a in anoms:
        sig = a.get("signal") or "?"
        counts[sig] = counts.get(sig, 0) + 1
    if anomaly:  # a bundle's recorded verdict extends the tail's view
        for sig, n in (anomaly.get("anomalies_total") or {}).items():
            counts[sig] = max(counts.get(sig, 0), n)
    att = _attribution(events)
    static = _attribution_static(events)
    rec = _recovery(events)
    gp = _goodput(events)
    try:
        srv = _serving(events, slo=slo)
    except Exception:  # noqa: BLE001 — serving conf may be absent in
        # a stripped bundle; the serving rule simply cannot match.
        srv = None
    faults = [str(f) for f in (rec or {}).get("faults_injected", [])]
    att_lines = ["  " + ln for ln in
                 render_attribution_lines(att, static)]

    findings: list[dict] = []

    def add(rule: str, summary: str, evidence: list[str]) -> None:
        findings.append({"rule": rule, "summary": summary,
                         "evidence": evidence})

    # 0. serving engine crash: the engine thread died (or the serving
    # supervisor salvaged/gave up). Matched from the crash events the
    # supervisor/server emit BEFORE writing their bundle — so a
    # bundle's events_tail always carries the evidence — plus the
    # bundle's own meta kind for stripped tails.
    crashes = [e for e in events
               if e.get("kind") == "serving_engine_crash"]
    give_ups = [e for e in events
                if e.get("kind") == "supervisor_give_up"
                and e.get("scope") == "serving"]
    bundle_says_crash = (incident or {}).get("kind") == "engine_crash"
    if crashes or give_ups or bundle_says_crash:
        ev = []
        for c in crashes[-3:]:
            ev.append(
                f"  engine crash (incarnation "
                f"{c.get('incarnation', '?')}, launch "
                f"{c.get('launches', c.get('launch_count', '?'))}): "
                f"{c.get('error', '?')}")
            if c.get("weights_version") is not None:
                ev.append(f"    weights_version "
                          f"{c['weights_version']}, kv_salvaged "
                          f"{c.get('kv_salvaged', 0)}, resubmitted "
                          f"{c.get('resubmitted', 0)}")
        crash_faults = [f for f in faults
                        if f.startswith(("engine_crash",
                                         "swap_corrupt"))]
        if crash_faults:
            ev.append(f"  injected fault(s): "
                      f"{', '.join(crash_faults)}")
        if give_ups:
            ev.append(f"  supervisor GAVE UP after "
                      f"{give_ups[-1].get('incarnations', '?')} "
                      f"incarnation(s)")
        if bundle_says_crash and not crashes:
            ev.append("  bundle meta: kind=engine_crash (events "
                      "tail carries no crash record — stripped "
                      "tail)")
        summary = (f"serving engine crashed "
                   f"{max(len(crashes), 1)} time(s)")
        if give_ups:
            summary += "; supervisor gave up"
        elif crashes:
            summary += "; supervisor restarted it"
        add("serving_engine_crash", summary, ev)

    # 1. preemption thrash: the run spent its life restarting.
    if rec and rec.get("restarts", 0) >= THRASH_RESTARTS:
        lost = sum(i.get("steps_lost") or 0
                   for i in rec["incidents"])
        add("preemption_thrash",
            f"{rec['restarts']} restarts (>= {THRASH_RESTARTS}), "
            f"{lost} step(s) lost across incidents",
            ["  " + ln for ln in render_recovery_lines(rec)])

    # 2. data-skip storm: the corpus is feeding corrupt samples.
    skips = (rec or {}).get("data_skips") or []
    if len(skips) >= SKIP_STORM_MIN:
        srcs = sorted({str(s.get("source")) for s in skips})
        add("data_skip_storm",
            f"{len(skips)} corrupt sample(s) skipped "
            f"(>= {SKIP_STORM_MIN}) from source(s) "
            f"{', '.join(srcs)}",
            ["  " + ln for ln in render_recovery_lines(rec)])

    # 3. straggler: one host is slow, the collective waits for it.
    straggler_ev: list[str] = []
    named = None
    persistent = [txt for e in events if e.get("kind") == "straggler"
                  for txt in (e.get("persistent") or [])]
    if persistent:
        straggler_ev += [f"  {t}" for t in persistent[-3:]]
        named = persistent[-1]
    for ev in (rec or {}).get("eviction_requests", []):
        named = (f"host {ev.get('host')} ({ev.get('ratio')}x median "
                 f"on {ev.get('metric')})")
        straggler_ev.append(
            f"  eviction requested: {named} at step "
            f"{ev.get('step')}")
    slow_faults = [f for f in faults if f.startswith("slow_host")]
    if slow_faults and counts.get("step_time", 0) >= 1:
        hosts = sorted({a.get("host") for a in anoms
                        if a.get("signal") == "step_time"
                        and a.get("host") is not None})
        if named is None:
            named = (f"host {hosts[0]}" if hosts
                     else f"fault {slow_faults[0]}")
        straggler_ev.append(
            f"  injected fault(s) {', '.join(slow_faults)} with "
            f"{counts['step_time']} step_time anomaly(ies)"
            + (f" on host(s) {', '.join(map(str, hosts))}"
               if hosts else ""))
        straggler_ev += _anomaly_lines(anoms, "step_time")
    if named is not None:
        add("straggler", f"slow host stalls the step: {named}",
            straggler_ev)

    # 4. serving SLO breach: requests finished, deadlines didn't.
    slo_rep = ((srv or {}).get("overall") or {}).get("slo") or {}
    attained = slo_rep.get("attained")
    if isinstance(attained, (int, float)) \
            and attained < SLO_ATTAINED_MIN:
        worst = min(
            ((name, ((t.get("slo") or {}).get("attained", 1.0)))
             for name, t in (srv.get("tenants") or {}).items()),
            key=lambda kv: kv[1], default=(None, None))
        ev = [f"  overall SLO attainment {attained:.1%} "
              f"(< {SLO_ATTAINED_MIN:.0%}) over "
              f"{slo_rep.get('met', 0) + slo_rep.get('missed', 0)} "
              f"finished request(s)"]
        if worst[0] is not None:
            ev.append(f"  worst tenant: {worst[0]} at "
                      f"{worst[1]:.1%} attained")
        ev += _anomaly_lines(anoms, "serving_ttft")
        ev += _anomaly_lines(anoms, "serving_queue_depth")
        add("serving_slo_breach",
            f"SLO attainment {attained:.1%} < "
            f"{SLO_ATTAINED_MIN:.0%}"
            + (f"; worst tenant {worst[0]}" if worst[0] else ""), ev)

    # 5. input-bound: the step waits on the data pipeline.
    dw_frac = None
    if gp and gp.get("wall_s"):
        dw_frac = (gp["buckets"].get("data_wait", 0.0)
                   / gp["wall_s"])
    host_frac = (att or {}).get("host_frac")
    data_faults = [f for f in faults
                   if f.startswith(("data_stall", "source_stall",
                                    "data_error"))]
    input_hit = (counts.get("data_wait", 0) >= 2
                 or (dw_frac is not None and dw_frac > DATA_WAIT_FRAC)
                 or (isinstance(host_frac, (int, float))
                     and host_frac > HOST_FRAC)
                 or (data_faults and counts.get("data_wait", 0) >= 1))
    if input_hit:
        ev = []
        if dw_frac is not None:
            ev.append(f"  goodput: data_wait "
                      f"{gp['buckets'].get('data_wait', 0.0):.3f}s "
                      f"= {dw_frac:.1%} of {gp['wall_s']:.1f}s wall")
        if isinstance(host_frac, (int, float)):
            ev += att_lines
        if data_faults:
            ev.append(f"  injected fault(s): "
                      f"{', '.join(data_faults)}")
        ev += _anomaly_lines(anoms, "data_wait")
        add("input_bound",
            "step time is dominated by waiting on input data"
            + (f" (data_wait {dw_frac:.1%} of wall)"
               if dw_frac is not None else ""), ev)

    # 6. exposed comms: collectives the schedule failed to hide.
    coll_frac = (att or {}).get("collective_frac")
    if isinstance(coll_frac, (int, float)) \
            and coll_frac > EXPOSED_COLLECTIVE_FRAC:
        add("exposed_comms",
            f"exposed collective time is {coll_frac:.1%} of the "
            f"step (> {EXPOSED_COLLECTIVE_FRAC:.0%}); overlap "
            f"{(att or {}).get('overlap_frac', 0):.1%}", att_lines)

    # 7. healthy fallback.
    if not findings:
        ev = list(att_lines)
        if gp and gp.get("wall_s"):
            ev.append(f"  goodput {gp['goodput']:.1%} over "
                      f"{gp['steps']} step(s)")
        if not ev:
            ev.append("  no pathological signal in the stream")
        add("compute_bound",
            "no pathological signal dominates; the run is spending "
            "its wall clock on compute", ev)

    order = {r: i for i, r in enumerate(RULES)}
    findings.sort(key=lambda f: order.get(f["rule"], len(RULES)))
    return {"schema": SCHEMA, "verdict": findings[0]["rule"],
            "findings": findings, "anomalies": counts,
            "event_rows": len(events)}


def diagnose_path(path: str,
                  slo: tuple[float, float] | None = None) -> dict:
    target = load_target(path)
    report = diagnose(target["events"], anomaly=target["anomaly"],
                      slo=slo, incident=target["meta"] or None)
    report["source"] = target["source"]
    report["path"] = path
    if target["meta"]:
        report["incident"] = {
            k: target["meta"].get(k)
            for k in ("kind", "reason", "time_unix")
            if target["meta"].get(k) is not None}
    if target["bundles"]:
        report["bundles"] = target["bundles"]
    return report


def render_doctor(report: dict) -> str:
    lines = [f"doctor: {report.get('path')} "
             f"({report.get('source', 'stream')}, "
             f"{report['event_rows']} event(s))"]
    inc = report.get("incident")
    if inc:
        lines.append(f"  incident bundle: kind={inc.get('kind')} — "
                     f"{inc.get('reason')}")
    lines.append(f"VERDICT: {report['verdict']} — "
                 f"{report['findings'][0]['summary']}")
    lines.extend(report["findings"][0]["evidence"])
    for f in report["findings"][1:]:
        lines.append(f"also matched: {f['rule']} — {f['summary']}")
        lines.extend(f["evidence"])
    if report.get("anomalies"):
        lines.append("anomalies observed: " + ", ".join(
            f"{k} x{v}" for k, v in
            sorted(report["anomalies"].items())))
    for b in report.get("bundles", []):
        lines.append(f"incident bundle on disk: {b}")
    return "\n".join(lines)
