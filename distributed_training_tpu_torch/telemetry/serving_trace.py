"""Serving request-lifecycle traces: schema + the offline analyzer (port
of ``distributed_training_tpu/telemetry/serving_trace.py``).

The engine's per-step ``serving`` records say what the engine did; the
``serving_trace`` record says what one request experienced. The engine
emits one through the ambient telemetry sink when a request finishes,
and when it is preempted (``Engine.preempt``, the staleness bound of a
weight swap, ``export_in_flight``), so lost work is visible instead of
silently re-run. ``analyze_traces`` turns a stream of them into the
per-tenant SLO ledger.

The trace is kept on the engine's host-side ``_Seq`` bookkeeping at
points the host already occupies (admission, the clock reads after each
``_fetch_host``): tracing adds no device sync, no kernel launch and no
CUDA-graph capture.

Record schema (additive; ``kind``/``t`` are the telemetry envelope's)::

    {"kind": "serving_trace",
     "id": str, "tenant": str,
     "outcome": "finished" | "preempted",
     "prompt_tokens": int, "new_tokens": int,
     "queue_wait_s": float | None,   # arrival -> admission
     "ttft_s": float | None,         # arrival -> first token
     "e2e_s": float,                 # arrival -> finish/preempt
     "prefix_hit_tokens": int,       # prompt tokens served from cache
     "tokens_discarded": int,        # preempt only (0 on finish)
     "spans": [{"ev": ..., "t": <seconds since arrival>, ...}, ...],
     "weights_versions": [[version, count], ...]}  # run-length list of
                                     # the weight version each emitted
                                     # token was produced under

Span events (``SPAN_EVENTS``): ``queued`` (t=0, the request's arrival),
``admitted`` (group/slot/prefix_hit_tokens), ``resumed`` (session
re-attach: group/slot/session/hit_tokens), ``adopted`` (KV handoff or
re-adoption: group/slot), ``prefill`` (one launch's chunk: tokens),
``decode`` (one launch or burst: emitted, plus budget on the multi-token
paths), ``session_retain`` (pages kept under the session key), and the
terminal ``finished``/``preempted`` (the latter with
``tokens_discarded``). Span times are relative to arrival, so the
offline math never depends on clock alignment across hosts.

``analyze_traces`` reconstructs per-tenant p50/p95/p99 TTFT and e2e
latency, queue wait, tokens/request, launch occupancy (tokens per
prefill launch, emitted per decode burst), preemption retry cost and
prefix-hit rates; ``slo_attainment`` scores each finished request
against a TTFT deadline and a per-token decode deadline, read from
``conf/serving/default.yaml``'s ``slo:`` block
(``slo_deadlines_from_conf``).
"""

from __future__ import annotations

# The per-request record's keys (the JAX module's) —
# additive only: the aggregate event schema stays at version 1, and
# consumers select by key, never by position.
TRACE_KEYS = (
    "id", "tenant", "outcome", "prompt_tokens", "new_tokens",
    "queue_wait_s", "ttft_s", "e2e_s", "prefix_hit_tokens",
    "tokens_discarded", "spans", "weights_versions",
)

SPAN_EVENTS = (
    "queued", "admitted", "resumed", "adopted", "prefill", "decode",
    "session_retain", "finished", "preempted",
)

OUTCOMES = ("finished", "preempted")

# Default SLO deadlines (seconds) — mirrored by conf/serving/
# default.yaml's ``slo:`` block (slo_deadlines_from_conf reads it, so
# the committed config is the single place deadlines live).
DEFAULT_TTFT_DEADLINE_S = 0.25
DEFAULT_PER_TOKEN_DEADLINE_S = 0.05


def percentile(xs, p: float) -> float | None:
    """Nearest-rank percentile: deterministic, no interpolation, exact
    on small samples.
    """
    xs = sorted(x for x in xs if isinstance(x, (int, float)))
    if not xs:
        return None
    rank = max(1, -(-len(xs) * p // 100))  # ceil(n * p / 100)
    return float(xs[int(rank) - 1])


def _quantiles(xs) -> dict | None:
    if not xs:
        return None
    return {"p50": percentile(xs, 50), "p95": percentile(xs, 95),
            "p99": percentile(xs, 99), "mean": sum(xs) / len(xs),
            "n": len(xs)}


def iter_traces(events) -> list[dict]:
    """The ``serving_trace`` records of an event stream. Accepts raw
    trace dicts too (no ``kind`` — the bench passes records it
    collected itself) so one analyzer serves both transports."""
    out = []
    for e in events:
        if not isinstance(e, dict):
            continue
        kind = e.get("kind")
        if kind == "serving_trace" or (kind is None
                                       and e.get("outcome")
                                       in OUTCOMES):
            out.append(e)
    return out


def meets_slo(trace: dict, ttft_deadline_s: float,
              per_token_deadline_s: float) -> bool:
    """One finished request against the two-part deadline: TTFT
    within ``ttft_deadline_s`` AND the decode tail (e2e minus TTFT)
    within ``per_token_deadline_s`` per post-first token. A request
    with no token at all (preempted before TTFT) never attains."""
    ttft = trace.get("ttft_s")
    if not isinstance(ttft, (int, float)) or ttft > ttft_deadline_s:
        return False
    e2e = trace.get("e2e_s")
    n = trace.get("new_tokens") or 0
    if not isinstance(e2e, (int, float)):
        return False
    tail_budget = per_token_deadline_s * max(0, n - 1)
    return (e2e - ttft) <= tail_budget + 1e-9


def slo_attainment(traces, ttft_deadline_s: float,
                   per_token_deadline_s: float) -> dict | None:
    """SLO-attainment fraction over the FINISHED traces (a preempted
    record is not a served request — its resubmitted incarnation is
    scored when it finishes)."""
    done = [t for t in traces if t.get("outcome") == "finished"]
    if not done:
        return None
    ok = sum(1 for t in done
             if meets_slo(t, ttft_deadline_s, per_token_deadline_s))
    return {"attained": round(ok / len(done), 6), "met": ok,
            "requests": len(done),
            "ttft_deadline_s": ttft_deadline_s,
            "per_token_deadline_s": per_token_deadline_s}


def _span_stats(traces) -> dict:
    """Launch-occupancy view from the span timelines: prompt tokens
    per prefill launch and emitted tokens per decode burst — the
    launch-amortization numbers the batched/resident paths exist
    for, now derivable per tenant from the trace stream alone."""
    prefill_tokens: list[float] = []
    decode_emitted: list[float] = []
    for t in traces:
        for s in t.get("spans") or []:
            if s.get("ev") == "prefill" and \
                    isinstance(s.get("tokens"), (int, float)):
                prefill_tokens.append(s["tokens"])
            elif s.get("ev") == "decode" and \
                    isinstance(s.get("emitted"), (int, float)):
                decode_emitted.append(s["emitted"])
    out: dict = {}
    if prefill_tokens:
        out["prefill_launches"] = len(prefill_tokens)
        out["prefill_tokens_per_launch"] = round(
            sum(prefill_tokens) / len(prefill_tokens), 4)
    if decode_emitted:
        out["decode_bursts"] = len(decode_emitted)
        out["decode_emitted_per_burst"] = round(
            sum(decode_emitted) / len(decode_emitted), 4)
    return out


def _tenant_report(traces, ttft_deadline_s, per_token_deadline_s
                   ) -> dict:
    done = [t for t in traces if t.get("outcome") == "finished"]
    pre = [t for t in traces if t.get("outcome") == "preempted"]
    rep: dict = {
        "requests": len(done),
        "preemptions": len(pre),
        "ttft_s": _quantiles([t.get("ttft_s") for t in done
                              if isinstance(t.get("ttft_s"),
                                            (int, float))]),
        "e2e_s": _quantiles([t.get("e2e_s") for t in done
                             if isinstance(t.get("e2e_s"),
                                           (int, float))]),
        "queue_wait_s": _quantiles(
            [t.get("queue_wait_s") for t in done
             if isinstance(t.get("queue_wait_s"), (int, float))]),
        "tokens_per_request": _quantiles(
            [t.get("new_tokens") for t in done
             if isinstance(t.get("new_tokens"), (int, float))]),
        "slo": slo_attainment(traces, ttft_deadline_s,
                              per_token_deadline_s),
    }
    new_tokens = sum(t.get("new_tokens") or 0 for t in done)
    discarded = sum(t.get("tokens_discarded") or 0 for t in pre)
    rep["tokens_discarded"] = discarded
    if new_tokens:
        # Retry cost: tokens generated then thrown away by
        # preemption, as a fraction of the tokens that reached users
        # — derived from the preempt traces, not inferred.
        rep["preempt_retry_cost"] = round(discarded / new_tokens, 6)
    prompt = sum(t.get("prompt_tokens") or 0 for t in done)
    hit = sum(t.get("prefix_hit_tokens") or 0 for t in done)
    if prompt:
        rep["prefix_hit_rate"] = round(hit / prompt, 6)
    rep.update(_span_stats(traces))
    return rep


def analyze_traces(events, ttft_deadline_s: float
                   = DEFAULT_TTFT_DEADLINE_S,
                   per_token_deadline_s: float
                   = DEFAULT_PER_TOKEN_DEADLINE_S) -> dict | None:
    """Event stream -> the serving SLO ledger: overall + per-tenant
    p50/p95/p99 TTFT/e2e/queue-wait, tokens/request, SLO attainment,
    preemption retry cost, prefix-hit rate, launch occupancy. None
    when the stream carries no ``serving_trace`` records (the section
    stays out of the summarizer report)."""
    traces = iter_traces(events)
    if not traces:
        return None
    tenants = sorted({t.get("tenant") or "default" for t in traces})
    report = {
        "traces": len(traces),
        "overall": _tenant_report(traces, ttft_deadline_s,
                                  per_token_deadline_s),
        "tenants": {
            name: _tenant_report(
                [t for t in traces
                 if (t.get("tenant") or "default") == name],
                ttft_deadline_s, per_token_deadline_s)
            for name in tenants},
    }
    return report


def _fmt_q(q: dict | None, scale: float = 1e3,
           unit: str = "ms") -> str:
    if not q:
        return "-"
    return (f"p50 {q['p50'] * scale:.1f}{unit}  "
            f"p95 {q['p95'] * scale:.1f}{unit}  "
            f"p99 {q['p99'] * scale:.1f}{unit}")


def render_serving_lines(rep: dict | None) -> list[str]:
    """Report lines — shared by the summarizer section and the
    ``--serving-report`` CLI so the two renderings cannot drift."""
    if not rep:
        return []
    o = rep["overall"]
    slo = o.get("slo") or {}
    lines = [
        f"serving: {o['requests']} request(s) finished, "
        f"{o['preemptions']} preemption trace(s), "
        f"{len(rep['tenants'])} tenant(s)"]
    if slo:
        lines.append(
            f"  SLO (ttft<={slo['ttft_deadline_s'] * 1e3:.0f}ms, "
            f"{slo['per_token_deadline_s'] * 1e3:.0f}ms/token): "
            f"{slo['attained']:.1%} attained "
            f"({slo['met']}/{slo['requests']})")
    for name, t in sorted(rep["tenants"].items()):
        t_slo = t.get("slo") or {}
        line = (f"  tenant {name}: {t['requests']} req  "
                f"ttft {_fmt_q(t.get('ttft_s'))}  "
                f"e2e {_fmt_q(t.get('e2e_s'))}")
        if t_slo:
            line += f"  slo {t_slo['attained']:.1%}"
        lines.append(line)
        extra = []
        if t.get("queue_wait_s"):
            extra.append(
                f"queue wait {_fmt_q(t['queue_wait_s'])}")
        if t.get("prefix_hit_rate") is not None:
            extra.append(f"prefix hit {t['prefix_hit_rate']:.1%}")
        if t.get("preempt_retry_cost") is not None:
            extra.append(
                f"retry cost {t['preempt_retry_cost']:.1%} "
                f"({t['tokens_discarded']} tok discarded)")
        if extra:
            lines.append("    " + "  ".join(extra))
    occ = []
    if o.get("prefill_tokens_per_launch") is not None:
        occ.append(f"prefill {o['prefill_tokens_per_launch']:.1f} "
                   f"tok/launch x{o['prefill_launches']}")
    if o.get("decode_emitted_per_burst") is not None:
        occ.append(f"decode {o['decode_emitted_per_burst']:.1f} "
                   f"tok/burst x{o['decode_bursts']}")
    if occ:
        lines.append("  launch occupancy: " + ", ".join(occ))
    return lines


def slo_deadlines_from_conf(path: str | None = None
                            ) -> tuple[float, float]:
    """(ttft_deadline_s, per_token_deadline_s) from conf/serving/
    default.yaml's ``slo:`` block — the one committed place deadlines
    live; module defaults when the file/block is absent (a bare
    checkout of only the telemetry package still works)."""
    import os
    ttft, per_tok = (DEFAULT_TTFT_DEADLINE_S,
                     DEFAULT_PER_TOKEN_DEADLINE_S)
    if path is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "conf", "serving", "default.yaml")
    try:
        import yaml
        with open(path) as f:
            conf = yaml.safe_load(f) or {}
    except (OSError, ImportError, ValueError):
        return ttft, per_tok
    slo = conf.get("slo") or {}
    if isinstance(slo.get("ttft_s"), (int, float)):
        ttft = float(slo["ttft_s"])
    if isinstance(slo.get("per_token_s"), (int, float)):
        per_tok = float(slo["per_token_s"])
    return ttft, per_tok
