"""Live metrics endpoint: Prometheus text exposition off the event sink
(port of ``distributed_training_tpu/telemetry/metrics_server.py``).

A stdlib-only HTTP server registered as an observer on a ``Telemetry``
sink (``telemetry/events.py::Telemetry.add_observer``): every gauge
below is folded from records the sink already emits (training spans,
the serving engine's ``serving``/``serving_kv``/``serving_request``
records, ``incident`` records), so the endpoint and ``events.jsonl``
cannot disagree. The record schema, the metric names, the histogram
bounds and the rendered text are the JAX module's, so a scraper reads
either package's endpoint alike.

Endpoints:

- ``GET /metrics`` — Prometheus text exposition (version 0.0.4):
  ``dtt_step_time_seconds``, ``dtt_tokens_per_s``, ``dtt_steps_total``,
  the ``dtt_serving_*`` gauges and counters, the per-tenant serving
  latency histograms, ``dtt_up``.
- ``GET /healthz`` — 200 while the step loop makes progress; 503 once
  no step has completed for longer than ``stall_timeout_s`` (the first
  step gets a 10x compile allowance).

The observer runs on whatever thread emits the record and stays cheap
(dict updates under one lock); the HTTP side renders a snapshot under
the same lock. A failed bind logs and returns None: a metrics endpoint
must never take down the program it reports on.
"""

from __future__ import annotations

import http.server
import json
import logging
import threading
import time

logger = logging.getLogger(__name__)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Fixed histogram bucket bounds (seconds / tokens). FIXED and
# documented on purpose: Prometheus histograms aggregate across
# hosts/scrapes only when every emitter uses identical ``le`` bounds —
# a per-host adaptive choice would make fleet-level quantiles
# meaningless. Bounds follow the Prometheus latency idiom
# (1-2.5-5 per decade); tokens/request uses powers of two up to the
# engine's typical max_seq_len scale. The gauge
# ``dtt_serving_ttft_seconds`` (last finished request) stays for
# dashboards; these histograms are the SLO source of truth.
#
# Naming note: the TTFT histogram is ``time_to_first_token`` in full
# because the short name already belongs to the LAST-VALUE gauge
# ``dtt_serving_ttft_seconds`` (pinned schema since r01) and the
# exposition format forbids two metric families under one name — a
# same-name gauge + histogram pair is a scrape error, not a style
# choice.
HIST_BUCKETS: dict[str, tuple[float, ...]] = {
    "serving_time_to_first_token_seconds": (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0),
    "serving_e2e_seconds": (
        0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
        30.0, 60.0),
    "serving_queue_wait_seconds": (
        0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
        1.0, 2.5, 5.0, 10.0),
    "serving_tokens_per_request": (
        1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
        1024.0),
}


class MetricsServer:
    """Prometheus endpoint fed by Telemetry records.

    ``tokens_per_step`` converts step durations into a throughput
    gauge (tokens == samples for non-token models); ``stall_timeout_s``
    drives ``/healthz`` (0 = never unhealthy); ``info`` is static
    run identity (world_size, incarnation, host) exported as gauges.
    ``port=0`` binds an ephemeral port (tests); read ``.port`` after
    ``start()``.
    """

    def __init__(self, port: int, telemetry=None,
                 tokens_per_step: float = 0.0,
                 stall_timeout_s: float = 0.0,
                 info: dict | None = None,
                 host: str = "0.0.0.0"):
        self._requested_port = port
        self._host = host
        self.tokens_per_step = tokens_per_step
        self.stall_timeout_s = stall_timeout_s
        self._lock = threading.Lock()
        self._gauges: dict[str, float] = {}
        # Labeled gauge families: name -> {label-pairs -> value}
        # (the per-dp-group serving gauges; rendered as
        # dtt_<name>{group="N"} rows, additive next to the flat set).
        self._labeled: dict[str, dict[str, float]] = {}
        # Labeled COUNTER families (anomalies by signal): same label
        # layout, rendered with TYPE counter — a separate dict because
        # the exposition format pins one TYPE per family.
        self._labeled_counters: dict[str, dict[str, float]] = {}
        # Histogram families: name -> {tenant -> state}. Bounds are
        # the module-level HIST_BUCKETS; state is cumulative-ready
        # (per-bound counts + sum + count, +Inf implied by count).
        self._hists: dict[str, dict[str, dict]] = {}
        self._counters: dict[str, float] = {"steps_total": 0.0,
                                            "straggler_verdicts_total":
                                                0.0,
                                            "data_wait_seconds_total":
                                                0.0}
        for k, v in (info or {}).items():
            if isinstance(v, (int, float)):
                self._gauges[k] = float(v)
        self._started_at = time.monotonic()
        self._last_step_at: float | None = None
        self._last_progress_at: float | None = None
        self._httpd = None
        self._thread = None
        self.port: int | None = None
        # Observer registration happens in start(), AFTER a
        # successful bind — a server whose port was taken must not
        # keep folding every telemetry record for the rest of the
        # run while serving nothing.
        self._telemetry = telemetry

    # -- feed ----------------------------------------------------------

    def observe(self, rec: dict) -> None:
        """Telemetry observer: fold one emitted record into the
        gauges. Must not raise (the sink swallows, but cheap safety
        beats a stack trace per step)."""
        kind = rec.get("kind")
        with self._lock:
            if kind == "span":
                # ANY main-loop span closing is liveness evidence —
                # a run inside a long deliberate non-step phase
                # (checkpoint drain, eval, a mid-run re-compile)
                # is slow, not dead, and /healthz must not route
                # traffic away from it. data_assemble is excluded:
                # it closes on the prefetch thread, which can stay
                # briefly alive after the main loop wedges.
                if rec.get("name") != "data_assemble":
                    self._last_progress_at = time.monotonic()
            if kind == "span" and rec.get("name") in ("step",
                                                      "compile"):
                # The FIRST optimizer step dispatches under a
                # "compile" span (trainer.py): it is still a
                # completed step — counting only "step" spans would
                # export steps_total = N-1 and hold the healthz
                # first-step latch one step too long. Its duration is
                # compile-dominated though, so the step-time/tokens
                # gauges wait for a real "step" span.
                self._counters["steps_total"] += 1
                self._last_step_at = time.monotonic()
            if kind == "span" and rec.get("name") == "step":
                dur = rec.get("dur_s")
                if isinstance(dur, (int, float)) and dur > 0:
                    self._gauges["step_time_seconds"] = dur
                    if self.tokens_per_step:
                        self._gauges["tokens_per_s"] = (
                            self.tokens_per_step / dur)
            elif kind == "span" and rec.get("name") == "data_wait":
                dur = rec.get("dur_s")
                if isinstance(dur, (int, float)):
                    self._counters["data_wait_seconds_total"] += dur
            elif kind == "goodput":
                for src, dst in (("mfu_wall", "mfu"),
                                 ("goodput", "goodput")):
                    if isinstance(rec.get(src), (int, float)):
                        self._gauges[dst] = rec[src]
            elif kind == "attribution":
                for src, dst in (
                        ("overlap_frac", "overlap_fraction"),
                        ("compute_frac", "compute_fraction"),
                        ("collective_frac", "collective_fraction"),
                        ("host_frac", "host_fraction")):
                    if isinstance(rec.get(src), (int, float)):
                        self._gauges[dst] = rec[src]
            elif kind == "attribution_static":
                if isinstance(rec.get("overlap_score"), (int, float)):
                    self._gauges["overlap_static_fraction"] = \
                        rec["overlap_score"]
            elif kind == "straggler":
                persistent = rec.get("persistent") or []
                self._gauges["straggler_flagged"] = float(
                    len(persistent))
                if persistent:
                    self._counters["straggler_verdicts_total"] += len(
                        persistent)
            elif kind == "resume":
                if isinstance(rec.get("world_size"), int):
                    self._gauges["world_size"] = rec["world_size"]
                if isinstance(rec.get("restarts"), int):
                    self._gauges["incarnation"] = rec["restarts"]
            elif kind == "clock_sync":
                if isinstance(rec.get("process_count"), int):
                    self._gauges.setdefault(
                        "world_size", float(rec["process_count"]))
            elif kind == "collectives":
                if isinstance(rec.get("bytes_per_step"), (int, float)):
                    self._gauges["collective_bytes_per_step"] = \
                        rec["bytes_per_step"]
            elif kind == "serving":
                # Engine step records (serving/engine.py) — additive
                # serving gauges next to the training ones; schema
                # held to the JAX module's by tests/test_torch_server_ops.py.
                for src, dst in (
                        ("in_flight", "serving_requests_in_flight"),
                        ("queue_depth", "serving_queue_depth"),
                        ("pages_used", "serving_kv_pages_used"),
                        ("pages_total", "serving_kv_pages_total")):
                    if isinstance(rec.get(src), (int, float)):
                        self._gauges[dst] = float(rec[src])
                dur = rec.get("dur_s")
                toks = rec.get("tokens")
                if isinstance(dur, (int, float)) and dur > 0 \
                        and isinstance(toks, (int, float)) and toks:
                    # "tokens" means NEW tokens on decode steps and
                    # PROMPT tokens on (batched) prefill steps
                    # (serving/engine.py step records) — two gauges,
                    # split by op.
                    if rec.get("op") == "prefill":
                        self._gauges["serving_prefill_tokens_per_s"] \
                            = toks / dur
                    else:
                        self._gauges["serving_tokens_per_s"] = \
                            toks / dur
                if isinstance(rec.get("spec_accepted_mean"),
                              (int, float)):
                    # Speculative decode acceptance length (tokens
                    # emitted per slot-launch, serving/engine.py).
                    self._gauges["serving_spec_accepted_mean"] = \
                        float(rec["spec_accepted_mean"])
                # Device-resident decode + weight-store gauges
                # (serving/engine.py step records).
                for src, dst in (
                        ("host_syncs_per_token",
                         "serving_host_syncs_per_token"),
                        ("resident_steps_per_launch",
                         "serving_resident_steps_per_launch"),
                        ("weight_bytes", "serving_weight_bytes")):
                    if isinstance(rec.get(src), (int, float)):
                        self._gauges[dst] = float(rec[src])
                # Per-dp-group shard gauges (the dp-sharded engine's
                # step records carry per-group lists — serving/
                # engine.py + kv_cache.occupancy).
                for src, dst in (
                        ("group_slots_active",
                         "serving_group_slots_active"),
                        ("group_prefill_slots_active",
                         "serving_group_prefill_slots_active"),
                        ("group_pages_used",
                         "serving_group_kv_pages_used"),
                        ("group_seqs", "serving_group_seqs"),
                        ("kv_pages_shared",
                         "serving_kv_pages_shared")):
                    vals = rec.get(src)
                    if isinstance(vals, (list, tuple)):
                        fam = self._labeled.setdefault(dst, {})
                        for g, v in enumerate(vals):
                            if isinstance(v, (int, float)):
                                fam[f'group="{g}"'] = float(v)
                # Prefix-sharing counters + session gauge (the step
                # records are additive: sharing-disabled engines
                # simply omit these keys).
                for src, dst in (
                        ("prefix_hit_tokens",
                         "serving_prefix_hit_tokens_total"),
                        ("prefill_tokens_saved",
                         "serving_prefill_tokens_saved_total")):
                    if isinstance(rec.get(src), (int, float)):
                        self._counters[dst] = \
                            self._counters.get(dst, 0.0) + rec[src]
                if isinstance(rec.get("sessions_resident"),
                              (int, float)):
                    self._gauges["serving_sessions_resident"] = \
                        float(rec["sessions_resident"])
            elif kind == "anomaly":
                # Online-detector verdicts (telemetry/anomaly.py) —
                # one counter per signal so an alert rule can key on
                # dtt_anomalies_total{kind="step_time"}.
                sig = rec.get("signal")
                if isinstance(sig, str) and sig:
                    fam = self._labeled_counters.setdefault(
                        "anomalies_total", {})
                    key = f'kind="{sig}"'
                    fam[key] = fam.get(key, 0.0) + 1
            elif kind == "anomaly_baseline":
                # Low-cadence rolling-baseline snapshots: what the
                # detector currently considers normal.
                for src, dst in (
                        ("step_time_s", "anomaly_baseline_step_time_s"),
                        ("data_wait_s",
                         "anomaly_baseline_data_wait_s")):
                    if isinstance(rec.get(src), (int, float)):
                        self._gauges[dst] = float(rec[src])
            elif kind == "incident":
                self._counters["incidents_total"] = \
                    self._counters.get("incidents_total", 0.0) + 1
            elif kind == "serving_kv":
                # Allocator records: keep occupancy live even between
                # engine steps (join/evict happen inside steps, but
                # warmup/adopt/preempt touch the pool outside them).
                for src, dst in (
                        ("pages_used", "serving_kv_pages_used"),
                        ("pages_total", "serving_kv_pages_total")):
                    if isinstance(rec.get(src), (int, float)):
                        self._gauges[dst] = float(rec[src])
            elif kind == "serving_request":
                if isinstance(rec.get("ttft_s"), (int, float)):
                    self._gauges["serving_ttft_seconds"] = \
                        rec["ttft_s"]
                self._counters["serving_requests_total"] = \
                    self._counters.get("serving_requests_total",
                                       0.0) + 1
                # Per-tenant latency histograms — the SLO source of
                # truth (the gauge above is last-value only). One
                # observation per finished request, labeled by the
                # tenant the HTTP body carried (engine default:
                # "default").
                tenant = rec.get("tenant")
                if not isinstance(tenant, str) or not tenant:
                    tenant = "default"
                for src, name in (
                        ("ttft_s",
                         "serving_time_to_first_token_seconds"),
                        ("latency_s", "serving_e2e_seconds"),
                        ("queue_wait_s",
                         "serving_queue_wait_seconds"),
                        ("new_tokens",
                         "serving_tokens_per_request")):
                    v = rec.get(src)
                    if isinstance(v, (int, float)):
                        self._hist_observe(name, tenant, float(v))

    def _hist_observe(self, name: str, tenant: str,
                      value: float) -> None:
        """Fold one observation into a tenant-labeled histogram.
        Caller holds ``self._lock``."""
        bounds = HIST_BUCKETS[name]
        fam = self._hists.setdefault(name, {})
        st = fam.setdefault(tenant, {
            "counts": [0] * len(bounds), "sum": 0.0, "count": 0})
        for i, b in enumerate(bounds):
            if value <= b:
                st["counts"][i] += 1
        st["sum"] += value
        st["count"] += 1

    # -- health --------------------------------------------------------

    def health(self) -> tuple[bool, dict]:
        """(healthy, detail). Unhealthy only when a stall threshold is
        configured and the step loop has been silent past it — with
        the watchdog's 10x first-step (compile) allowance before the
        first step lands."""
        with self._lock:
            first_step_done = self._last_step_at is not None
            last = self._last_progress_at
            steps = self._counters["steps_total"]
        now = time.monotonic()
        detail: dict = {"steps": int(steps)}
        if not self.stall_timeout_s:
            return True, {**detail, "status": "ok",
                          "stall_watch": "disabled"}
        if not first_step_done:
            budget = self.stall_timeout_s * 10
            silent = now - (last if last is not None
                            else self._started_at)
            detail["status"] = "starting"
        else:
            budget = self.stall_timeout_s
            silent = now - (last if last is not None else
                            self._started_at)
            detail["status"] = "ok"
        detail["silent_s"] = round(silent, 3)
        if silent > budget:
            detail["status"] = "stalled"
            detail["stall_threshold_s"] = budget
            return False, detail
        return True, detail

    # -- render --------------------------------------------------------

    _HELP = {
        "step_time_seconds": "Last completed optimizer step duration",
        "tokens_per_s": "Throughput from the last step "
                        "(tokens == samples for non-token models)",
        "mfu": "Wall-clock MFU of the last goodput window",
        "goodput": "Step seconds / wall seconds, last goodput window",
        "overlap_fraction": "Measured share of collective time hidden "
                            "under compute (last attribution capture)",
        "overlap_static_fraction": "Compiled-schedule overlap score "
                                   "(attribution_static)",
        "compute_fraction": "Measured compute share of step time",
        "collective_fraction": "Measured exposed-collective share",
        "host_fraction": "Measured host/data share of step time",
        "world_size": "Process count of the current incarnation",
        "incarnation": "Supervisor restart count of this incarnation",
        "straggler_flagged": "Hosts flagged in the last straggler "
                             "exchange",
        "collective_bytes_per_step": "Static per-step collective "
                                     "traffic (bytes/participant)",
        "steps_total": "Optimizer steps completed this incarnation",
        "data_wait_seconds_total": "Cumulative host time blocked on "
                                   "the input pipeline",
        "straggler_verdicts_total": "Cumulative persistent straggler "
                                    "verdicts observed",
        "up": "1 while the run is serving metrics",
        "serving_requests_in_flight": "Sequences in the engine's "
                                      "slot table (serving/)",
        "serving_queue_depth": "Requests waiting for admission",
        "serving_kv_pages_used": "KV-cache pages allocated",
        "serving_kv_pages_total": "KV-cache pages in the pool "
                                  "(scratch excluded)",
        "serving_ttft_seconds": "Time-to-first-token of the LAST "
                                "FINISHED request only (a gauge — "
                                "quantiles and SLOs come from the "
                                "dtt_serving_time_to_first_token_"
                                "seconds histogram)",
        "serving_time_to_first_token_seconds":
            "Time-to-first-token per finished request, by tenant "
            "(histogram; the SLO source of truth)",
        "serving_e2e_seconds": "Arrival-to-finish latency per "
                               "finished request, by tenant "
                               "(histogram)",
        "serving_queue_wait_seconds": "Arrival-to-admission wait per "
                                      "finished request, by tenant "
                                      "(histogram)",
        "serving_tokens_per_request": "New tokens generated per "
                                      "finished request, by tenant "
                                      "(histogram)",
        "serving_tokens_per_s": "Decode throughput of the last "
                                "engine step",
        "serving_prefill_tokens_per_s": "Aggregate prompt tokens/s "
                                        "of the last batched "
                                        "prefill step",
        "serving_spec_accepted_mean": "Speculative decode mean "
                                      "accepted chain length, last "
                                      "decode step",
        "serving_host_syncs_per_token": "Device-to-host syncs per "
                                        "emitted token, last engine "
                                        "step (resident decode "
                                        "drives this toward 1/K)",
        "serving_resident_steps_per_launch": "Mean while_loop "
                                             "iterations per "
                                             "device-resident burst, "
                                             "last decode step",
        "serving_weight_bytes": "Bytes of the engine's resident "
                                "weight tree (int8 stores shrink "
                                "this ~4x vs fp32)",
        "serving_requests_total": "Requests completed by the engine",
        "serving_group_slots_active": "Active decode slots per dp "
                                      "group (dp-sharded engine)",
        "serving_group_prefill_slots_active": "Batched-prefill lanes "
                                              "live per dp group in "
                                              "the last prefill "
                                              "launch",
        "serving_group_kv_pages_used": "KV pages allocated in each "
                                       "dp group's pool shard",
        "serving_group_seqs": "Sequences resident per dp group",
        "serving_kv_pages_shared": "KV pages with refcount > 1 per "
                                   "dp group (prefix sharing)",
        "serving_prefix_hit_tokens_total": "Prompt tokens served from "
                                           "the prefix index instead "
                                           "of being prefilled",
        "serving_prefill_tokens_saved_total": "Prefill compute "
                                              "avoided by prefix "
                                              "sharing and session "
                                              "resume (tokens)",
        "serving_sessions_resident": "Retained chat sessions holding "
                                     "KV pages for zero-prefill "
                                     "resume",
        "anomalies_total": "Online anomaly-detector verdicts by "
                           "signal (telemetry/anomaly.py)",
        "incidents_total": "Incident bundles written by the flight "
                           "recorder (telemetry/incident.py)",
        "anomaly_baseline_step_time_s": "Detector rolling-median "
                                        "step-time baseline",
        "anomaly_baseline_data_wait_s": "Detector rolling-median "
                                        "data-wait baseline",
    }

    def render(self) -> str:
        """The /metrics payload (Prometheus text format 0.0.4)."""
        with self._lock:
            gauges = dict(self._gauges)
            counters = dict(self._counters)
            labeled = {k: dict(v) for k, v in self._labeled.items()}
            labeled_counters = {k: dict(v) for k, v in
                                self._labeled_counters.items()}
            hists = {name: {t: {"counts": list(st["counts"]),
                                "sum": st["sum"],
                                "count": st["count"]}
                            for t, st in fam.items()}
                     for name, fam in self._hists.items()}
        gauges["up"] = 1.0
        lines: list[str] = []
        for name, value in sorted(gauges.items()):
            full = f"dtt_{name}"
            lines.append(f"# HELP {full} {self._HELP.get(name, name)}")
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full} {_fmt(value)}")
        for name, fam in sorted(labeled.items()):
            full = f"dtt_{name}"
            lines.append(f"# HELP {full} {self._HELP.get(name, name)}")
            lines.append(f"# TYPE {full} gauge")
            for labels, value in sorted(fam.items()):
                lines.append(f"{full}{{{labels}}} {_fmt(value)}")
        for name, value in sorted(counters.items()):
            full = f"dtt_{name}"
            lines.append(f"# HELP {full} {self._HELP.get(name, name)}")
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full} {_fmt(value)}")
        for name, fam in sorted(labeled_counters.items()):
            full = f"dtt_{name}"
            lines.append(f"# HELP {full} {self._HELP.get(name, name)}")
            lines.append(f"# TYPE {full} counter")
            for labels, value in sorted(fam.items()):
                lines.append(f"{full}{{{labels}}} {_fmt(value)}")
        for name, fam in sorted(hists.items()):
            full = f"dtt_{name}"
            bounds = HIST_BUCKETS[name]
            lines.append(f"# HELP {full} {self._HELP.get(name, name)}")
            lines.append(f"# TYPE {full} histogram")
            for tenant, st in sorted(fam.items()):
                lbl = f'tenant="{tenant}"'
                for b, c in zip(bounds, st["counts"]):
                    lines.append(
                        f'{full}_bucket{{{lbl},le="{_fmt(b)}"}} {c}')
                lines.append(
                    f'{full}_bucket{{{lbl},le="+Inf"}} {st["count"]}')
                lines.append(f'{full}_sum{{{lbl}}} '
                             f'{_fmt(st["sum"])}')
                lines.append(f'{full}_count{{{lbl}}} {st["count"]}')
        return "\n".join(lines) + "\n"

    # -- HTTP ----------------------------------------------------------

    def start(self):
        """Bind + serve on a daemon thread. Returns self, or None when
        the bind fails (logged; the run continues unmetered)."""
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?")[0] == "/metrics":
                    body = server.render().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     PROM_CONTENT_TYPE)
                elif self.path.split("?")[0] == "/healthz":
                    ok, detail = server.health()
                    body = (json.dumps(detail) + "\n").encode()
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type",
                                     "application/json")
                else:
                    body = b"not found; try /metrics or /healthz\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                logger.debug("metrics http: " + fmt, *args)

        try:
            self._httpd = http.server.ThreadingHTTPServer(
                (self._host, self._requested_port), Handler)
        except OSError as e:
            logger.warning(
                "metrics endpoint NOT started (port %s): %s — the "
                "run continues without /metrics",
                self._requested_port, e)
            return None
        self.port = self._httpd.server_address[1]
        if self._telemetry is not None:
            self._telemetry.add_observer(self.observe)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="metrics-server", daemon=True)
        self._thread.start()
        logger.info("metrics endpoint on :%d (/metrics, /healthz)",
                    self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
