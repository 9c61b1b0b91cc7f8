"""Online anomaly detection over the telemetry event stream (port of
``distributed_training_tpu/telemetry/anomaly.py``, which is
framework-free; this is the port's own copy, with the same ``anomaly``
and ``anomaly_baseline`` event schema).

Every observability surface so far is passive (events.jsonl, the
Prometheus endpoint, serving traces) or operator-triggered (the
``profile_now`` drop file). This module closes the loop: an
``AnomalyDetector`` registered through ``Telemetry.add_observer`` —
the metrics_server precedent, so it is a pure host-side function of
records the sink already emits and adds ZERO device syncs — keeps
rolling median/MAD baselines per signal and emits schema-pinned
``anomaly`` events with the evidence behind each verdict.

Signals (each a field of a record the run already emits):

- ``step_time``   — ``span``/``step`` ``dur_s`` (high side)
- ``data_wait``   — ``span``/``data_wait`` ``dur_s`` (high side)
- ``throughput``  — ``train_metrics`` ``samples_per_sec_per_chip``
  (low side; the entry MetricsLogger already materialized host-side
  at log_every cadence — the loss float it carries is the ONE
  existing sync, never a new one)
- ``loss_nan``    — ``train_metrics`` loss missing/non-finite
  (sanitize_for_json turns NaN into null)
- ``loss_spike``  — ``train_metrics`` loss (high side)
- ``serving_queue_depth`` — engine ``serving`` step records (high)
- ``serving_ttft``        — ``serving_request`` ``ttft_s`` (high)

Median/MAD (median absolute deviation) is the robust pair: one
outlier moves a mean+stddev baseline, but the median of a window
containing one spike is the same window without it. A value is
anomalous when ``|value - median| / mad'`` exceeds ``threshold``,
where ``mad' = max(mad, rel_floor * median, abs_floor)`` — the floor
keeps a near-zero-variance window (synthetic sleeps, idle queues)
from flagging scheduler jitter as a regression.

Closed-loop actions ride on top (telemetry/incident.py): a SUSTAINED
step-time regression (``sustain`` consecutive anomalous steps) arms
an in-run profile capture by dropping the existing ``profile_now``
trigger file — one-shot across supervisor restarts via the
write-before-action ledger discipline — and an ``IncidentRecorder``
observing the same stream snapshots the flight-recorder ring buffer
(``Telemetry.tail()``) into an incident bundle on every anomaly.

Determinism across restart/resume: the detector's whole state is a
pure function of the event stream, so ``replay(restored_events)``
(the CLI feeds the resumed run's existing events.jsonl) rebuilds
baselines, cooldowns and the sustain counter exactly — no side
effects, no emissions — and the live stream continues from there.
"""

from __future__ import annotations

import collections
import logging
import math
import threading

logger = logging.getLogger(__name__)

SCHEMA = 1

# The stable consumer surface of an ``anomaly`` event (the
# attribution.SUMMARY_KEYS discipline: summarize/doctor/metrics_server
# filter through this, so online and offline verdicts cannot drift).
ANOMALY_KEYS = ("schema", "signal", "value", "median", "mad",
                "deviation", "threshold", "step", "window", "host",
                "detail")

# Baseline snapshot event, emitted at low cadence so the live
# /metrics gauges (dtt_anomaly_baseline_*_s) stay fresh even when
# nothing is anomalous.
BASELINE_KEYS = ("schema", "step_time_s", "data_wait_s", "throughput",
                 "samples", "step")

SIGNALS = ("step_time", "data_wait", "throughput", "loss_nan",
           "loss_spike", "serving_queue_depth", "serving_ttft")

# Kinds this module (and its incident consumers) emit: the detector
# must never observe its own output, or one anomaly recurses forever.
_SELF_KINDS = frozenset({"anomaly", "anomaly_baseline", "incident"})

# Wall-clock signals get a 5ms absolute deviation floor: a prefetched
# data_wait baseline sits at microseconds with microsecond MAD, where
# a harmless 30us scheduler blip would read as dozens of "MADs".
# Nothing under 5ms is ever an incident on these signals.
TIME_SIGNALS = frozenset({"step_time", "data_wait", "serving_ttft"})
_TIME_ABS_FLOOR = 0.005


def summary_of_event(rec: dict, keys=ANOMALY_KEYS) -> dict:
    return {k: rec[k] for k in keys if k in rec}


def median_mad(values) -> tuple[float, float]:
    """(median, median-absolute-deviation) of a sequence."""
    vals = sorted(values)
    n = len(vals)
    if not n:
        return 0.0, 0.0
    med = (vals[n // 2] if n % 2
           else 0.5 * (vals[n // 2 - 1] + vals[n // 2]))
    dev = sorted(abs(v - med) for v in vals)
    mad = (dev[n // 2] if n % 2
           else 0.5 * (dev[n // 2 - 1] + dev[n // 2]))
    return med, mad


class _Baseline:
    """Rolling window + robust deviation test for one signal."""

    def __init__(self, window: int, min_samples: int,
                 rel_floor: float = 0.05, abs_floor: float = 1e-6):
        self.values: collections.deque = collections.deque(
            maxlen=window)
        self.min_samples = min_samples
        self.rel_floor = rel_floor
        self.abs_floor = abs_floor
        self.cooldown = 0  # observations until re-fire allowed

    def test(self, value: float, threshold: float,
             low_side: bool = False) -> dict | None:
        """Deviation verdict for ``value`` against the CURRENT window
        (value is appended afterwards, so a spike is judged against
        the window that precedes it). Returns the evidence dict when
        anomalous, else None."""
        out = None
        if len(self.values) >= self.min_samples:
            med, mad = median_mad(self.values)
            floor = max(mad, self.rel_floor * abs(med), self.abs_floor)
            dev = (value - med) / floor
            if low_side:
                dev = -dev
            if dev > threshold:
                out = {"value": value, "median": round(med, 6),
                       "mad": round(mad, 6),
                       "deviation": round(dev, 3),
                       "window": len(self.values)}
        self.values.append(value)
        return out


class AnomalyDetector:
    """Observer-registered online detector (module docstring).

    ``telemetry`` is the sink to emit ``anomaly`` events through
    (``None`` → detect-only, nothing emitted — the replay mode).
    ``run_dir`` enables the auto-profile action (the ``profile_now``
    drop file + its one-shot ledger live there). ``on_sustained`` is
    an optional extra callback for the sustained-regression action.
    Thread-safe: observers run on whatever thread emits the record.
    """

    def __init__(self, telemetry=None, run_dir: str | None = None,
                 window: int = 64, min_samples: int = 16,
                 threshold: float = 8.0, sustain: int = 5,
                 autoprofile: bool = True, baseline_every: int = 50,
                 host: int | None = None, on_sustained=None):
        self._tel = telemetry
        self.run_dir = run_dir
        self.window = int(window)
        self.min_samples = max(2, int(min_samples))
        self.threshold = float(threshold)
        self.sustain = max(1, int(sustain))
        self.autoprofile = autoprofile
        self.baseline_every = max(1, int(baseline_every))
        self.host = host
        self.on_sustained = on_sustained
        # RLock: _fire emits under the lock, and a synchronous
        # observer of that emission (IncidentRecorder) calls straight
        # back into verdict() on the same thread.
        self._lock = threading.RLock()
        self._base: dict[str, _Baseline] = {
            s: _Baseline(self.window, self.min_samples,
                         abs_floor=(_TIME_ABS_FLOOR
                                    if s in TIME_SIGNALS else 1e-6))
            for s in SIGNALS if s != "loss_nan"}
        self._cooldown_n = 8  # observations between re-fires/signal
        self._sustained_steps = 0   # consecutive anomalous step_times
        self._autoprofile_armed = False
        self.anomalies_total: dict[str, int] = {}
        self._last: dict[str, dict] = {}  # latest evidence per signal
        self._step_obs = 0
        self._last_step: int | None = None

    # -- feed ----------------------------------------------------------

    def observe(self, rec: dict) -> None:
        """Telemetry observer: fold one emitted record. Never raises
        past the sink's guard; cheap (sorting a <=window deque)."""
        self._observe(rec, emit=True)

    def replay(self, events: list[dict]) -> int:
        """Rebuild detector state from a restored event stream
        (resume/restart): identical folding, zero emissions, zero
        side effects. Returns the number of records folded."""
        n = 0
        for rec in events:
            if isinstance(rec, dict):
                self._observe(rec, emit=False)
                n += 1
        return n

    def _observe(self, rec: dict, emit: bool) -> None:
        kind = rec.get("kind")
        if kind in _SELF_KINDS:
            return
        with self._lock:
            if kind == "span":
                self._span(rec, emit)
            elif kind == "train_metrics":
                self._train_metrics(rec, emit)
            elif kind == "serving":
                self._num(rec, "serving_queue_depth",
                          rec.get("queue_depth"), emit)
            elif kind == "serving_request":
                self._num(rec, "serving_ttft", rec.get("ttft_s"),
                          emit)

    def _span(self, rec: dict, emit: bool) -> None:
        name, dur = rec.get("name"), rec.get("dur_s")
        if not isinstance(dur, (int, float)):
            return
        if name == "step":
            self._last_step = rec.get("step", self._last_step)
            hit = self._num(rec, "step_time", dur, emit)
            self._sustained_steps = (self._sustained_steps + 1
                                     if hit else 0)
            if self._sustained_steps >= self.sustain:
                self._sustained(rec, emit)
            self._step_obs += 1
            if emit and self._step_obs % self.baseline_every == 0:
                self._emit_baseline(rec)
        elif name == "data_wait":
            self._num(rec, "data_wait", dur, emit)

    def _train_metrics(self, rec: dict, emit: bool) -> None:
        loss = rec.get("loss")
        if not isinstance(loss, (int, float)) \
                or not math.isfinite(loss):
            # sanitize_for_json turned NaN/inf into null upstream.
            self._fire(rec, "loss_nan",
                       {"value": None, "detail": "non-finite loss"},
                       emit)
            return
        self._num(rec, "loss_spike", float(loss), emit)
        if not rec.get("warmup"):
            self._num(rec, "throughput",
                      rec.get("samples_per_sec_per_chip"), emit,
                      low_side=True)

    def _num(self, rec: dict, signal: str, value, emit: bool,
             low_side: bool = False) -> bool:
        if not isinstance(value, (int, float)):
            return False
        base = self._base[signal]
        evidence = base.test(float(value), self.threshold,
                             low_side=low_side)
        if base.cooldown > 0:
            base.cooldown -= 1
        if evidence is None:
            return False
        if base.cooldown > 0:
            return True  # anomalous, but recently reported
        base.cooldown = self._cooldown_n
        self._fire(rec, signal, evidence, emit)
        return True

    # -- actions -------------------------------------------------------

    def _fire(self, rec: dict, signal: str, evidence: dict,
              emit: bool) -> None:
        self.anomalies_total[signal] = \
            self.anomalies_total.get(signal, 0) + 1
        payload = {"schema": SCHEMA, "signal": signal,
                   "threshold": self.threshold,
                   "step": rec.get("step", self._last_step),
                   **evidence}
        if self.host is not None:
            payload.setdefault("host", self.host)
        self._last[signal] = payload
        if emit and self._tel is not None:
            self._tel.event("anomaly", **payload)

    def _sustained(self, rec: dict, emit: bool) -> None:
        """``sustain`` consecutive anomalous step times: arm the
        in-run profile capture via the existing drop-file trigger,
        one-shot across restarts (write-before-action ledger)."""
        self._sustained_steps = 0
        if self._autoprofile_armed:
            return
        self._autoprofile_armed = True
        if not emit:
            return  # replay: the pre-restart run already acted
        if self.on_sustained is not None:
            try:
                self.on_sustained(dict(self._last.get("step_time")
                                       or {}))
            except Exception as e:  # noqa: BLE001 — action must not
                # take down the emission path (observer discipline).
                logger.debug("on_sustained callback failed: %s: %s",
                             type(e).__name__, e)
        if self.autoprofile and self.run_dir:
            from distributed_training_tpu_torch.telemetry.incident import (
                arm_autoprofile)
            armed = arm_autoprofile(
                self.run_dir, key="step_time_sustained",
                evidence=self._last.get("step_time"))
            if armed and self._tel is not None:
                self._tel.event(
                    "anomaly", schema=SCHEMA, signal="step_time",
                    step=rec.get("step", self._last_step),
                    detail="sustained regression: profile capture "
                           "armed (profile_now)",
                    **{k: v for k, v in
                       (self._last.get("step_time") or {}).items()
                       if k in ("value", "median", "mad",
                                "deviation", "window")})

    # -- snapshots -----------------------------------------------------

    def _emit_baseline(self, rec: dict) -> None:
        snap = self.baselines()
        if self._tel is not None:
            self._tel.event(
                "anomaly_baseline", schema=SCHEMA,
                step=rec.get("step", self._last_step),
                step_time_s=snap.get("step_time"),
                data_wait_s=snap.get("data_wait"),
                throughput=snap.get("throughput"),
                samples=len(self._base["step_time"].values))

    def baselines(self) -> dict[str, float | None]:
        """Current per-signal baseline medians (None before
        min_samples) — the determinism surface the resume test pins."""
        out: dict[str, float | None] = {}
        for sig, base in self._base.items():
            if len(base.values) >= base.min_samples:
                out[sig] = round(median_mad(base.values)[0], 9)
            else:
                out[sig] = None
        return out

    def state_fingerprint(self) -> dict:
        """Full rebuildable-state snapshot (windows + counters), for
        the restart-determinism test: two detectors fed the same
        stream must produce identical fingerprints."""
        with self._lock:
            return {
                "windows": {s: [round(v, 9) for v in b.values]
                            for s, b in self._base.items()},
                "cooldowns": {s: b.cooldown
                              for s, b in self._base.items()},
                "sustained_steps": self._sustained_steps,
                "autoprofile_armed": self._autoprofile_armed,
                "anomalies_total": dict(self.anomalies_total),
            }

    def verdict(self) -> dict:
        """The online verdict an incident bundle snapshots
        (anomaly.json): totals, latest evidence per signal, and the
        baselines they were judged against."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "anomalies_total": dict(self.anomalies_total),
                "latest": {s: dict(p) for s, p in self._last.items()},
                "baselines": self.baselines(),
                "autoprofile_armed": self._autoprofile_armed,
            }
