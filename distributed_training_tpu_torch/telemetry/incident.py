"""Incident bundles: atomic evidence directories (port of
``distributed_training_tpu/telemetry/incident.py``, the bundle writer).

``Telemetry`` keeps a bounded in-memory tail of every emitted record.
``write_incident_bundle`` snapshots that tail, with the serving
``/debug/requests`` table when there is one, into one timestamped
directory published atomically. The serving server writes one when its
engine thread dies (kind ``engine_crash``), and ``supervise_serving``
at each crash and when it gives up (``give_up``). The layout is the JAX
package's, so its offline doctor reads a bundle of either:
``meta.json`` (schema/kind/reason), ``stacks.txt``,
``events_tail.jsonl``, ``memory_stats.json``, and the optional
``anomaly.json`` / ``attribution.json`` / ``serving_requests.json``.

Atomicity: everything is written into ``<path>.tmp`` and published with
one ``os.rename``; a crash mid-write leaves a ``.tmp`` directory, never
a half bundle that would read as complete.

``IncidentRecorder``, a ``Telemetry.add_observer`` consumer (host-side
only), writes such a bundle whenever the stream says something went
wrong: an ``anomaly`` (``telemetry/anomaly.py``), a ``watchdog_fired``
abort (the watchdog emits before ``os._exit``, so the bundle is on disk
when the process dies), a ``supervisor_give_up``, or an explicit call
(the train CLI records a ``preemption`` incident on a SIGTERM drain).
The hang watchdog's postmortem (``telemetry/watchdog.py``) is a bundle
of kind ``watchdog`` written by the same function.

``arm_autoprofile`` is the closed-loop profiling action: record the
decision in a write-before-action ledger (so a crash between ledger and
action cannot re-fire it in every restarted incarnation), then drop the
``profile_now`` file that ``ProfileCapture`` consumes. One-shot per key
across supervisor restarts.
"""

from __future__ import annotations

import faulthandler
import itertools
import json
import logging
import os
import sys
import threading
import time

from distributed_training_tpu_torch.telemetry.attribution import TRIGGER_FILE

logger = logging.getLogger(__name__)

SCHEMA = 1

# Bundle layout: core files always present, optional files present when
# the corresponding evidence existed at capture.
BUNDLE_CORE_FILES = ("meta.json", "stacks.txt", "events_tail.jsonl",
                     "memory_stats.json")
BUNDLE_OPTIONAL_FILES = ("anomaly.json", "attribution.json",
                         "serving_requests.json")

# Incident kinds the writers emit and the doctor understands.
KINDS = ("anomaly", "watchdog", "preemption", "give_up", "manual",
         "engine_crash")

AUTOPROFILE_LEDGER = "autoprofile_fired.json"

# Monotonic per-process suffix: two bundles in the same second land in
# distinct directories.
_SEQ = itertools.count()


def _device_memory_stats() -> list[dict]:
    """Per-card ``torch.cuda.memory_stats()``, read only when this
    process has already initialised CUDA: a postmortem must not claim a
    card (or hang on a wedged one) that the program never touched. An
    empty list without a card."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
        except RuntimeError as e:
            out.append({"id": i, "error": f"{type(e).__name__}: {e}"})
            continue
        out.append({"id": i, "kind": torch.cuda.get_device_name(i),
                    "stats": dict(stats) if stats else None})
    return out


def write_incident_bundle(base_dir: str, reason: str,
                          kind: str = "manual",
                          events_tail: list | None = None,
                          extra: dict | None = None,
                          anomaly: dict | None = None,
                          attribution: dict | None = None,
                          serving: dict | None = None) -> str:
    """Write one timestamped incident bundle; returns its path.

    Never raises: an incident writer that can crash its host process is
    worse than no bundle. Meta, stacks and events first (host-side only,
    cannot hang); device memory stats last and in a bounded daemon
    thread (they touch the card, which may be what is wedged), so a hang
    there still publishes the rest, and an absent ``memory_stats.json``
    is itself a finding."""
    stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    path = os.path.join(base_dir,
                        f"{stamp}_pid{os.getpid()}_{next(_SEQ)}")
    tmp = path + ".tmp"
    try:
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"schema": SCHEMA, "kind": kind, "reason": reason,
                       "time_unix": time.time(), "pid": os.getpid(),
                       **(extra or {})}, f, indent=1)
        with open(os.path.join(tmp, "stacks.txt"), "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
        # A copy of records already emitted through the sink, not an
        # emission path.
        with open(os.path.join(tmp, "events_tail.jsonl"), "w") as f:  # noqa: DTT001
            for rec in events_tail or []:
                f.write(json.dumps(rec) + "\n")
        for name, payload in (("anomaly.json", anomaly),
                              ("attribution.json", attribution),
                              ("serving_requests.json", serving)):
            if payload is not None:
                with open(os.path.join(tmp, name), "w") as f:
                    json.dump(payload, f, indent=1)

        def _dump_memory():
            try:
                stats = _device_memory_stats()
                with open(os.path.join(tmp, "memory_stats.json"),
                          "w") as f:
                    json.dump(stats, f, indent=1)
            except Exception as e:  # noqa: BLE001 — the bundle may be
                # renamed under a straggling query (join timeout below).
                logger.debug("incident memory_stats skipped: %s: %s",
                             type(e).__name__, e)
        t = threading.Thread(target=_dump_memory, daemon=True,
                             name="incident-memory-stats")
        t.start()
        t.join(timeout=10)
        os.rename(tmp, path)
    except Exception as e:  # noqa: BLE001 — never raises (docstring).
        logger.warning("incident bundle incomplete at %s: %s: %s",
                       path, type(e).__name__, e)
    return path


def is_incident_bundle(path: str) -> bool:
    """A directory is a bundle when it holds the core evidence pair."""
    return (os.path.isfile(os.path.join(path, "meta.json"))
            and os.path.isfile(os.path.join(path, "events_tail.jsonl")))


def arm_autoprofile(run_dir: str, key: str,
                    evidence: dict | None = None) -> bool:
    """One-shot closed-loop profile trigger (module docstring).

    Returns True when THIS call armed the capture; False when the
    ledger says ``key`` already fired (this run or a previous
    incarnation of it). Ledger write happens BEFORE the drop file.
    """
    inc_dir = os.path.join(run_dir, "incidents")
    ledger = os.path.join(inc_dir, AUTOPROFILE_LEDGER)
    fired: dict = {}
    if os.path.exists(ledger):
        try:
            with open(ledger, encoding="utf-8") as f:
                fired = json.load(f)
        except (OSError, ValueError) as e:
            logger.warning("autoprofile ledger unreadable (%s); "
                           "refusing to re-arm", e)
            return False
    if key in fired:
        return False
    fired[key] = {"time_unix": time.time(),
                  "evidence": evidence or {}}
    try:
        os.makedirs(inc_dir, exist_ok=True)
        tmp = ledger + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(fired, f, indent=1)
        os.replace(tmp, ledger)
        # Ledger durable: now act. ProfileCapture consumes the drop
        # file by os.remove at the next maybe_start().
        with open(os.path.join(run_dir, TRIGGER_FILE), "w") as f:
            f.write(json.dumps({"armed_by": "anomaly", "key": key}))
    except OSError as e:
        logger.warning("autoprofile arm failed: %s", e)
        return False
    logger.info("anomaly detector armed in-run profile capture "
                "(%s)", key)
    return True


class IncidentRecorder:
    """Observer that turns bad news on the event stream into bundles.

    ``detector`` (an AnomalyDetector) contributes ``anomaly.json``;
    ``serving_snapshot`` is a zero-device-touch callable returning the
    ``/debug/requests`` payload (serving/server.py exposes one). The
    recorder caches the latest ``attribution`` record it sees flow by,
    so a bundle carries the most recent trace decomposition even when
    it has scrolled out of the ring buffer. Per-kind cooldown keeps an
    anomaly storm from writing hundreds of near-identical bundles;
    ``max_bundles`` is the hard cap.
    """

    TRIGGER_KINDS = {"anomaly": "anomaly",
                     "watchdog_fired": "watchdog",
                     "supervisor_give_up": "give_up"}

    def __init__(self, run_dir: str, telemetry=None, detector=None,
                 serving_snapshot=None, enabled: bool = True,
                 cooldown_s: float = 60.0, max_bundles: int = 32):
        self.run_dir = run_dir
        self.incidents_dir = os.path.join(run_dir, "incidents")
        self._tel = telemetry
        self._detector = detector
        self._serving_snapshot = serving_snapshot
        self.enabled = enabled
        self.cooldown_s = float(cooldown_s)
        self.max_bundles = int(max_bundles)
        self.incidents_total = 0
        self._lock = threading.Lock()
        self._last_fire: dict[str, float] = {}
        self._last_attribution: dict | None = None

    def observe(self, rec: dict) -> None:
        """Telemetry observer (sanitized record, post-write)."""
        kind = rec.get("kind")
        if kind in ("attribution",):
            self._last_attribution = rec
            return
        trigger = self.TRIGGER_KINDS.get(kind)
        if trigger is None:
            return
        reason = (rec.get("detail")
                  or f"{trigger} event: "
                     f"{rec.get('signal') or rec.get('reason') or kind}")
        self.record(trigger, reason=reason, trigger=rec)

    def record(self, kind: str, reason: str,
               trigger: dict | None = None) -> str | None:
        """Write one bundle now (cooldown/cap permitting); returns its
        path or None. Safe to call from observer context and from the
        CLI teardown path."""
        if not self.enabled:
            return None
        now = time.monotonic()
        with self._lock:
            if self.incidents_total >= self.max_bundles:
                return None
            last = self._last_fire.get(kind)
            if last is not None and now - last < self.cooldown_s:
                return None
            self._last_fire[kind] = now
            self.incidents_total += 1
            seq = self.incidents_total
        tail = self._tel.tail() if self._tel is not None else []
        anomaly = None
        if self._detector is not None:
            try:
                anomaly = self._detector.verdict()
            except Exception as e:  # noqa: BLE001 — evidence layers
                # are each optional; a broken one must not stop the
                # bundle.
                logger.debug("anomaly verdict unavailable: %s", e)
        serving = None
        if self._serving_snapshot is not None:
            try:
                serving = self._serving_snapshot()
            except Exception as e:  # noqa: BLE001 — see above.
                logger.debug("serving snapshot unavailable: %s", e)
        extra = {"incident_seq": seq}
        if trigger is not None:
            extra["trigger"] = {k: trigger.get(k) for k in
                                ("kind", "signal", "value", "median",
                                 "deviation", "step", "reason",
                                 "postmortem", "outcome")
                                if trigger.get(k) is not None}
        path = write_incident_bundle(
            self.incidents_dir, reason=reason, kind=kind,
            events_tail=tail, extra=extra, anomaly=anomaly,
            attribution=self._last_attribution, serving=serving)
        if self._tel is not None:
            # "incident_kind", not "kind": the sink uses "kind" as the
            # record type and a kwarg would silently overwrite it (the
            # faults.py "fault_kind" discipline).
            self._tel.event("incident", schema=SCHEMA,
                            incident_kind=kind, reason=reason, seq=seq,
                            path=os.path.relpath(path, self.run_dir))
        return path
