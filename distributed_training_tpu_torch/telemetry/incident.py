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

The JAX module's ``IncidentRecorder`` and ``arm_autoprofile`` serve the
training anomaly path and wait for ROADMAP.md queue A item 15.
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

logger = logging.getLogger(__name__)

SCHEMA = 1

# The drop file an in-run profile capture consumes (the JAX package's
# ``telemetry/attribution.py::TRIGGER_FILE``).
TRIGGER_FILE = "profile_now"

# Bundle layout: core files always present, optional files present when
# the corresponding evidence existed at capture.
BUNDLE_CORE_FILES = ("meta.json", "stacks.txt", "events_tail.jsonl",
                     "memory_stats.json")
BUNDLE_OPTIONAL_FILES = ("anomaly.json", "attribution.json",
                         "serving_requests.json")

# Incident kinds the writers emit and the doctor understands.
KINDS = ("anomaly", "watchdog", "preemption", "give_up", "manual",
         "engine_crash")

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
