"""Checkpoint integrity: checksum manifests, quarantine, step scan (port
of ``resilience/integrity.py``, which is framework-free; this is the
port's own copy).

A checkpoint step directory is committed by a rename
(``checkpoint/manager.py``), so one that exists was fully written, but
nothing guards it against later damage: bit rot, a truncating copy, a
cleanup job, or the injected ``corrupt_ckpt`` fault.

- ``write_manifest(step_dir)``: ``manifest.dtt.json``, the sha256 and
  size of every file of a committed step, written atomically (temporary
  file and rename), so a torn manifest cannot exist.
- ``verify_manifest(step_dir)``: recompute and compare. A step without a
  manifest verifies as "unverified, not condemned".
- ``quarantine_step(dir, step, problems)``: rename ``<dir>/<N>`` to
  ``<dir>/step_<N>.corrupt`` (``.2``, ``.3``... on a collision; the
  step scan ignores names that are not numbers) and emit a
  ``ckpt_quarantined`` event. Nothing is deleted.
- ``checkpoint_steps_on_disk(dir)`` / ``latest_step_on_disk(dir)``: the
  step scan the supervisor runs in the launcher process.

Manifests are written by process 0 only; verification is read-only and
the same on every process; a quarantine rename that another process won
is not an error.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time

logger = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.dtt.json"
MANIFEST_SCHEMA = 1
QUARANTINE_SUFFIX = ".corrupt"


# ---------------------------------------------------------------------------
# step scanning (the supervisor's launcher process uses this)
# ---------------------------------------------------------------------------


def checkpoint_steps_on_disk(directory: str) -> list[int]:
    """Committed checkpoint steps under ``directory``, ascending.

    One directory per step named ``<N>``; a save in flight lives in
    ``.tmp-<N>...`` and a quarantined step is ``step_<N>.corrupt``,
    neither of them a number."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    steps = [int(n) for n in names
             if n.isdigit() and os.path.isdir(os.path.join(directory, n))]
    return sorted(steps)


def latest_step_on_disk(directory: str) -> int | None:
    """Newest committed step, or None. (The supervisor's progress
    check uses ``checkpoint_steps_on_disk`` directly — it needs the
    SET of steps, since a quarantine can lower the maximum while the
    run still progresses.)"""
    steps = checkpoint_steps_on_disk(directory)
    return steps[-1] if steps else None


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------


def _iter_files(step_dir: str):
    """Yield (relpath, abspath) for every regular file under
    ``step_dir``, skipping the manifest itself. Sorted for a
    deterministic manifest."""
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, step_dir)
            if rel == MANIFEST_NAME:
                continue
            out.append((rel, path))
    return sorted(out)


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def file_checksums(step_dir: str) -> dict[str, dict]:
    """Per-file ``{"bytes": N, "sha256": hex}`` for the step dir."""
    return {rel: {"bytes": os.path.getsize(path),
                  "sha256": _sha256(path)}
            for rel, path in _iter_files(step_dir)}


def write_manifest(step_dir: str) -> str:
    """Write the checksum manifest atomically; returns its path.

    Call only on a committed step directory: hashing a save in flight
    would record a half-written state."""
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "t": time.time(),
        "files": file_checksums(step_dir),
    }
    path = os.path.join(step_dir, MANIFEST_NAME)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def verify_manifest(step_dir: str) -> tuple[bool, list[str]]:
    """Check the step dir against its manifest.

    Returns ``(verified, problems)``:

    - ``(True, [])`` — manifest present, every file matches.
    - ``(False, [])`` — NO manifest (legacy/pre-manifest checkpoint):
      unverifiable, but not evidence of corruption — the caller
      restores it with a warning rather than quarantining.
    - ``(_, [problems...])`` — mismatches (missing/extra/resized/
      altered files, or an unreadable manifest): quarantine material.
    """
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return False, []
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        expected = manifest["files"]
    except (ValueError, KeyError, OSError) as e:
        return True, [f"unreadable manifest: {type(e).__name__}: {e}"]
    problems: list[str] = []
    actual = dict(_iter_files(step_dir))
    for rel in sorted(set(expected) - set(actual)):
        problems.append(f"missing file: {rel}")
    for rel in sorted(set(actual) - set(expected)):
        problems.append(f"unexpected file: {rel}")
    for rel in sorted(set(expected) & set(actual)):
        want = expected[rel]
        size = os.path.getsize(actual[rel])
        if size != want["bytes"]:
            problems.append(f"size mismatch: {rel} "
                            f"({size} != {want['bytes']})")
            continue  # a resize already condemns; skip the hash work
        if _sha256(actual[rel]) != want["sha256"]:
            problems.append(f"checksum mismatch: {rel}")
    return True, problems


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------


def quarantine_step(directory: str, step: int,
                    problems: list[str] | None = None) -> str | None:
    """Move a condemned step out of the step scan: ``<dir>/<N>`` →
    ``<dir>/step_<N>.corrupt`` (``.2``, ``.3``... if a previous
    incarnation already quarantined an N). Emits a
    ``ckpt_quarantined`` telemetry event. Returns the new path, or
    None if the step dir was already gone (another process won the
    rename race — same outcome, not an error)."""
    src = os.path.join(directory, str(step))
    dst = os.path.join(directory, f"step_{step}{QUARANTINE_SUFFIX}")
    n = 1
    while os.path.exists(dst):
        n += 1
        dst = os.path.join(
            directory, f"step_{step}{QUARANTINE_SUFFIX}.{n}")
    try:
        os.rename(src, dst)
    except FileNotFoundError:
        logger.warning("step %d already quarantined by another process",
                       step)
        return None
    logger.error("QUARANTINED corrupt checkpoint step %d -> %s (%s)",
                 step, dst, "; ".join((problems or ["unspecified"])[:5]))
    from distributed_training_tpu_torch.telemetry import events as telemetry
    telemetry.event("ckpt_quarantined", step=step, path=dst,
                    problems=(problems or [])[:10])
    return dst
