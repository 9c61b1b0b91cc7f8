"""Baseline ratchet for the audit's findings (port of
``analysis/baseline.py``).

The committed ``spmd_baseline.json`` (the port's own, beside this file)
freezes the KNOWN findings by fingerprint, so the check gate fails only
on new ones. Stale entries (baselined fingerprints no run reproduces
anymore) are reported for burn-down, never failed on. The schema and the
arithmetic are JAX's. JAX's ``OVERLAP_baseline.json`` ratchet is not
carried: it floors XLA's scheduled comms/compute overlap score, which
eager PyTorch has no counterpart of.

Stdlib only.
"""

from __future__ import annotations

import json
import os

SCHEMA = 1

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "spmd_baseline.json")


def load(path: str | None = None) -> dict:
    """The baseline doc ({"schema": 1, "fingerprints": [...]});
    a missing file is an EMPTY baseline — every finding is new."""
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        return {"schema": SCHEMA, "fingerprints": []}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"baseline {path} has schema {doc.get('schema')!r}, "
            f"expected {SCHEMA} — regenerate with --write-baseline")
    return doc


def compare(findings: list[dict], baseline_doc: dict,
            targets: list[str] | None = None) -> dict:
    """Split current findings against the baseline.

    Returns ``{"new": [finding, ...], "known": [finding, ...],
    "stale": [fingerprint, ...]}`` — ``new`` is what fails the gate,
    ``stale`` is baseline debt that no longer reproduces. With
    ``targets`` (a subset audit run), baseline entries for OTHER
    targets are ignored: they were not re-audited, so calling them
    stale would misread "not checked" as "fixed"."""
    base = set(baseline_doc.get("fingerprints", ()))
    if targets is not None:
        tset = set(targets)
        # Fingerprint format: "CODE:<target>:<detail...>".
        base = {fp for fp in base
                if len(fp.split(":", 2)) == 3
                and fp.split(":", 2)[1] in tset}
    seen = {f["fingerprint"] for f in findings}
    return {
        "new": [f for f in findings if f["fingerprint"] not in base],
        "known": [f for f in findings if f["fingerprint"] in base],
        "stale": sorted(base - seen),
    }


def write(findings: list[dict], path: str | None = None,
          note: str = "") -> str:
    """Freeze the given findings as the new baseline (sorted, deduped,
    with messages alongside for the reviewer — only ``fingerprints``
    is load-bearing)."""
    path = path or DEFAULT_PATH
    fps = sorted({f["fingerprint"] for f in findings})
    doc = {
        "schema": SCHEMA,
        "note": note or (
            "Known audit findings of the port, frozen so CI fails only "
            "on NEW ones. Regenerate: python -m "
            "distributed_training_tpu_torch.analysis --write-baseline"),
        "fingerprints": fps,
        "messages": {
            f["fingerprint"]: f["message"]
            for f in sorted(findings, key=lambda x: x["fingerprint"])},
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path
