"""Calibration tables: fingerprinted measured-hardware curves (port of
``calibration/table.py``, a copy: the JAX module imports no jax, but
importing it would import the JAX package root, which does).

A table holds the measured points ``benchmarks/calibrate.py``
produced for one ``device_kind`` — per-collective ``(accounted_bytes,
seconds)`` curves and a ``(flops, flops_per_s)`` achievable-matmul
curve — plus enough provenance (platform, device count, backend
versions) to judge whether it still describes the hardware. The
committed artifacts live at ``conf/calibration/<chip>.json``, shared by
both packages. The port's ``calibration/microbench.py`` measures tables
in the same format; it commits none for the card (gloo between
processes on one card measures the host, not a link).

Conventions (shared with the planner's comms accounting — the table
exists to be evaluated on exactly the bytes ``score_candidate``
counts):

- ``all-gather``: x = bytes of the full gathered tensor;
- ``reduce-scatter``: x = bytes of the full reduced+scattered tensor;
- ``all-reduce``: x = 2x the tensor bytes (the ring's reduce-scatter
  + all-gather phases — the planner's ``2 * P`` convention);
- ``ppermute``: x = bytes each device ships per step through its
  permute links.

Interpolation is piecewise-linear between measured points: below the
smallest point the smallest point's time is the LATENCY FLOOR (a
1-byte collective does not get faster than the wire's round trip);
above the largest point the tail segment's bandwidth extrapolates.
The matmul curve is clamped at both ends (achievable FLOPs saturate).
Every lookup is the JAX module's, operation for operation, so both
packages score a plan from the same floats.

Integrity mirrors the plan-artifact discipline (``parallel/
planner.py``): a sha256 fingerprint over the canonical body, verified
at load — a hand-edited table refuses to load rather than silently
re-ranking every plan built from it.

Stdlib only: the planner reads tables without touching a device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import NamedTuple

SCHEMA = 1

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CALIB_DIR = os.path.join(REPO, "conf", "calibration")

# The collective kinds the planner's comms model prices — exactly the
# set benchmarks/calibrate.py measures.
COLLECTIVE_KINDS = ("all-gather", "reduce-scatter", "all-reduce",
                    "ppermute")

# device_kind -> committed-file slug. "TPU v5 lite" and "v5e" are the
# same silicon (utils/metrics.py's substring-matching lesson); longest
# key first so "v5 lite" wins before a hypothetical "v5".
_SLUGS = {
    "v5 lite": "v5e",
    "v5litepod": "v5e",
    "v5e": "v5e",
    "v5p": "v5p",
    "v6e": "v6e",
    "v6 lite": "v6e",
    "v4": "v4",
    "cpu": "cpu",
}


class CalibrationError(ValueError):
    pass


def chip_slug(device_kind: str) -> str:
    """Canonical file slug for a ``device_kind`` string (runtime
    ``device_kind`` and planner ``chip`` names both normalize here, so
    a table measured on 'TPU v5 lite' serves a target chip 'v5e')."""
    kind = device_kind.lower()
    for key in sorted(_SLUGS, key=len, reverse=True):
        if key in kind:
            return _SLUGS[key]
    return "".join(c if c.isalnum() else "_" for c in kind).strip("_")


def _canon(obj):
    return json.loads(json.dumps(obj, sort_keys=True))


@dataclass
class CalibrationTable:
    """Measured curves for one device kind (module docstring has the
    x-axis conventions). ``collectives`` maps kind -> sorted
    ``[[accounted_bytes, seconds], ...]``; ``matmul`` is sorted
    ``[[flops, flops_per_s], ...]``."""

    device_kind: str
    platform: str
    n_devices: int
    collectives: dict = field(default_factory=dict)
    matmul: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.collectives = {
            k: sorted([float(b), float(s)] for b, s in pts)
            for k, pts in self.collectives.items()}
        self.matmul = sorted([float(f), float(r)]
                             for f, r in self.matmul)

    def fingerprint(self) -> str:
        body = dataclasses.asdict(self)
        blob = json.dumps(_canon(body), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- cost-model lookups -------------------------------------------

    def collective_seconds(self, kind: str, nbytes: float) -> float:
        """Seconds for ``nbytes`` accounted bytes of ``kind``
        (piecewise-linear; latency floor below the smallest measured
        point, tail-bandwidth extrapolation above the largest)."""
        pts = self.collectives.get(kind)
        if not pts:
            raise CalibrationError(
                f"calibration table for '{self.device_kind}' has no "
                f"curve for collective kind '{kind}' "
                f"(has: {sorted(self.collectives)})")
        if nbytes <= pts[0][0]:
            return pts[0][1]
        if nbytes >= pts[-1][0]:
            if len(pts) >= 2:
                (b0, t0), (b1, t1) = pts[-2], pts[-1]
                if t1 > t0 and b1 > b0:
                    return t1 + (nbytes - b1) * (t1 - t0) / (b1 - b0)
            # Degenerate tail (single point / non-monotonic noise):
            # scale by the last point's aggregate rate.
            return pts[-1][1] * nbytes / max(pts[-1][0], 1.0)
        for (b0, t0), (b1, t1) in zip(pts, pts[1:]):
            if b0 <= nbytes <= b1:
                if b1 == b0:
                    return max(t0, t1)
                w = (nbytes - b0) / (b1 - b0)
                return t0 + w * (t1 - t0)
        return pts[-1][1]  # unreachable; defensive

    def achievable_flops_per_s(self, flops: float) -> float:
        """Achieved matmul FLOPs/s at problem size ``flops``
        (piecewise-linear, clamped at both ends — achievable
        throughput saturates, it does not extrapolate)."""
        pts = self.matmul
        if not pts:
            raise CalibrationError(
                f"calibration table for '{self.device_kind}' has no "
                "matmul curve")
        if flops <= pts[0][0]:
            return pts[0][1]
        if flops >= pts[-1][0]:
            return pts[-1][1]
        for (f0, r0), (f1, r1) in zip(pts, pts[1:]):
            if f0 <= flops <= f1:
                if f1 == f0:
                    return max(r0, r1)
                w = (flops - f0) / (f1 - f0)
                return r0 + w * (r1 - r0)
        return pts[-1][1]  # unreachable; defensive

    def fitted_summary(self) -> dict:
        """Human-facing piecewise-fit summary: per-kind latency floor
        and peak bandwidth, peak achieved matmul FLOPs/s. Derived,
        informational — the load-bearing data is the points."""
        out: dict = {"collectives": {}, "matmul": {}}
        for kind, pts in self.collectives.items():
            out["collectives"][kind] = {
                "latency_s": pts[0][1],
                "peak_bytes_per_s": max(
                    (b / t) for b, t in pts if t > 0),
            }
        if self.matmul:
            out["matmul"] = {
                "peak_flops_per_s": max(r for _f, r in self.matmul)}
        return out

    # -- (de)serialization --------------------------------------------

    def to_doc(self) -> dict:
        return {
            "schema": SCHEMA,
            "fingerprint": self.fingerprint(),
            **dataclasses.asdict(self),
            "fitted": self.fitted_summary(),
        }

    @staticmethod
    def from_doc(doc: dict) -> "CalibrationTable":
        if doc.get("schema") != SCHEMA:
            raise CalibrationError(
                f"calibration table schema {doc.get('schema')!r} != "
                f"{SCHEMA} — regenerate with benchmarks/calibrate.py")
        table = CalibrationTable(**{
            k: doc[k] for k in ("device_kind", "platform", "n_devices",
                                "collectives", "matmul", "meta")})
        recorded = doc.get("fingerprint")
        if recorded and recorded != table.fingerprint():
            raise CalibrationError(
                f"calibration table for '{table.device_kind}' "
                f"fingerprint mismatch: file says {recorded}, content "
                f"hashes to {table.fingerprint()} — the file was "
                "hand-edited; re-measure with benchmarks/calibrate.py")
        return table


def table_path(chip: str, calib_dir: str | None = None) -> str:
    return os.path.join(calib_dir or CALIB_DIR,
                        f"{chip_slug(chip)}.json")


def load_table(path: str) -> CalibrationTable:
    with open(path, encoding="utf-8") as f:
        return CalibrationTable.from_doc(json.load(f))


def save_table(table: CalibrationTable,
               path: str | None = None) -> str:
    path = path or table_path(table.device_kind)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(table.to_doc(), f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


class CalibrationLookup(NamedTuple):
    """Result of resolving a chip's committed table. ``status`` is
    the STRUCTURED signal consumers branch on (``"measured"`` /
    ``"missing"`` / ``"unusable"``) — the ``note`` is human/
    provenance prose and free to be reworded."""

    table: CalibrationTable | None
    note: str
    status: str


def lookup_for_chip(chip: str, calib_dir: str | None = None
                    ) -> CalibrationLookup:
    """The committed table matching ``chip``, or None with the reason.

    The note is plan-provenance material either way: which file fed
    the cost model, or WHY the planner fell back to nominal
    constants. An unusable committed table (tampered, truncated,
    wrong schema) falls back LOUDLY (``status="unusable"``) rather
    than failing the search: a stale calibration must not brick
    planning, but the plan must say its scores are nominal."""
    path = table_path(chip, calib_dir)
    if not os.path.exists(path):
        return CalibrationLookup(
            None,
            f"no committed calibration table for chip '{chip}' "
            f"({os.path.relpath(path, REPO)}); using nominal "
            "constants",
            "missing")
    try:
        table = load_table(path)
    # KeyError/TypeError: structurally malformed docs (missing keys,
    # wrong point shapes) — every way a committed file can be broken
    # must land in the documented loud-fallback path, never a
    # planner-bricking traceback.
    except (CalibrationError, OSError, ValueError, KeyError,
            TypeError) as e:
        return CalibrationLookup(
            None,
            f"committed calibration table "
            f"{os.path.relpath(path, REPO)} is unusable ({e}); "
            "FALLING BACK to nominal constants — re-measure with "
            "benchmarks/calibrate.py",
            "unusable")
    return CalibrationLookup(
        table,
        f"calibrated from {os.path.relpath(path, REPO)} "
        f"(device_kind '{table.device_kind}', "
        f"fingerprint {table.fingerprint()})",
        "measured")
