"""The audit: findings over one step's collectives and placements (port
of ``analysis/audit.py``).

For each named target (``targets.py``) this runs one step of the port's
Trainer (or the serving engine's gated launch) on a world of the
target's processes (``compile.py``), with its collectives recorded
(``telemetry/collectives.py``), and derives JAX's finding classes under
JAX's codes and fingerprints:

- **SPMD001 involuntary reshard**: XLA's partitioner warning. The port
  has no partitioner, so the code never fires: every SPMD001 count is 0
  and the targets' ``pin_zero`` pins hold trivially (``pinned_violations``
  still checks them, so a future source of the finding would be gated).
- **SPMD002 unattributed collective**: a recorded collective whose group
  is none of the mesh's axis groupings (``mesh_axis_groupings``): the
  step communicates over processes its mesh does not describe.
- **SPMD003 replicated large parameter**: under a model-sharded mesh
  (fsdp × tp > 1), a parameter above the size floor that the trainer's
  placements leave whole on every process. The same leaves, names,
  bytes and fingerprints as JAX's ``_replicated_param_findings``.

Findings carry stable fingerprints; ``baseline.py`` ratchets them.
"""

from __future__ import annotations

import math

from distributed_training_tpu_torch.analysis import baseline as baseline_lib
from distributed_training_tpu_torch.analysis import targets as targets_lib

SCHEMA = 1

CODES = {
    "SPMD001": "involuntary full rematerialization (reshard cliff)",
    "SPMD002": "collective matches no declared mesh-axis grouping",
    "SPMD003": "large parameter fully replicated under a sharded "
               "strategy",
}


def _finding(code: str, target: str, fingerprint: str, message: str,
             **detail) -> dict:
    return {"code": code, "target": target,
            "fingerprint": fingerprint, "message": message,
            "detail": detail}


def _unattributed_findings(target, coll_report: dict) -> list[dict]:
    """SPMD002 rows: collectives whose group matched no mesh-axis
    grouping. Fingerprinted by kind+type (not count): the ratchet
    catches new SHAPES of unattributed traffic."""
    rows = [r for r in coll_report.get("rows", [])
            if r.get("axes") == "unknown"]
    by_fp: dict[str, dict] = {}
    for r in rows:
        fp = (f"SPMD002:{target.name}:{r['kind']}:"
              f"{r['dtype']}[{r['shape']}]")
        if fp in by_fp:
            by_fp[fp]["detail"]["count"] += 1
            continue
        by_fp[fp] = _finding(
            "SPMD002", target.name, fp,
            f"{r['kind']} {r['dtype']}[{r['shape']}] communicates "
            "over a process group matching no declared mesh-axis "
            "grouping",
            kind=r["kind"], dtype=r["dtype"], shape=r["shape"],
            bytes=r["bytes"], count=1)
    return list(by_fp.values())


def replicated_param_findings(target, shapes: dict, itemsizes: dict,
                              placements: dict, sizes: dict,
                              min_bytes: int) -> list[dict]:
    """SPMD003 findings from whole leaf ``shapes`` and ``itemsizes``
    (flat ``a/b`` paths) and their ``placements`` (path → ``Placement``
    or None) over a mesh of axis ``sizes``."""
    model_shards = sizes.get("fsdp", 1) * sizes.get("tp", 1)
    if model_shards <= 1:
        return []  # nothing claims to shard the model; rule is moot
    nbytes = {k: math.prod(s) * itemsizes[k] for k, s in shapes.items()}
    per_device = 0
    for k, n in nbytes.items():
        pl = placements.get(k)
        per_device += n // math.prod(sizes[a] for a in (pl.axes if pl
                                                          else ()))
    per_device = max(1, per_device)
    out: list[dict] = []
    for name, n in nbytes.items():
        pl = placements.get(name)
        if (pl is not None and pl.splits) or n < min_bytes:
            continue
        fp = f"SPMD003:{target.name}:{name}"
        out.append(_finding(
            "SPMD003", target.name, fp,
            f"param {name} ({n / 2**20:.1f} MiB) fully replicated under "
            f"a {model_shards}x model-sharded mesh — "
            f"{100 * n / per_device:.0f}% of per-device param residency",
            param=name, bytes=n, per_device_param_bytes=per_device,
            mesh={a: s for a, s in sizes.items() if s > 1}))
    return sorted(out, key=lambda f: -f["detail"]["bytes"])


def _record(target, coll: dict, findings: list[dict]) -> dict:
    from distributed_training_tpu_torch.telemetry import collectives

    by_code: dict[str, int] = {}
    for f in findings:
        by_code[f["code"]] = by_code.get(f["code"], 0) + 1
    return {
        "target": target.name,
        "title": target.title,
        "devices": target.devices,
        "strategy": target.strategy,
        "mesh": dict(coll["mesh"]),
        # No partitioner: no reshard warning, so no SPMD001.
        "spmd_reshard_warnings": 0,
        "findings": findings,
        "findings_by_code": by_code,
        "collectives": collectives.summary_of_event(coll),
    }


def audit_target(target, device, min_replicated_bytes: int = 1 << 20
                 ) -> dict | None:
    """One target's audit record, run on the world the caller started
    (``target.devices`` processes, or this one alone): its step's
    collectives and findings. None on a process other than the
    coordinator."""
    import torch.distributed as dist

    from distributed_training_tpu_torch.analysis import compile as build
    from distributed_training_tpu_torch.train.optimizer import flatten

    if target.kind == "serving":
        coll = build.serving_step_report(target, device)
        if dist.is_initialized() and dist.get_rank() != 0:
            return None
        return _record(target, coll,
                       _unattributed_findings(target, coll))
    rt = build.target_runtime(target, device)
    trainer, coll = build.train_step_report(target, rt)
    if coll is None:
        return None
    pls = (trainer.layout or {}).get("params", {})
    shapes = flatten(trainer.model.param_shapes())
    state = flatten(trainer.state["params"])
    findings = (_unattributed_findings(target, coll)
                + replicated_param_findings(
                    target, shapes,
                    {k: state[k].element_size() for k in shapes},
                    pls, rt.spec.as_dict(), min_replicated_bytes))
    return _record(target, coll, findings)


def audit_records(names=None, device="cuda",
                  min_replicated_bytes: int = 1 << 20) -> list[dict]:
    """The audit records of targets ``names`` (all when falsy), in
    order: the one-device targets in this process, the others in one
    spawned world per device count."""
    from distributed_training_tpu_torch.analysis import compile as build

    chosen = targets_lib.resolve(names)
    by_size: dict[int, list] = {}
    for t in chosen:
        by_size.setdefault(t.devices, []).append(t.name)
    got: dict[str, dict] = {}
    for n, group in by_size.items():
        if n == 1:
            for name in group:
                got[name] = audit_target(targets_lib.TARGETS[name], device,
                                         min_replicated_bytes)
        else:
            for rec in build.run_world(group, n, device,
                                       min_replicated_bytes):
                got[rec["target"]] = rec
    return [got[t.name] for t in chosen]


def audit_targets(names=None, device="cuda",
                  min_replicated_bytes: int = 1 << 20) -> dict:
    """The full ``spmd_audit.json`` document (``schema: 1``)."""
    return assemble_doc(audit_records(names, device, min_replicated_bytes))


def assemble_doc(records: list[dict]) -> dict:
    """Wrap per-target audit records into the spmd_audit.json shape."""
    by_code: dict[str, int] = {}
    for r in records:
        for c, n in r["findings_by_code"].items():
            by_code[c] = by_code.get(c, 0) + n
    return {
        "schema": SCHEMA,
        "codes": CODES,
        "targets": records,
        "totals": {
            "targets": len(records),
            "findings": sum(len(r["findings"]) for r in records),
            "by_code": by_code,
        },
    }


def all_findings(audit_doc: dict) -> list[dict]:
    return [f for r in audit_doc["targets"] for f in r["findings"]]


def pinned_violations(audit_doc: dict) -> list[str]:
    """Violations of per-target ``pin_zero`` pins: a finding whose code
    the target pins to zero fails the gate EVEN IF its fingerprint is
    baselined."""
    out: list[str] = []
    for r in audit_doc["targets"]:
        t = targets_lib.TARGETS.get(r["target"])
        pins = tuple(getattr(t, "pin_zero", ()) or ()) if t else ()
        for code in pins:
            n = r["findings_by_code"].get(code, 0)
            if n:
                out.append(
                    f"{r['target']}: {n} {code} finding(s), but this "
                    f"target pins {code} to ZERO "
                    f"({CODES.get(code, '?')})")
    return out


def render_report(audit_doc: dict, cmp: dict | None = None
                  ) -> list[str]:
    """Human report lines. With ``cmp`` (``baseline.compare`` output)
    each finding is tagged [known]/[NEW] and stale baseline entries
    are listed for burn-down."""
    from distributed_training_tpu_torch.telemetry import collectives

    new_fps = set(f["fingerprint"] for f in cmp["new"]) if cmp else set()
    lines: list[str] = []
    for r in audit_doc["targets"]:
        mesh = ",".join(f"{a}={s}" for a, s in r["mesh"].items()) \
            or "single-device"
        lines.append(f"== {r['target']}: {r['title']}")
        lines.append(f"   devices={r['devices']} strategy="
                     f"{r['strategy']} mesh={mesh}")
        for line in collectives.render_lines(r["collectives"]):
            lines.append("   " + line)
        if not r["findings"]:
            lines.append("   findings: none")
        for f in r["findings"]:
            tag = ""
            if cmp:
                tag = "[NEW] " if f["fingerprint"] in new_fps \
                    else "[known] "
            lines.append(f"   {f['code']} {tag}{f['message']}")
    if cmp:
        lines.append(
            f"baseline: {len(cmp['known'])} known, "
            f"{len(cmp['new'])} NEW, {len(cmp['stale'])} stale")
        for fp in cmp["stale"]:
            lines.append(f"   stale baseline entry (fixed? tighten "
                         f"{baseline_lib.DEFAULT_PATH}): {fp}")
    return lines
