"""CLI: ``python -m distributed_training_tpu_torch.analysis [--check]``.

Runs the pitfall rules (DTT0xx) over the port's files and the audit over
every named target (one step each, on the card unless ``--device cpu``),
writes ``spmd_audit_torch.json`` (``schema: 1``), prints the human
report, and — under ``--check`` — exits nonzero on any rule violation,
any audit finding NOT in the committed baseline (the ratchet) or any
pinned code. ``--write-baseline`` freezes the current findings as the
new known set (a full run only).

    python -m distributed_training_tpu_torch.analysis --check --device cpu
    python -m distributed_training_tpu_torch.analysis --no-audit --check
    python -m distributed_training_tpu_torch.analysis --no-rules \\
        --targets single_chip_headline
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distributed_training_tpu_torch.analysis",
        description="Collectives audit + pitfall lint gate of the port.")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any rule violation or any audit "
                         "finding not in the baseline")
    ap.add_argument("--targets", default="",
                    help="comma-separated audit target names "
                         "(default: all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where each target's step runs (default: the "
                         "CUDA card; a target of several devices runs "
                         "its processes on cuda:0 over gloo)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="where to write the audit document (default "
                         "outputs/analysis/spmd_audit_torch.json; '-' to "
                         "skip)")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="baseline file (default: the committed "
                         "analysis/spmd_baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="freeze current audit findings as the new "
                         "baseline")
    ap.add_argument("--min-replicated-mib", type=float, default=1.0,
                    help="SPMD003 size floor in MiB (default 1)")
    ap.add_argument("--no-audit", action="store_true",
                    help="rules only (no steps run)")
    ap.add_argument("--no-rules", action="store_true",
                    help="audit only")
    args = ap.parse_args(argv)

    rc = 0
    if not args.no_rules:
        from distributed_training_tpu_torch.analysis import pitfalls
        problems = pitfalls.run_rules()
        for p in problems:
            print(p)
        print(f"[analysis] rules: {len(problems)} violation(s)")
        if problems:
            rc = 1

    if not args.no_audit:
        from distributed_training_tpu_torch.analysis import audit, baseline
        names = [n for n in args.targets.split(",") if n] or None
        if args.write_baseline and names:
            # A subset run must never rewrite the committed baseline:
            # write() replaces it wholesale, so the unselected targets'
            # known findings would vanish.
            ap.error("--write-baseline requires a full run "
                     "(drop --targets)")
        doc = audit.audit_targets(
            names, device=args.device,
            min_replicated_bytes=int(args.min_replicated_mib * 2**20))
        if args.write_baseline:
            path = baseline.write(audit.all_findings(doc),
                                  path=args.baseline)
            print(f"[analysis] baseline written: {path} "
                  f"({doc['totals']['findings']} finding(s))")
        cmp = baseline.compare(audit.all_findings(doc),
                               baseline.load(args.baseline),
                               targets=names)
        for line in audit.render_report(doc, cmp):
            print(line)
        json_path = args.json or os.path.join(
            "outputs", "analysis", "spmd_audit_torch.json")
        if json_path != "-":
            if os.path.dirname(json_path):
                os.makedirs(os.path.dirname(json_path), exist_ok=True)
            with open(json_path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"[analysis] audit written: {json_path}")
        if cmp["new"] and not args.write_baseline:
            print(f"[analysis] {len(cmp['new'])} NEW audit "
                  "finding(s) not in baseline")
            rc = 1
        pins = audit.pinned_violations(doc)
        for p in pins:
            print(f"[analysis] PIN violation: {p}")
        if pins:
            rc = 1

    return rc if args.check else 0


if __name__ == "__main__":
    sys.exit(main())
