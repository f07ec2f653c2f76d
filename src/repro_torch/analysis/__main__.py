"""CLI: ``python -m repro_torch.analysis [--contracts[=ARMS]] [--lint]
[--smoke] [--tol TOL] [--json PATH]``.

Port of ``repro/analysis/__main__.py``.  With no arm flag, every contract
arm and the lint run.  ``--contracts`` takes an optional comma list of
arms from ``kernel``, ``sharded``, ``train`` (or ``all``).  Output is one
JSON document (schema ``repro_torch/static-analysis/v1``) on stdout, or in
``--json PATH``; the mismatches go to stderr.  The exit code is nonzero
when a contract check fails or the lint finds anything.

Where the JAX CLI sets ``XLA_FLAGS`` to 8 devices, this one makes a fake
world of 8 ranks (``analysis.counts.fake_world``) while the sharded and
train arms run, and destroys it, with the meshes' groups, before it
returns.
"""
from __future__ import annotations

import argparse
import json
import sys

SCHEMA = "repro_torch/static-analysis/v1"

# one small shape a kernel family
SMOKE_SHAPES = {"gemm_epilogue_blocks": [(512, 4096, 128)],
                "attention_blocks": [(1024, 1024, 64)],
                "ssd_chunk_len": [(4096, 64, 128)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static contracts + repo-invariant lint of the port")
    ap.add_argument("--contracts", nargs="?", const="all", default=None,
                    metavar="ARMS",
                    help="run the contract arms; optional comma list of "
                         "kernel,sharded,train (default all)")
    ap.add_argument("--lint", action="store_true",
                    help="run the AST lint (alone unless --contracts)")
    ap.add_argument("--smoke", action="store_true",
                    help="contracts on one small shape per kernel family "
                         "instead of the full paper table")
    ap.add_argument("--tol", type=float, default=None,
                    help="relative tolerance for volume/FLOP contracts")
    ap.add_argument("--json", metavar="PATH", default="-",
                    help="write the JSON report here (default: stdout)")
    args = ap.parse_args(argv)
    run_contracts_arm = args.contracts is not None or not args.lint
    run_lint_arm = args.lint or args.contracts is None

    result = {"schema": SCHEMA}
    ok = True
    if run_contracts_arm:
        from .contracts import ARMS, DEFAULT_TOL, run_contracts
        spec = args.contracts if args.contracts is not None else "all"
        arms = tuple(ARMS) if spec == "all" else tuple(
            a.strip() for a in spec.split(",") if a.strip())
        report = run_contracts(SMOKE_SHAPES if args.smoke else None,
                               arms=arms,
                               tol=args.tol if args.tol is not None
                               else DEFAULT_TOL)
        result["contracts"] = dict(report.to_dict(), arms=list(arms))
        if not report.ok:
            print("contract mismatches:", file=sys.stderr)
            print(report.describe_failures(), file=sys.stderr)
        ok = ok and report.ok
    if run_lint_arm:
        from .lint import lint_repo
        findings = lint_repo()
        result["lint"] = {"findings": [f.to_dict() for f in findings],
                          "count": len(findings), "ok": not findings}
        for f in findings:
            print(f.describe(), file=sys.stderr)
        ok = ok and not findings
    result["ok"] = ok
    text = json.dumps(result, indent=2, sort_keys=True)
    if args.json == "-":
        print(text)
    else:
        with open(args.json, "w") as fh:
            fh.write(text + "\n")
        summary = []
        if "contracts" in result:
            c = result["contracts"]
            summary.append(f"contracts {c['passed']}/{c['checked']} passed")
        if "lint" in result:
            summary.append(f"lint {result['lint']['count']} findings")
        print(f"{'OK' if ok else 'FAIL'}: {', '.join(summary)} -> {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
