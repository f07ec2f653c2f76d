"""Roofline table from the port's dry-run artifacts.

Port of ``benchmarks/roofline.py``.  Reads ``artifacts/dryrun_torch/*.json``
(``launch/dryrun.py``) and prints, per (arch x shape x mesh): the three
roofline terms, the dominant bottleneck, MODEL_FLOPS over the counted
FLOPs (useful-compute ratio) and the memory a rank holds; ``--markdown``
emits a markdown table.  Every term is a prediction from the H100's
data-sheet constants (``analysis/roofline.py``), never a time.

The collective term uses the reconciled wire volume: the recorded
collectives against the declared ``gspmd`` schedule, charging the larger
side on a disagreement.  The ``recon`` column counts the reconciliation's
findings (0: they agree everywhere within tolerance).

    python -m repro_torch.launch.roofline [--markdown] [--tag TAG] [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import Counter
from typing import Dict, List, Optional

from .dryrun import ARTIFACT_DIR

__all__ = ["load", "row", "print_table", "run_all", "main"]


def load(tag_filter: str = "", art_dir: Optional[str] = None) -> List[Dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(art_dir or ARTIFACT_DIR,
                                           "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if (r.get("tag") or "") != tag_filter:
            continue
        recs.append(r)
    return recs


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def row(r: Dict) -> Dict:
    rf = r["roofline"]
    mem = r.get("memory", {})
    rc = r.get("reconcile", {})
    return {
        "cell": f"{r['arch']}×{r['shape']}×{r['mesh']}",
        "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
        "t_compute": rf["t_compute_s"], "t_memory": rf["t_memory_s"],
        "t_collective": rf["t_collective_s"],
        "bottleneck": rf["bottleneck"],
        "useful": r.get("useful_flop_ratio", 0.0),
        "flops_per_dev": r.get("structural_flops_per_device", 0.0),
        "mem_per_dev": mem.get("argument_bytes", 0) + mem.get("temp_bytes",
                                                              0),
        "trace_s": r.get("trace_s", 0.0),
        "wire_reconciled": rc.get("total_reconciled_wire",
                                  r.get("collective_wire_per_device", 0.0)),
        "wire_recorded": rc.get("total_hlo_wire", 0.0),
        "recon_findings": len(rc.get("findings", [])),
        "recon_clean": bool(rc.get("clean", True)),
    }


def print_table(recs: List[Dict], markdown: bool = False) -> None:
    rows = sorted((row(r) for r in recs),
                  key=lambda x: (x["arch"], x["shape"], x["mesh"]))
    if markdown:
        print("| arch | shape | mesh | t_compute | t_memory | t_collective |"
              " bottleneck | useful FLOP ratio | bytes/device |"
              " wire/device (reconciled) | recon |")
        print("|---|---|---|---|---|---|---|---|---|---|---|")
        for x in rows:
            recon = ("clean" if x["recon_clean"]
                     else f"{x['recon_findings']} findings")
            print(f"| {x['arch']} | {x['shape']} | {x['mesh']} "
                  f"| {x['t_compute']:.3e} | {x['t_memory']:.3e} "
                  f"| {x['t_collective']:.3e} | **{x['bottleneck']}** "
                  f"| {x['useful']:.2f} | {fmt_bytes(x['mem_per_dev'])} "
                  f"| {fmt_bytes(x['wire_reconciled'])} | {recon} |")
        return
    for x in rows:
        recon = ("clean" if x["recon_clean"]
                 else f"{x['recon_findings']}findings")
        print(f"roofline_{x['cell']},{x['t_compute']*1e6:.1f},"
              f"mem={x['t_memory']*1e6:.1f}us;"
              f"coll={x['t_collective']*1e6:.1f}us;"
              f"bott={x['bottleneck']};useful={x['useful']:.2f};"
              f"bytes/dev={fmt_bytes(x['mem_per_dev'])};"
              f"wire/dev={fmt_bytes(x['wire_reconciled'])};"
              f"recon={recon}")


def run_all(art_dir: Optional[str] = None) -> Dict:
    recs = load(art_dir=art_dir)
    print(f"# --- roofline (predicted) from {len(recs)} dry-run artifacts ---")
    print_table(recs)
    bt = Counter(r["roofline"]["bottleneck"] for r in recs)
    print(f"roofline_summary,{len(recs)},bottlenecks={dict(bt)}")
    return {"n": len(recs), "bottlenecks": dict(bt)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--dir", default=None,
                    help="artifact directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    print_table(load(args.tag, args.dir), markdown=args.markdown)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
