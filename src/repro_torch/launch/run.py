"""The port's bench chain: one section per paper table or figure, the
kernels, the MoE dispatch model and the roofline of the dry-run
artifacts, under the reference chain's headers.  Prints
``name,us_per_call,derived`` CSV.

    PYTHONPATH=src python -m repro_torch.launch.run [--device cuda|cpu]

``--device`` is where ``kernel_bench`` runs (``cuda`` unless it says
``cpu``: plain versions, untimed); the other four front ends run on the
host.  With no dry-run artifacts (``launch/dryrun.py`` writes them) the
roofline section says it read none.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

# (front end, header): the reference chain's headers
SECTIONS = (
    ("paper_tables",
     "# ================ paper tables (Figs 7-12) ================"),
    ("costmodel_compare",
     "# ================ cost-model compare (Fig 6) ==============="),
    ("kernel_bench",
     "# ================ CUDA kernels ============================="),
    ("moe_dispatch",
     "# ================ MoE dispatch (COMET AllToAll model) ======"),
    ("roofline",
     "# ================ roofline (dry-run artifacts) ============="),
)


def run_all(device: Optional[str] = None) -> Dict:
    """Each front end's ``run_all`` in the chain's order; ``kernel_bench``
    on ``device``.  Returns their results by name."""
    from repro_torch.launch import (costmodel_compare, kernel_bench,
                                    moe_dispatch, paper_tables, roofline)

    calls = {
        "paper_tables": paper_tables.run_all,
        "costmodel_compare": costmodel_compare.run_all,
        "kernel_bench": lambda: kernel_bench.run_all(device),
        "moe_dispatch": moe_dispatch.run_all,
        "roofline": roofline.run_all,
    }
    out = {}
    for name, header in SECTIONS:
        print(header, flush=True)
        out[name] = calls[name]()
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where kernel_bench runs: cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_all(args.device)


if __name__ == "__main__":
    main()
