"""Quickstart: COMET mapping search for a GEMM-Softmax compound op.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Searches the 4-D mapping space (tiling x spatial x collectives x schedule)
on the paper's cloud accelerator, prints the best mapping tree with its
explicit collective nodes, and compares the four fusion variants.  Port
of ``examples/quickstart.py`` on the port's core; it runs on the host
alone (the cost model touches no device) and prints what the original
prints.
"""
from repro_torch.core import gemm_softmax
from repro_torch.core.hardware import cloud
from repro_torch.core.ir import MappingSpec, evaluate_mapping
from repro_torch.core.mapping import tree_str
from repro_torch.core.search import search


def main() -> None:
    co = gemm_softmax(M=512, N=4096, K=128)      # GEMM12 (Table II)
    arch = cloud()

    print("== fusion variants (fixed tiling) ==")
    for variant in ("unfused", "fused_epilogue", "fused_std", "fused_dist"):
        r = evaluate_mapping(co, arch, MappingSpec(variant=variant,
                                                   m_tiles=8, k_tiles=2))
        print(f"  {variant:15s} latency={r.latency*1e6:9.2f}us "
              f"energy={r.energy_pj/1e6:8.2f}uJ valid={r.valid}")

    print("\n== map-space search (budget 2000) ==")
    res = search(co, arch, budget=2000, seed=0)
    best = res.best
    print(f"best: {best.spec.variant} m_tiles={best.spec.m_tiles} "
          f"k_tiles={best.spec.k_tiles} sched={best.spec.schedule} "
          f"-> {best.latency*1e6:.2f}us ({res.valid}/{res.evaluated} valid)")
    print("\nmapping tree (T = tile nodes, CO = explicit collectives):")
    print(tree_str(best.root))


if __name__ == "__main__":
    main()
