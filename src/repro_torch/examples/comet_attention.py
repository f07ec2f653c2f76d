"""Case study: optimize self-attention dataflows with COMET (paper §V-D2)
and show the card integration — the same cost model picks the
FlashAttention and fused GEMM-epilogue kernels' tiles on ``h100()`` and
the vocab-softmax collective strategy the training step uses.

Port of ``examples/comet_attention.py`` on the port's core: its UA / PFA /
FA lines and its collective-planner lines are the original's (the same
search on the same presets; the planner prices on ``tpu_v5e()`` as the
JAX package does); its block lines are the port's plans for its Hopper
kernels.  Runs on the host; no device is touched.

    PYTHONPATH=src python -m repro_torch.examples.comet_attention
"""
import time

from repro_torch.core import attention, flash_attention
from repro_torch.core.hardware import cloud, edge
from repro_torch.core.plan import get_plan_cache
from repro_torch.core.search import search
from repro_torch.kernels.autotune import (attention_blocks,
                                          gemm_epilogue_blocks)
from repro_torch.parallel.collective_planner import plan_softmax_strategy

PLANNER_SHAPES = ((65536, 151552), (128, 129280), (1, 4096))


def variant_lines():
    """The UA / PFA / FA lines (Table III/IV shapes on edge and cloud)."""
    out = []
    for arch in (edge(), cloud()):
        for (M, K, N, L) in ((1024, 256, 1024, 256), (1, 128, 8192, 128)):
            ua = search(attention(M, K, N, L), arch, budget=300, seed=0,
                        variants=["ua"]).latency
            pfa = search(attention(M, K, N, L), arch, budget=300, seed=0,
                         variants=["pfa"]).latency
            fa = search(flash_attention(M, K, N, L), arch, budget=300,
                        seed=0, variants=["fa"]).latency
            out.append(f"  {arch.name:5s} M={M:5d} N={N:5d}: "
                       f"UA {ua*1e6:8.1f}us | PFA {pfa*1e6:8.1f}us | "
                       f"FA {fa*1e6:8.1f}us  (FA speedup {ua/fa:4.2f}x)")
    return out


def planner_lines():
    """The collective planner's vocab-sharded softmax strategies."""
    return [f"  rows={rows:6d} vocab={cols:6d} x16 shards -> "
            f"{plan_softmax_strategy(rows, cols, participants=16)}"
            for rows, cols in PLANNER_SHAPES]


def main() -> None:
    print("== UA / PFA / FA across paper shapes (Table III/IV) ==")
    for line in variant_lines():
        print(line)

    print("\n== card integration: COMET-tuned H100 kernel tiles ==")
    print("   (each selection resolves through the PlanCache: first call")
    print("   solves and persists a plan, later calls/processes look up)")
    for (sq, skv, d) in ((4096, 4096, 128), (1, 32768, 128),
                         (32768, 32768, 64)):
        t0 = time.perf_counter()
        bq, bk = attention_blocks(sq, skv, d)
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        attention_blocks(sq, skv, d)
        warm = time.perf_counter() - t0
        print(f"  flash_attention S={sq:6d}/{skv:6d} d={d:4d} "
              f"-> block_q={bq}, block_k={bk}  "
              f"(cold {cold * 1e3:5.1f}ms, warm {warm * 1e6:5.1f}us)")
    bm, bn = gemm_epilogue_blocks(4096, 8192, 4096)
    print(f"  gemm_softmax 4096x8192x4096 -> block_m={bm}, block_n={bn}")
    stats = get_plan_cache().stats
    print(f"  plan cache: {stats['misses']} solved, "
          f"{stats['hits_mem'] + stats['hits_disk']} hits "
          f"(store: {get_plan_cache().root})")

    print("\n== collective planner: vocab-sharded softmax strategy ==")
    for line in planner_lines():
        print(line)


if __name__ == "__main__":
    main()
