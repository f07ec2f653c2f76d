"""Benchmarks reproducing the paper's tables/figures (§V).

Each function prints CSV rows ``name,us_per_call,derived`` and returns a
dict of headline numbers (geomeans compared against the paper's claims).

Port of ``benchmarks/paper_tables.py`` on the port's core, a bit-equal
copy of the JAX package's: on ``edge()``/``cloud()`` every number equals
the original's at the same seed and budget.  :func:`export_plans` exports
the port's kernel plans, ``kernels.autotune.plan_jobs`` on ``h100()``:
its job keys are the original's, its plans are the card's.  The cost
model runs on the host; no device is touched.

    PYTHONPATH=src python -m repro_torch.launch.paper_tables
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

from repro_torch.core import (attention, flash_attention, gemm_layernorm,
                        gemm_softmax)
from repro_torch.core.batcheval import Topology, evaluate_specs_batch
from repro_torch.core.hardware import cloud, edge
from repro_torch.core.ir import MappingSpec, evaluate_mapping
from repro_torch.core.search import search_many

# Tables I / II
GEMMS_EDGE = [(1, 1024, 64), (1, 4096, 128), (256, 1024, 128),
              (4, 1024, 128), (512, 1024, 128), (512, 1024, 64)]
GEMMS_CLOUD = [(1, 16384, 128), (1, 2048, 64), (256, 4096, 128),
               (4, 8192, 128), (512, 2048, 64), (512, 4096, 128)]
# Tables III / IV  (M, K, N, L)
ATTN_EDGE = [(1024, 256, 1024, 256), (1, 128, 1024, 128),
             (1, 256, 2048, 256), (1, 256, 512, 256),
             (256, 128, 256, 128), (512, 128, 256, 128)]
ATTN_CLOUD = [(1024, 512, 1024, 512), (1, 128, 16384, 128),
              (1, 512, 4096, 512), (1, 128, 8192, 128),
              (2048, 256, 2048, 256), (256, 512, 256, 512)]

BUDGET = 250

# Full paper-table search axes: the m/k/n temporal tilings are
# divisor-extended on top of the divisor-complete spatial fanouts.  The
# exhaustive limit was re-budgeted (EXHAUSTIVE_LIMIT 64k -> 128k) so
# every paper-table cell — including the non-pow2 provisioning GEMMs on
# cloud, whose spaces reach ~117k points — still enumerates exhaustively
# instead of falling back to sampling.  Sweeps fan out through
# ``search_many``'s default executor, i.e. the shared-memory process
# pool for table-sized job counts.
SEARCH_KW = {"divisor_tilings": True}

# Non-pow2 provisioning showcase shapes (M, N, K with 3*2^k factors): the
# divisor-complete fanout axes add 3/6-way unrollings the pow2 sets never
# enumerate.  Shared with benchmarks/search_throughput.py (schema-v4
# provisioning gates).
PROVISIONING_GEMMS = [(384, 768, 96), (768, 1536, 192)]


def _geomean(xs: List[float]) -> float:
    return math.exp(sum(math.log(max(x, 1e-12)) for x in xs) / len(xs))


VARIANTS = ("unfused", "fused_epilogue", "fused_std", "fused_dist")


def fusion_comparison(workload_fn, label: str, paper_claim: float) -> Dict:
    """Figs 10/11: latency & energy of each fusion mapping vs unfused.

    All (shape, arch, variant) cells fan out through the search_many
    sweep; each cell is an exhaustive batched search.
    """
    rows = []
    lat_ratios, en_ratios = [], []
    t0 = time.time()
    grids = ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud()))
    jobs = [(workload_fn(M, N, K), arch,
             dict(SEARCH_KW, budget=BUDGET, seed=1, variants=[v]))
            for shapes, arch in grids
            for (M, N, K) in shapes
            for v in VARIANTS]
    results = iter(search_many(jobs))
    for shapes, arch in grids:
        for i, (M, N, K) in enumerate(shapes):
            res = {v: next(results) for v in VARIANTS}
            best_fused = min(("fused_epilogue", "fused_std", "fused_dist"),
                             key=lambda v: res[v].latency)
            lat_r = res["unfused"].latency / res[best_fused].latency
            en_r = res["unfused"].energy_pj / res[best_fused].energy_pj
            lat_ratios.append(lat_r)
            en_ratios.append(en_r)
            rows.append((f"{label}_{arch.name}_G{i+1}",
                         res[best_fused].latency * 1e6,
                         f"best={best_fused};lat_speedup={lat_r:.2f};"
                         f"energy_red={en_r:.2f}"))
    g_lat, g_en = _geomean(lat_ratios), _geomean(en_ratios)
    for name, us, derived in rows:
        print(f"{name},{us:.2f},{derived}")
    print(f"{label}_geomean,{(time.time()-t0)*1e6/len(rows):.0f},"
          f"lat={g_lat:.2f}x(paper {paper_claim}x);energy={g_en:.2f}x")
    return {"geomean_latency_speedup": g_lat, "geomean_energy": g_en,
            "paper_claim": paper_claim}


def attention_variants() -> Dict:
    """Fig 12: UA / PFA / FA latency & energy (paper: 1.82x / 1.54x FA)."""
    lat_ratios, en_ratios = [], []
    grids = ((ATTN_EDGE, edge()), (ATTN_CLOUD, cloud()))
    jobs = []
    for shapes, arch in grids:
        for (M, K, N, L) in shapes:
            jobs += [
                (attention(M, K, N, L), arch,
                 dict(SEARCH_KW, budget=BUDGET, seed=1, variants=["ua"])),
                (attention(M, K, N, L), arch,
                 dict(SEARCH_KW, budget=BUDGET, seed=1, variants=["pfa"])),
                (flash_attention(M, K, N, L), arch,
                 dict(SEARCH_KW, budget=BUDGET, seed=1, variants=["fa"])),
            ]
    results = iter(search_many(jobs))
    for shapes, arch in grids:
        for i, (M, K, N, L) in enumerate(shapes):
            ua = next(results).best
            pfa = next(results).best
            fa = next(results).best
            lat_ratios.append(ua.latency / fa.latency)
            en_ratios.append(ua.energy_pj / fa.energy_pj)
            print(f"attn_{arch.name}_A{i+1},{fa.latency*1e6:.2f},"
                  f"ua={ua.latency*1e6:.1f}us;pfa={pfa.latency*1e6:.1f}us;"
                  f"fa_speedup={ua.latency/fa.latency:.2f}")
    g_lat, g_en = _geomean(lat_ratios), _geomean(en_ratios)
    print(f"attn_geomean,0,lat={g_lat:.2f}x(paper 1.82x);"
          f"energy={g_en:.2f}x(paper 1.54x)")
    return {"geomean_latency_speedup": g_lat, "geomean_energy": g_en}


def breakdowns() -> Dict:
    """Figs 8/9: latency breakdown of distSM vs SM mappings per GEMM.

    Both mappings of each shape run through the batched SoA evaluator with
    ``track_breakdown=True`` — no scalar tree walk: the per-key breakdown
    arrays come out of the same vectorized pass as the totals.
    """
    out = {}
    for shapes, arch in ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud())):
        for i, (M, N, K) in enumerate(shapes):
            co = gemm_softmax(M, N, K)
            for tag, variant in (("distSM", "fused_dist"), ("SM", "fused_std")):
                br = evaluate_specs_batch(
                    co, arch, Topology(variant=variant),
                    [min(8, M)], [2], [1], track_breakdown=True)
                bd = br.lat_breakdown_at(0)
                top = max(bd, key=bd.get)
                print(f"breakdown_{arch.name}_G{i+1}_{tag},"
                      f"{float(br.latency[0])*1e6:.2f},dominant={top};"
                      + ";".join(f"{k}={v*1e6:.1f}us"
                                 for k, v in bd.items() if v > 0))
                out[f"{arch.name}_G{i+1}_{tag}"] = top
    return out


def pareto_fronts() -> Dict:
    """Beyond-scalar objectives: the latency/energy Pareto front of every
    (shape, arch) gemm_softmax space, extracted vectorized from the SoA
    grids (``objective='pareto'``).  Prints front size and both endpoints;
    the front's min latency always matches the scalar-latency optimum."""
    jobs = [(gemm_softmax(M, N, K), arch, dict(SEARCH_KW, objective="pareto"))
            for shapes, arch in ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud()))
            for (M, N, K) in shapes]
    results = iter(search_many(jobs))
    sizes = []
    for shapes, arch in ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud())):
        for i, (M, N, K) in enumerate(shapes):
            r = next(results)
            front = r.front
            lat_lo, en_hi, _ = front[0]     # min latency end
            lat_hi, en_lo, _ = front[-1]    # min energy end
            sizes.append(len(front))
            print(f"pareto_{arch.name}_G{i+1},{lat_lo*1e6:.2f},"
                  f"front={len(front)};"
                  f"lat_span={lat_lo*1e6:.1f}..{lat_hi*1e6:.1f}us;"
                  f"energy_span={en_lo/1e6:.2f}..{en_hi/1e6:.2f}uJ")
    print(f"pareto_geomean,0,mean_front_size={sum(sizes)/len(sizes):.1f}")
    return {"front_sizes": sizes}


def provisioning_fronts() -> Dict:
    """Provisioning study (beyond-scalar objectives, 3-D): the
    latency/energy/capacity-headroom Pareto front of each gemm_softmax
    space (``objective='pareto3'``), plus non-pow2 shapes where the
    divisor-complete fanout axes (sp_cluster=3/6, ...) genuinely widen
    the space.  For each cell we print the front size, the headroom span
    and the 'knee' trade: how much latency the max-headroom provisioning
    point gives up versus the latency-optimal mapping."""
    cells = [(gemm_softmax(M, N, K), arch)
             for shapes, arch in ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud()))
             for (M, N, K) in shapes]
    # divisor-complete showcase shapes, on both archs
    cells += [(gemm_softmax(*shape), arch)
              for shape in PROVISIONING_GEMMS
              for arch in (edge(), cloud())]
    results = iter(search_many([(co, arch,
                                 dict(SEARCH_KW, objective="pareto3"))
                                for co, arch in cells]))
    sizes, knees = [], []
    for i, (co, arch) in enumerate(cells):
        front = next(results).front
        lat_lo = front[0][0]
        hr = [p[2] for p in front]
        roomy = max(front, key=lambda p: p[2])   # max-headroom point
        knee = roomy[0] / lat_lo                 # latency cost of slack
        sizes.append(len(front))
        knees.append(knee)
        dims = "x".join(str(co.dim_sizes[d]) for d in ("M", "N", "K"))
        print(f"prov3_{arch.name}_{dims},{lat_lo*1e6:.2f},"
              f"front3={len(front)};headroom={min(hr):.3f}..{max(hr):.3f};"
              f"maxroom_lat_cost={knee:.2f}x")
    print(f"prov3_geomean,0,mean_front_size={sum(sizes)/len(sizes):.1f};"
          f"geomean_maxroom_lat_cost={_geomean(knees):.2f}x")
    return {"front_sizes": sizes, "knees": knees}


def mapping_variation() -> Dict:
    """Fig 7: latency/energy spread across sampled mappings (GEMM5 edge)."""
    co = gemm_softmax(512, 1024, 128)
    arch = edge()
    lats, ens = [], []
    import random
    from repro_torch.core.search import candidate_specs, _sample
    rng = random.Random(0)
    cands = candidate_specs(co, arch)
    for _ in range(300):
        spec = _sample(rng, cands)
        try:
            r = evaluate_mapping(co, arch, spec)
        except (ValueError, KeyError):
            continue
        if r.valid:
            lats.append(r.latency)
            ens.append(r.energy_pj)
    spread_lat = max(lats) / min(lats)
    spread_en = max(ens) / min(ens)
    print(f"mapping_variation_lat,{min(lats)*1e6:.2f},spread={spread_lat:.1f}x")
    print(f"mapping_variation_energy,{min(ens)/1e6:.2f},spread={spread_en:.1f}x")
    return {"latency_spread": spread_lat, "energy_spread": spread_en}


def beyond_paper_stats_collectives() -> Dict:
    """Beyond-paper: distSM collectives on M×1 stats instead of the paper's
    M×N tile annotation — the framework-level optimization enabled by the
    explicit representation.  Compared at the SAME mapping (fixed tiling)
    so the collective-term change is isolated; we report both the
    collective-term reduction and the total-latency speedup."""
    col_ratios, lat_ratios = [], []
    for shapes, arch in ((GEMMS_EDGE, edge()), (GEMMS_CLOUD, cloud())):
        for (M, N, K) in shapes:
            co = gemm_softmax(M, N, K)
            spec = MappingSpec(variant="fused_dist", m_tiles=min(8, M),
                               k_tiles=2)
            tile = evaluate_mapping(co, arch, spec)
            stats = evaluate_mapping(
                co, arch, MappingSpec(variant="fused_dist",
                                      m_tiles=min(8, M), k_tiles=2,
                                      collective_gran="stats"))
            ct = tile.cost.lat_breakdown["collective"]
            cs = stats.cost.lat_breakdown["collective"]
            if cs > 0:
                col_ratios.append(ct / cs)
            lat_ratios.append(tile.latency / stats.latency)
    g_col = _geomean(col_ratios) if col_ratios else float("nan")
    g_lat = _geomean(lat_ratios)
    print(f"stats_gran_speedup,0,collective_term={g_col:.1f}x;"
          f"total_latency={g_lat:.2f}x_over_paper_faithful")
    return {"collective_term_speedup": g_col, "latency_speedup": g_lat}


def export_plans(out_path: str = "PLANS_kernels.json") -> Dict:
    """MappingPlan bundle export (the search -> serving handoff): solve
    every paper-table kernel block-selection plan through the shared
    :class:`repro_torch.core.plan.PlanCache` — misses fan out through one
    ``search_many(executor='auto')`` sweep — and emit a single-file plan
    bundle.  A serving host imports it (``launch/serve --plan-bundle``,
    or ``PlanCache.import_bundle``) and its startup warmup becomes pure
    cache hits: no search ever runs on the serving side."""
    from repro_torch.core.plan import get_plan_cache
    from repro_torch.kernels.autotune import plan_jobs

    cache = get_plan_cache()
    t0 = time.time()
    # tag the whole sweep as one provenance generation in the durable
    # store ($REPRO_PLAN_SWEEP_ID overrides), so a fleet operator can
    # later `invalidate(sweep_id=...)` or audit it via `store_stats()`
    stats = cache.warmup(plan_jobs(), sweep_id="paper-tables-export")
    n = cache.export_bundle(out_path)
    store = cache.store_stats()["store"]
    print(f"plan_bundle,{(time.time() - t0) * 1e6:.0f},"
          f"plans={n};solved={stats['solved']};hits={stats['hits']};"
          f"store={store.get('backend')};wrote={out_path}")
    return {"plans": n, **stats, "path": out_path,
            "store_backend": store.get("backend")}


def run_all() -> Dict:
    print("# --- Fig 10/11: GEMM-Softmax fusion ---")
    sm = fusion_comparison(gemm_softmax, "gemm_sm", 1.42)
    print("# --- Fig 10/11: GEMM-LayerNorm fusion ---")
    ln = fusion_comparison(gemm_layernorm, "gemm_ln", 3.46)
    print("# --- Fig 12: attention variants ---")
    at = attention_variants()
    print("# --- Fig 8/9: breakdowns (batched) ---")
    bd = breakdowns()
    print("# --- latency/energy Pareto fronts ---")
    pf = pareto_fronts()
    print("# --- provisioning study: 3-D latency/energy/headroom fronts ---")
    pv = provisioning_fronts()
    print("# --- Fig 7: mapping variation ---")
    mv = mapping_variation()
    print("# --- beyond-paper: stats-granularity collectives ---")
    bp = beyond_paper_stats_collectives()
    print("# --- kernel plan bundle (search -> serving handoff) ---")
    ep = export_plans()
    return {"gemm_sm": sm, "gemm_ln": ln, "attention": at,
            "breakdowns": bd, "pareto": pf, "provisioning": pv,
            "variation": mv, "beyond": bp, "plans": ep}


if __name__ == "__main__":
    run_all()
