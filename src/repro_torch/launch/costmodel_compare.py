"""Fig 6 reproduction: COMET vs steady-state cost models.

(a,b) single-op GEMM vs a Timeloop-style steady-state model (perfect
pipelining, no ramp-up/ramp-down CS, no OS): energy should correlate ~1
(same access counts); COMET latency should be systematically >= steady-state
with high rank correlation.

(c,d) compound GEMM-GEMM vs a TileFlow-style model (no intermediate-reuse
credit, no inter-op dependency stalls): COMET energy lower (reuse captured),
COMET latency higher (dependency CS).

Port of ``benchmarks/costmodel_compare.py`` on the port's core (a
bit-equal copy of the JAX package's) and calibration loop: the same
numbers and printed rows (``tests/test_torch_frontends.py``).  The cost
models run on the host; no device is touched.

    PYTHONPATH=src python -m repro_torch.launch.costmodel_compare
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

from repro_torch.core.cost import CostModel, NodeCost
from repro_torch.core.hardware import tileflow_like
from repro_torch.core.ir import MappingSpec, build_tree, evaluate_mapping
from repro_torch.core.mapping import CollectiveNode, ComputeNode, TileNode
from repro_torch.core.search import candidate_specs, parallel_map, _sample
from repro_torch.core.validate import validate_tree
from repro_torch.core.workload import CompoundOp, Operation, TensorSpec, gemm


def steady_state_latency(root, arch, tiling, tensors) -> float:
    """Timeloop-style: per node latency = max(window, transfer); no CS/OS."""
    cm = CostModel(arch, tiling, tensors)

    def walk(node) -> Tuple[float, float]:
        """returns (latency, mem_lat)"""
        if isinstance(node, ComputeNode):
            c = cm.compute_cost(node)
            return c.latency, 0.0
        if isinstance(node, CollectiveNode):
            c = cm.collective_cost_node(node)
            return c.latency, c.mem_lat
        assert isinstance(node, TileNode)
        fracs = [getattr(ch, "exec_fraction", 1.0) for ch in node.children]
        subs = [walk(ch) for ch in node.children]
        mw = sum(l * f for (l, _), f in zip(subs, fracs))
        # recompute boundary transfer exactly as CostModel does
        full = cm.tile_cost(node)
        mem_time = full.mem_lat
        n = node.iterations
        return max(n * mw, mem_time), mem_time

    return walk(root)[0]


def _pearson(xs: List[float], ys: List[float]) -> float:
    """Pearson r; 0.0 (not NaN, not a division blow-up) for series that
    carry no correlation signal — fewer than two points, or either side
    constant (zero variance).  Pinned by tests/test_torch_calibrate.py."""
    n = len(xs)
    if n < 2:
        return 0.0
    mx, my = sum(xs) / n, sum(ys) / n
    vx = math.sqrt(sum((x - mx) ** 2 for x in xs))
    vy = math.sqrt(sum((y - my) ** 2 for y in ys))
    if vx == 0.0 or vy == 0.0:
        return 0.0
    cov = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    return cov / (vx * vy)


def gemm_gemm(M: int, N: int, K: int, N2: int) -> CompoundOp:
    """C = A@B ; E = C@D — the compound op of Fig 6(c,d)."""
    t = {
        "A": TensorSpec("A", ("M", "K")), "B": TensorSpec("B", ("K", "N")),
        "C": TensorSpec("C", ("M", "N")), "D": TensorSpec("D", ("N", "N2")),
        "E": TensorSpec("E", ("M", "N2")),
    }
    ops = [
        Operation("Op1_gemm", "gemm", ("M", "N", "K"), ("A", "B"), "C",
                  reduce_dims=("K",)),
        Operation("Op2_gemm", "gemm", ("M", "N2", "N"), ("C", "D"), "E",
                  reduce_dims=("N",)),
    ]
    co = CompoundOp("gemm_gemm", {"M": M, "N": N, "K": K, "N2": N2}, t, ops,
                    external_inputs=("A", "B", "D"), external_outputs=("E",))
    co.validate()
    return co


def _unique_specs(cands, keyfn, n_draws: int):
    """Deterministically sample distinct specs from the candidate space."""
    rng = random.Random(0)
    seen = set()
    specs = []
    for _ in range(n_draws):
        spec = _sample(rng, cands)
        key = keyfn(spec)
        if key in seen:
            continue
        seen.add(key)
        specs.append(spec)
    return specs


def _compare_one(args):
    """(comet latency, steady latency, comet energy) for one spec, or None
    when the mapping is rejected."""
    co, arch, spec = args
    try:
        root, tiling = build_tree(co, arch, spec)
        if not validate_tree(root, arch, tiling, co.tensors):
            return None
        r = CostModel(arch, tiling, co.tensors).evaluate(root)
        s = steady_state_latency(root, arch, tiling, co.tensors)
    except (ValueError, KeyError):
        return None
    return (r.latency, s, r.energy_pj)


def single_op_compare(n_mappings: int = 1152) -> Dict:
    """Fig 6(a,b): sweep mappings of one GEMM; compare latency models.
    The per-mapping model comparisons fan out over the parallel sweep
    driver."""
    arch = tileflow_like()
    co = gemm(256, 1024, 256)
    cands = candidate_specs(co, arch, variants=["unfused"])
    specs = _unique_specs(
        cands, lambda s: (s.m_tiles, s.k_tiles, s.n_tiles, s.schedule), 20000)
    # scalar tree evaluations are GIL-bound -> process pool
    rows = parallel_map(_compare_one, [(co, arch, s) for s in specs],
                        executor="process")
    rows = [r for r in rows if r is not None][:n_mappings]
    comet_l = [r[0] for r in rows]
    steady_l = [r[1] for r in rows]
    corr = _pearson(comet_l, steady_l)
    ratio = sum(c / max(s, 1e-12) for c, s in zip(comet_l, steady_l)) / len(comet_l)
    print(f"fig6ab_gemm_latency,{len(comet_l)},corr={corr:.3f};"
          f"comet_over_steady={ratio:.3f}(>=1 expected: staging stalls)")
    return {"corr": corr, "mean_ratio": ratio, "n": len(comet_l)}


def compound_compare() -> Dict:
    """Fig 6(c,d): GEMM-GEMM fused — TileFlow-style model misses
    intermediate reuse (higher energy) and dependency stalls (lower lat)."""
    arch = tileflow_like()
    co = gemm_gemm(256, 512, 256, 512)
    cands = candidate_specs(co, arch, variants=["fused_dist"])
    specs = _unique_specs(
        cands, lambda s: (s.m_tiles, s.k_tiles, s.n_tiles), 5000)
    results = parallel_map(_compare_one, [(co, arch, s) for s in specs],
                           executor="process")
    # TileFlow-style energy: charge DRAM for the intermediate C as if it
    # round-tripped (no reuse credit)
    c_bytes = co.tensors["C"].size_bytes(co.dim_sizes)
    tf_extra = 2 * c_bytes * arch.dram.read_energy_pj_per_byte
    rows = [(lat, s_lat, en, en + tf_extra)
            for r in results if r is not None
            for (lat, s_lat, en) in [r]][:200]
    lat_corr = _pearson([x[0] for x in rows], [x[1] for x in rows])
    en_corr = _pearson([x[2] for x in rows], [x[3] for x in rows])
    lat_ratio = sum(x[0] / max(x[1], 1e-12) for x in rows) / len(rows)
    en_ratio = sum(x[2] / x[3] for x in rows) / len(rows)
    print(f"fig6cd_compound,{len(rows)},lat_corr={lat_corr:.3f};"
          f"comet_lat_over_tf={lat_ratio:.3f}(>1: dependency stalls);"
          f"energy_corr={en_corr:.3f};comet_energy_over_tf={en_ratio:.3f}(<1: reuse)")
    return {"lat_corr": lat_corr, "lat_ratio": lat_ratio,
            "energy_corr": en_corr, "energy_ratio": en_ratio}


def collective_compare(jitter: float = 0.03, seed: int = 7) -> Dict:
    """Predicted-vs-measured collectives: sweep the synthetic backend
    with bounded jitter (a stand-in for a real mesh, same ``measure_fn``
    contract), fit ``NoCParams`` with ``repro_torch.calibrate``, and
    compare the fitted model's Eq. 4 predictions against the measurements
    it was trained on.  Correlation should be ~1 and the median relative
    error within the jitter bound — the in-process half of the
    calibration gate (the measured half is ``python -m
    repro_torch.calibrate`` over NCCL or gloo ranks)."""
    from dataclasses import replace as _replace

    from repro_torch.calibrate import (fit_noc_params, predicted_seconds,
                                       relative_errors, run_sweep,
                                       synthetic_measure_fn)
    from repro_torch.core.hardware import tpu_v5e

    ref = _replace(tpu_v5e().cluster_noc, mesh=(1, 8))
    sweep = run_sweep(synthetic_measure_fn(ref, jitter=jitter, seed=seed),
                      [2, 4, 8])
    fit = fit_noc_params(sweep.points, ref)
    pred = list(predicted_seconds(fit.points, fit.params))
    meas = [p.seconds for p in fit.points]
    corr = _pearson(pred, meas)
    res = sorted(abs(r) for r in relative_errors(fit.points, fit.params))
    med = res[len(res) // 2] if res else 0.0
    print(f"collective_pred_vs_meas,{len(meas)},corr={corr:.4f};"
          f"median_rel_err={med:.4f}(jitter={jitter});"
          f"max_rel_err={fit.max_rel_err:.4f}")
    return {"n": len(meas), "corr": float(corr),
            "median_rel_err": float(med),
            "max_rel_err": float(fit.max_rel_err), "jitter": jitter,
            "degenerate": fit.degenerate}


def run_all() -> Dict:
    print("# --- Fig 6(a,b): single-op vs Timeloop-style ---")
    a = single_op_compare()
    print("# --- Fig 6(c,d): compound vs TileFlow-style ---")
    b = compound_compare()
    print("# --- predicted-vs-measured collectives (repro_torch.calibrate) ---")
    c = collective_compare()
    return {"single": a, "compound": b, "collective": c}


if __name__ == "__main__":
    run_all()
