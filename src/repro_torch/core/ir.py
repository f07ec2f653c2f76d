"""Mapping-instance → IR construction (COMET Fig. 3 'IR' stage).

Builds the hierarchical mapping trees of Fig. 4(c) for the paper's case
studies, parameterized by a :class:`MappingSpec`:

* GEMM-epilogue compound ops (GEMM-Softmax / GEMM-LayerNorm) with the four
  fusion variants of §V-D:  ``unfused``, ``fused_epilogue`` (Fused-distSM),
  ``fused_std`` (Fused-GEMM-SM: epilogue gathered to one cluster) and
  ``fused_dist`` (Fused-GEMM-distSM: fully fused + distributed epilogue
  with explicit All-Reduce collectives).
* Self-attention with the three variants of §V-D2: ``ua`` (unfused),
  ``pfa`` (score+softmax fused) and ``fa`` (FlashAttention, fully fused
  online-softmax).
* A generic unfused builder for arbitrary compound ops (used for SSD).

Collective granularity (DESIGN.md §8): the paper annotates the distSM
All-Reduce with tensor **C** (so the collective moves M×N tile volume);
``collective_gran='tile'`` reproduces that.  ``'stats'`` is our
beyond-paper optimization that reduces only the M×1 statistics vectors.

Port-local copy of ``repro/core/ir.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .cost import CostModel, NodeCost
from .hardware import Arch
from .mapping import CollectiveNode, ComputeNode, Loop, Node, TileNode, Tiling
from .numerics import ceil_div, is_array, vmax, vmin
from .validate import validate_headroom_levels
from .workload import CompoundOp, Operation

__all__ = ["MappingSpec", "build_tree", "evaluate_mapping", "MappingResult"]

VARIANTS_GEMM = ("unfused", "fused_epilogue", "fused_std", "fused_dist")
VARIANTS_ATTN = ("ua", "pfa", "fa")


@dataclass(frozen=True)
class MappingSpec:
    """A concrete mapping instance (tiling + order + spatial + collectives
    + schedule) — the output of the mapping-instance generator.

    ``sp_cluster``/``sp_core`` are the spatial unrolling *fanouts* (how
    many clusters / cores-per-cluster the builder's partition dim spreads
    over); 0 means "use the full architecture fanout" (the §V-C2 case
    study choice and the pre-existing default).  The builders accept NumPy
    int arrays here — the batched engine enumerates both axes inside its
    structure-of-arrays grid.
    """

    variant: str = "fused_dist"
    m_tiles: int = 1            # temporal M tiling at GB (DRAM->GB streaming)
    k_tiles: int = 1            # temporal K tiling at OB (accumulation)
    n_tiles: int = 1            # temporal N tiling at GB (KV streaming for FA)
    sp_cluster: int = 0         # spatial fanout across clusters (0 = arch max)
    sp_core: int = 0            # spatial fanout across cores (0 = arch max)
    loop_order_gb: Tuple[str, ...] = ("M", "N")
    schedule: str = "sequential"
    collective_gran: str = "tile"   # 'tile' (paper-faithful) | 'stats'
    collective_level: str = "GB"    # where CO nodes sit
    # Compute–collective overlap factor in [0, 1]: the fraction of each
    # window's hideable collective time (its Eq. 1 mem_lat; the Eq. 3
    # enqueue/router term stays exposed) hidden under sibling compute.
    # 0.0 (default) reproduces the pre-overlap serial charging exactly.
    overlap: float = 0.0


@dataclass
class MappingResult:
    cost: NodeCost
    root: TileNode
    tiling: Tiling
    spec: MappingSpec
    valid: bool
    # Worst relative buffer slack: min over non-DRAM tile nodes of
    # (capacity - resident)/capacity — the provisioning ("pareto3")
    # objective channel.  Negative iff some buffer overflows.
    headroom: float = 1.0
    # Per-level worst slack ({'GB': ..., 'OB': ...}): the un-folded view
    # of ``headroom`` (== min over the values), letting provisioning
    # studies size the cluster (GB) and core (IB+WB+OB) buffers
    # independently.
    headroom_levels: Dict[str, float] = field(default_factory=dict)

    @property
    def latency(self) -> float:
        return self.cost.latency

    @property
    def energy_pj(self) -> float:
        return self.cost.energy_pj


# ------------------------------------------------------------------ helpers


def _ceil_div(a: int, b: int) -> int:
    return vmax(1, ceil_div(a, b))


def _clamped_spatial(size: int, want: int) -> int:
    """Spatial fanout cannot exceed the dimension size."""
    return vmax(1, vmin(want, size))


def _sp_want(req, cap: int):
    """Resolve a MappingSpec spatial-fanout request against the arch limit:
    0 (or negative) means 'use the full fanout'; otherwise clamp to the
    number of physical instances.  Array-polymorphic for the batched grid."""
    if is_array(req):
        return np.where(req <= 0, cap, np.minimum(req, cap))
    if req <= 0:
        return cap
    return min(req, cap)


def _leaf_shape(tiling: Tiling, dims: Tuple[str, ...]) -> Dict[str, int]:
    return {d: tiling.leaf_tile(d) for d in dims}


def _gb_shape(tiling: Tiling, dims: Tuple[str, ...]) -> Dict[str, int]:
    return {d: tiling.tile_below(d, "GB") for d in dims}


def _simd_node(op: Operation, shape: Dict[str, int]) -> ComputeNode:
    return ComputeNode(op=op, tile_shape=dict(shape), unit="simd", label=op.name)


def _gemm_node(op: Operation, shape: Dict[str, int]) -> ComputeNode:
    return ComputeNode(op=op, tile_shape=dict(shape), unit="gemm", label=op.name)


# ================================================== GEMM-epilogue builders


def _build_gemm_epilogue(co: CompoundOp, arch: Arch, spec: MappingSpec) -> Tuple[TileNode, Tiling]:
    """GEMM-Softmax / GEMM-LayerNorm trees for all four fusion variants.

    Case-study mapping (§V-C2): N spatially across clusters and cores,
    M temporally tiled (FLAT row granularity).  The cluster/core fanouts
    come from ``spec.sp_cluster``/``spec.sp_core`` (0 = full fanout) and
    may be arrays on the batched path; edge tiles at non-divisible sizes
    use ceil-div residual shapes throughout.
    """
    M, N, K = (co.dim_sizes[d] for d in ("M", "N", "K"))
    want_cl = _sp_want(spec.sp_cluster, arch.num_clusters)
    want_co = _sp_want(spec.sp_core, arch.cores_per_cluster)
    n_cl = _clamped_spatial(N, want_cl)
    n_co = _clamped_spatial(_ceil_div(N, n_cl), want_co)
    m_tiles = vmin(spec.m_tiles, M)
    k_tiles = vmin(spec.k_tiles, K)

    tiling = Tiling(
        co.dim_sizes,
        temporal={"GB": {"M": m_tiles}, "OB": {"K": k_tiles}},
        spatial={"GB": {"N": n_cl}, "OB": {"N": n_co}},
    )
    gemm_op = co.gemm_ops()[0]
    simd_ops = co.simd_ops()
    inter = co.op("Op1_gemm").output          # "C"
    final = co.external_outputs[0]
    stats = [t for t, s in co.tensors.items() if s.dims == ("M",)]
    dtype_b = co.tensors[inter].dtype_bytes

    leaf = _leaf_shape(tiling, ("M", "N", "K"))
    m_tile = tiling.tile_below("M", "GB")
    n_leaf = leaf["N"]

    def ob(op_nodes: List[ComputeNode], inputs, outputs, loops=None,
           spatial=True, label="") -> TileNode:
        return TileNode(
            level="OB", index=0, loops=loops or [],
            spatial_loops=[Loop("N", n_co, True)] if spatial else [],
            input_tensors=tuple(inputs), output_tensors=tuple(outputs),
            children=list(op_nodes), schedule="sequential", label=label)

    def collective(tensor: str, reduce_op: str, label: str) -> CollectiveNode:
        if spec.collective_gran == "tile":
            dv = m_tile * N * dtype_b          # paper-faithful: tensor C tile
            tname = inter
        else:
            dv = m_tile * dtype_b              # stats-only (beyond-paper)
            tname = tensor
        return CollectiveNode(
            col_type="AllReduce", tensor=tname, reduce_op=reduce_op,
            src=("GB",), dest=("GB",), participants=n_cl,
            data_volume_bytes=dv, count=1, noc_level="GB", label=label)

    # ---- per-variant GB-level children ------------------------------------
    gemm_leaf = dict(leaf)
    gemm_ob = ob([_gemm_node(gemm_op, gemm_leaf)], gemm_op.inputs, (inter,),
                 loops=[Loop("K", k_tiles)], label="T_gemm")

    ext_in = co.external_inputs
    gemm_only_inputs = tuple(t for t in gemm_op.inputs if t in ext_in)
    epi_ext_inputs = tuple(t for t in ext_in if t not in gemm_op.inputs)

    if spec.variant == "fused_dist":
        # Fig. 4(c): everything fused at GB; distributed epilogue with
        # explicit All-Reduce collectives between SIMD stages.
        children: List[Node] = [gemm_ob]
        per_core = {"M": m_tile, "N": n_leaf}
        pending: List[ComputeNode] = []
        for op in simd_ops:
            shape = {d: per_core.get(d, tiling.tile_below(d, "OB")) for d in op.dims}
            pending.append(_simd_node(op, shape))
            if op.reduce_dims:                 # stats op => needs cross-cluster AR
                ins = tuple(t for t in op.inputs)
                outs = (op.output,)
                children.append(ob(pending, ins, outs, label=f"T_{op.name}"))
                pending = []
                children.append(collective(op.output,
                                           "max" if "max" in op.name else "add",
                                           f"CO_{op.name}"))
        if pending:
            last = simd_ops[-1]
            children.append(ob(pending, last.inputs, (final,), label="T_tail"))
        root_children: List[Node] = [TileNode(
            level="GB", index=0,
            loops=[Loop("M", m_tiles)],
            spatial_loops=[Loop("N", n_cl, True)],
            input_tensors=gemm_only_inputs + epi_ext_inputs,
            output_tensors=(final,),
            bypass_tensors=tuple(co.intermediates()),
            children=children, schedule=spec.schedule, label="T_fused_dist",
            overlap=spec.overlap)]

    elif spec.variant == "fused_std":
        # Fused-GEMM-SM: GEMM distributed; Gather C rows to one cluster;
        # epilogue on a single cluster/core (full-row tiles, no AR).
        gather = CollectiveNode(
            col_type="Gather", tensor=inter, reduce_op="none",
            src=("GB",), dest=("GB",), participants=n_cl,
            data_volume_bytes=m_tile * N * dtype_b, count=1,
            noc_level="GB", label="CO_gather")
        full_row = {"M": m_tile, "N": N}
        epi_nodes = [_simd_node(op, {d: full_row.get(d, 1) for d in op.dims})
                     for op in simd_ops]
        epi_ob = ob(epi_nodes, (inter,) + epi_ext_inputs, (final,),
                    spatial=False, label="T_epi_single")
        gb = TileNode(
            level="GB", index=0,
            loops=[Loop("M", m_tiles)],
            spatial_loops=[Loop("N", n_cl, True)],
            input_tensors=gemm_only_inputs + epi_ext_inputs,
            output_tensors=(final,),
            bypass_tensors=tuple(co.intermediates()),
            children=[gemm_ob, gather, epi_ob],
            schedule=spec.schedule, label="T_fused_std",
            extra_resident_bytes=m_tile * N * dtype_b * 2.0,
            overlap=spec.overlap)
        root_children = [gb]

    elif spec.variant == "fused_epilogue":
        # Fused-distSM: epilogue ops fused together but NOT with the GEMM;
        # C round-trips DRAM between the two subtrees.
        gb_gemm = TileNode(
            level="GB", index=0, loops=[Loop("M", m_tiles)],
            spatial_loops=[Loop("N", n_cl, True)],
            input_tensors=gemm_only_inputs, output_tensors=(inter,),
            children=[gemm_ob], schedule="sequential", label="T_gemm_gb")
        children = []
        per_core = {"M": m_tile, "N": n_leaf}
        pending = []
        for op in simd_ops:
            shape = {d: per_core.get(d, tiling.tile_below(d, "OB")) for d in op.dims}
            pending.append(_simd_node(op, shape))
            if op.reduce_dims:
                children.append(ob(pending, op.inputs, (op.output,),
                                   label=f"T_{op.name}"))
                pending = []
                children.append(collective(op.output,
                                           "max" if "max" in op.name else "add",
                                           f"CO_{op.name}"))
        if pending:
            children.append(ob(pending, simd_ops[-1].inputs, (final,),
                               label="T_tail"))
        epi_bypass = tuple(t for t in co.intermediates() if t != inter)
        gb_epi = TileNode(
            level="GB", index=1, loops=[Loop("M", m_tiles)],
            spatial_loops=[Loop("N", n_cl, True)],
            input_tensors=(inter,) + epi_ext_inputs, output_tensors=(final,),
            bypass_tensors=epi_bypass,
            children=children, schedule=spec.schedule, label="T_epi_gb",
            overlap=spec.overlap)
        root_children = [gb_gemm, gb_epi]

    elif spec.variant == "unfused":
        # Every elementary op round-trips DRAM.  SIMD ops partition M across
        # clusters/cores when possible; otherwise N with an explicit AR.
        root_children = []
        gb_gemm = TileNode(
            level="GB", index=0, loops=[Loop("M", m_tiles)],
            spatial_loops=[Loop("N", n_cl, True)],
            input_tensors=gemm_only_inputs, output_tensors=(inter,),
            children=[gemm_ob], schedule="sequential", label="T_gemm_gb")
        root_children.append(gb_gemm)
        m_cl = _clamped_spatial(M, want_cl)
        m_co = _clamped_spatial(_ceil_div(M, m_cl), want_co)
        m_leaf_u = _ceil_div(M, m_cl * m_co * m_tiles)
        for i, op in enumerate(simd_ops):
            shape = {d: (m_leaf_u if d == "M" else co.dim_sizes[d])
                     for d in op.dims}
            opin = tuple(op.inputs)
            ob_n = TileNode(
                level="OB", index=0, loops=[],
                spatial_loops=[Loop("M", m_co, True)],
                input_tensors=opin, output_tensors=(op.output,),
                children=[_simd_node(op, shape)], label=f"T_{op.name}_ob")
            gb_n = TileNode(
                level="GB", index=i + 1, loops=[Loop("M", m_tiles)],
                spatial_loops=[Loop("M", m_cl, True)],
                input_tensors=opin, output_tensors=(op.output,),
                children=[ob_n], schedule="sequential", label=f"T_{op.name}_gb")
            root_children.append(gb_n)
    else:
        raise ValueError(f"unknown variant {spec.variant}")

    root = TileNode(
        level="DRAM", index=0, loops=[], spatial_loops=[],
        input_tensors=(), output_tensors=(),
        children=root_children, schedule="sequential", label="T_root")
    return root, tiling


# ======================================================= attention builders


def _build_attention(co: CompoundOp, arch: Arch, spec: MappingSpec) -> Tuple[TileNode, Tiling]:
    """UA / PFA / FA trees (§V-D2).

    FA: query rows (M) spatially partitioned when M is large enough; KV
    streamed temporally in n_tiles blocks with online softmax (no
    collectives).  When M is small (decode), N is partitioned across
    clusters and a final merge All-Reduce on (O, stats) is required —
    flash-decoding style.
    """
    M, N, K = (co.dim_sizes[d] for d in ("M", "N", "K"))
    L = co.dim_sizes["L"]
    total_cores = arch.total_cores
    dtype_b = co.tensors["S"].dtype_bytes
    row_parallel = M >= total_cores        # enough query rows to go around

    want_cl = _sp_want(spec.sp_cluster, arch.num_clusters)
    want_co = _sp_want(spec.sp_core, arch.cores_per_cluster)
    if row_parallel:
        sp_dim = "M"
        sp_gb = _clamped_spatial(M, want_cl)
        sp_ob = _clamped_spatial(_ceil_div(M, sp_gb), want_co)
    else:
        sp_dim = "N"
        sp_gb = _clamped_spatial(N, want_cl)
        sp_ob = _clamped_spatial(_ceil_div(N, sp_gb), want_co)

    m_tiles = vmin(spec.m_tiles, M)
    # KV-block cap: number of N elements per core, ceil-div so residual
    # (edge) tiles at non-divisible sizes still count as a streamable block.
    n_cap = vmax(1, _ceil_div(N, sp_gb * sp_ob)) if sp_dim == "N" else N
    n_tiles = vmin(spec.n_tiles, n_cap)
    # KV streaming (the N temporal loop) lives at the GB node: blocks of
    # K^T/V are staged DRAM->GB per iteration (FLAT/FlashAttention style).
    gb_loops = ([Loop("M", m_tiles), Loop("N", n_tiles)]
                if spec.loop_order_gb[0] == "M"
                else [Loop("N", n_tiles), Loop("M", m_tiles)])
    tiling = Tiling(
        co.dim_sizes,
        temporal={"GB": {"M": m_tiles, "N": n_tiles}},
        spatial={"GB": {sp_dim: sp_gb}, "OB": {sp_dim: sp_ob}},
    )
    leaf = {d: tiling.leaf_tile(d) for d in ("M", "N", "K", "L")}
    score = co.op("Op1_score")
    ctx = co.op("Op8_context")
    simd_ops = [o for o in co.ops if o.kind == "simd"]

    def ob_node(children, inputs, outputs, loops=None, label="") -> TileNode:
        return TileNode(
            level="OB", index=0, loops=loops or [],
            spatial_loops=[Loop(sp_dim, sp_ob, True)],
            input_tensors=tuple(inputs), output_tensors=tuple(outputs),
            children=children, schedule="sequential", label=label)

    if spec.variant == "fa":
        # one fused GB subtree; KV streamed in n_tiles blocks
        body: List[Node] = []
        kv_leaf = dict(leaf)
        body.append(_gemm_node(score, kv_leaf))
        for op in simd_ops:
            shape = {d: leaf.get(d, 1) for d in op.dims}
            body.append(_simd_node(op, shape))
        body.append(_gemm_node(ctx, kv_leaf))
        inner = ob_node(body, ("Q", "Kt", "V"), (co.external_outputs[0],),
                        label="T_fa_ob")
        children: List[Node] = [inner]
        if not row_parallel:
            # flash-decoding final merge: AR of O tile + running stats,
            # once per M tile (i.e. per 1/n_tiles of the GB iterations).
            # participants == 1 grid points cost exactly zero (the
            # collective model short-circuits), so the node is added
            # unconditionally — sp_gb may be an array on the batched path.
            merge_dv = (leaf["M"] * L + 2 * leaf["M"]) * dtype_b
            children.append(CollectiveNode(
                col_type="AllReduce", tensor="O", reduce_op="add",
                src=("GB",), dest=("GB",), participants=sp_gb,
                data_volume_bytes=merge_dv, count=1, noc_level="GB",
                label="CO_fa_merge", exec_fraction=1.0 / n_tiles))
        gb = TileNode(
            level="GB", index=0, loops=list(gb_loops),
            spatial_loops=[Loop(sp_dim, sp_gb, True)],
            input_tensors=("Q", "Kt", "V"),
            output_tensors=(co.external_outputs[0],),
            bypass_tensors=tuple(co.intermediates()),
            children=children, schedule=spec.schedule, label="T_fa_gb",
            overlap=spec.overlap)
        root_children: List[Node] = [gb]

    elif spec.variant in ("pfa", "ua"):
        # score (+softmax if pfa) subtree, then context subtree.
        def gb_wrap(children, inputs, outputs, idx, bypass=(), label="",
                    loops=None, extra=0.0):
            return TileNode(
                level="GB", index=idx,
                loops=list(gb_loops) if loops is None else loops,
                spatial_loops=[Loop(sp_dim, sp_gb, True)],
                input_tensors=tuple(inputs), output_tensors=tuple(outputs),
                bypass_tensors=tuple(bypass),
                children=children, schedule=spec.schedule, label=label,
                extra_resident_bytes=extra, overlap=spec.overlap)

        score_ob = ob_node([_gemm_node(score, leaf)], ("Q", "Kt"), ("S",),
                           label="T_score_ob")
        # softmax sees full rows when rows are local (sp over M); when N is
        # partitioned (decode) pfa works on local slices + a stats AR while
        # ua computes full rows on a single cluster/core.
        softmax_n = (N if (not row_parallel and spec.variant == "ua")
                     or sp_dim == "M" else leaf["N"])
        softmax_shape = {"M": leaf["M"], "N": softmax_n}
        soft_nodes = [_simd_node(op, {d: softmax_shape.get(d, 1) for d in op.dims})
                      for op in simd_ops]
        ctx_ob = ob_node([_gemm_node(ctx, leaf)], ("P", "V"), ("O",),
                         label="T_ctx_ob")
        s_row_bytes = leaf["M"] * N * dtype_b  # full-row S resident at GB
        if spec.variant == "pfa":
            soft_ob = ob_node(soft_nodes, ("S",), ("P",), label="T_sm_ob")
            soft_ob.exec_fraction = 1.0 / n_tiles   # once per M tile
            children = [score_ob, soft_ob]
            if not row_parallel:
                # zero-cost when sp_gb == 1; see the fa merge note above
                children.insert(1, CollectiveNode(
                    col_type="AllReduce", tensor="S", reduce_op="max",
                    src=("GB",), dest=("GB",), participants=sp_gb,
                    data_volume_bytes=(leaf["M"] * 2) * dtype_b,
                    count=1, noc_level="GB", label="CO_pfa_stats",
                    exec_fraction=1.0 / n_tiles))
            gb1 = gb_wrap(children, ("Q", "Kt"), ("P",), 0,
                          bypass=("S", "mx", "D", "E", "sm"),
                          label="T_pfa_gb", extra=s_row_bytes)
            gb2 = gb_wrap([ctx_ob], ("P", "V"), ("O",), 1, label="T_ctx_gb")
            root_children = [gb1, gb2]
        else:  # ua: every op round-trips DRAM
            gb_score = gb_wrap([score_ob], ("Q", "Kt"), ("S",), 0,
                               label="T_score_gb")
            soft_ob = ob_node(soft_nodes, ("S",), ("P",), label="T_sm_ob")
            gb_soft = gb_wrap([soft_ob], ("S",), ("P",), 1,
                              bypass=("mx", "D", "E", "sm"),
                              loops=[Loop("M", m_tiles)],
                              label="T_sm_gb", extra=s_row_bytes)
            gb_ctx = gb_wrap([ctx_ob], ("P", "V"), ("O",), 2, label="T_ctx_gb")
            root_children = [gb_score, gb_soft, gb_ctx]
    else:
        raise ValueError(f"unknown attention variant {spec.variant}")

    root = TileNode(level="DRAM", index=0, children=root_children,
                    schedule="sequential", label="T_root")
    return root, tiling


# ====================================================== generic unfused


def _build_generic(co: CompoundOp, arch: Arch, spec: MappingSpec) -> Tuple[TileNode, Tiling]:
    """Generic unfused (or GB-fused) mapping for arbitrary compound ops:
    each op gets a GB subtree; the first non-reduced dim of each op is
    spatially partitioned; ``spec.variant == 'fused_dist'`` stages
    intermediates in GB instead of DRAM."""
    fused = spec.variant != "unfused"
    dims = co.dim_sizes
    # partition the largest dim common to most ops
    from collections import Counter
    cnt: Counter = Counter()
    for op in co.ops:
        for d in op.dims:
            if d not in op.reduce_dims:
                cnt[d] += 1
    part_dim = max(cnt, key=lambda d: (cnt[d], dims[d]))
    p_cl = _clamped_spatial(dims[part_dim],
                            _sp_want(spec.sp_cluster, arch.num_clusters))
    p_co = _clamped_spatial(_ceil_div(dims[part_dim], p_cl),
                            _sp_want(spec.sp_core, arch.cores_per_cluster))
    # ceil-div so the residual edge tile still counts as a temporal step
    m_tiles = vmin(spec.m_tiles, _ceil_div(dims[part_dim], p_cl * p_co))
    tiling = Tiling(dims,
                    temporal={"GB": {part_dim: m_tiles}},
                    spatial={"GB": {part_dim: p_cl}, "OB": {part_dim: p_co}})

    inter = set(co.intermediates())
    children: List[Node] = []
    for i, op in enumerate(co.ops):
        shape = {d: tiling.leaf_tile(d) for d in op.dims}
        node = (_gemm_node if op.kind == "gemm" else _simd_node)(op, shape)
        ob_n = TileNode(level="OB", index=0,
                        spatial_loops=[Loop(part_dim, p_co, True)],
                        input_tensors=tuple(op.inputs),
                        output_tensors=(op.output,),
                        children=[node], label=f"T_{op.name}_ob")
        byp = tuple(t for t in (op.inputs + (op.output,)) if t in inter) if fused else ()
        gb_n = TileNode(level="GB", index=i, loops=[Loop(part_dim, m_tiles)],
                        spatial_loops=[Loop(part_dim, p_cl, True)],
                        input_tensors=tuple(op.inputs),
                        output_tensors=(op.output,),
                        bypass_tensors=byp,
                        children=[ob_n], schedule="sequential",
                        label=f"T_{op.name}_gb")
        children.append(gb_n)
        # reduction over a spatially-partitioned dim needs an AR
        # (zero-cost at grid points where p_cl == 1)
        if any(d == part_dim for d in op.reduce_dims):
            out_b = co.tensors[op.output].size_bytes(dims)
            children.append(CollectiveNode(
                col_type="AllReduce", tensor=op.output, reduce_op="add",
                src=("GB",), dest=("GB",), participants=p_cl,
                data_volume_bytes=out_b / vmax(1, m_tiles), count=1,
                noc_level="GB", label=f"CO_{op.name}"))
    # the generic builder's collectives sit at the DRAM root, so the
    # overlap factor applies there (fused or not, the tree shape is the
    # same; fused only changes bypass staging)
    root = TileNode(level="DRAM", index=0, children=children,
                    schedule="sequential", label="T_root",
                    overlap=spec.overlap)
    return root, tiling


# ------------------------------------------------------------------ facade


def build_tree(co: CompoundOp, arch: Arch, spec: MappingSpec) -> Tuple[TileNode, Tiling]:
    if co.name in ("gemm", "gemm_softmax", "gemm_layernorm"):
        return _build_gemm_epilogue(co, arch, spec)
    if co.name in ("attention", "flash_attention"):
        return _build_attention(co, arch, spec)
    return _build_generic(co, arch, spec)


def evaluate_mapping(co: CompoundOp, arch: Arch, spec: MappingSpec) -> MappingResult:
    root, tiling = build_tree(co, arch, spec)
    valid, headroom, levels = validate_headroom_levels(root, arch, tiling,
                                                      co.tensors)
    cost = CostModel(arch, tiling, co.tensors).evaluate(root)
    return MappingResult(cost=cost, root=root, tiling=tiling, spec=spec,
                         valid=valid, headroom=headroom,
                         headroom_levels=levels)
