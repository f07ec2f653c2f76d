"""Static contracts: the kernels and the sharded paths against the cost
model.

Port of ``repro/analysis/contracts.py``.  The COMET cost model (Eqs. 1-7
and the collective tables) is only useful if it tells the truth about
what the port's kernels and mesh paths execute.  Nothing is built or
launched: every arm runs its entry on fake tensors
(``counts.fake_mode``) and counts the run (``counts.trace_counts``).

1. **Kernel contracts**: for every paper kernel shape, resolve the
   winning ``MappingPlan`` through the ``PlanCache`` (as the kernels'
   planner does), run the kernel's entry on fake CUDA bf16 tensors at the
   plan's tiling, and require the FLOP formula's count (the products the
   launch issues) to equal the compound op's GEMM FLOPs, with zero
   ``torch.distributed`` collectives, and the plan's tiling to be the one
   the launch takes (the fused GEMMs: all four numbers, read from the
   wrapper).  For the fused GEMMs the plan's DSMEM All-Reduce must run over
   the launch's cluster, its bytes set beside the kernel's exchange
   (``DSMEM_NOTE`` names the difference).
2. **Sharded contracts**: run ``sharded_softmax_xent`` on a fake world's
   mesh and require its recorded collectives (type, participants, count,
   wire) to equal ``softmax_collective_schedule``, the declaration the
   planner prices.
3. **Train contracts**: run ``make_train_step`` on a fake world's mesh.
   The explicit-family records (``xent/``, ``moe/combine``,
   ``moe/*-grad``) equal the declaration's ``origin == "explicit"``
   entries in count and wire; every other record goes through
   ``reconcile`` against its ``gspmd`` entries, and every disagreement
   must have a named cause.

Wire volumes on both sides go through ``core.collectives.collective_cost``
on ``tpu_v5e().cluster_noc``, as the JAX arm and the port's planner price
them.  A fake world (``counts.fake_world``) is made only while an arm
runs without a mesh of the caller's, and destroyed after it.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .counts import (FAKE_DEVICE, TraceCounts, fake_mode, fake_world,
                     trace_counts)
from .reconcile import is_explicit, reconcile_cell

__all__ = ["ContractCheck", "ContractReport", "gemm_flops",
           "kernel_contract_checks", "sharded_contract_checks",
           "train_contract_checks", "train_trace",
           "TRAIN_CONTRACT_CONFIGS", "ARMS", "DEFAULT_TOL",
           "run_contracts", "KERNEL_TRACERS", "default_mesh",
           "SSD_SPLIT_NOTE", "DSMEM_NOTE", "PASS_NOTE"]

DEFAULT_TOL = 0.02


@dataclass
class ContractCheck:
    """One predicted-vs-traced assertion."""

    name: str
    kind: str
    predicted: float
    traced: float
    tolerance: float
    ok: bool
    detail: Dict = field(default_factory=dict)

    @property
    def rel_err(self) -> float:
        base = max(abs(self.predicted), abs(self.traced))
        return abs(self.predicted - self.traced) / base if base else 0.0

    def to_dict(self) -> Dict:
        return {"name": self.name, "kind": self.kind,
                "predicted": self.predicted, "traced": self.traced,
                "rel_err": self.rel_err, "tolerance": self.tolerance,
                "ok": self.ok, "detail": self.detail}

    def describe(self) -> str:
        status = "ok" if self.ok else "MISMATCH"
        line = (f"[{status}] {self.name} {self.kind}: "
                f"predicted={self.predicted:.6g} traced={self.traced:.6g} "
                f"(rel_err={self.rel_err:.2e}, tol={self.tolerance:g})")
        fp = self.detail.get("plan")
        if fp:
            line += (f"\n         plan op_sig={fp.get('op_sig', '?')[:12]} "
                     f"arch_sig={fp.get('arch_sig', '?')[:12]} "
                     f"best_index={fp.get('best_index')}")
        extra = self.detail.get("note")
        if extra and not self.ok:
            line += f"\n         {extra}"
        return line


@dataclass
class ContractReport:
    checks: List[ContractCheck] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.checks)

    @property
    def failures(self) -> List[ContractCheck]:
        return [c for c in self.checks if not c.ok]

    def to_dict(self) -> Dict:
        return {"checked": len(self.checks),
                "passed": sum(1 for c in self.checks if c.ok),
                "failed": len(self.failures),
                "ok": self.ok,
                "checks": [c.to_dict() for c in self.checks]}

    def describe_failures(self) -> str:
        return "\n".join(c.describe() for c in self.failures)


def _mk_check(name: str, kind: str, predicted: float, traced: float,
              tol: float, detail: Dict) -> ContractCheck:
    base = max(abs(predicted), abs(traced))
    err = abs(predicted - traced) / base if base else 0.0
    return ContractCheck(name, kind, float(predicted), float(traced),
                         tol, err <= tol, detail)


def gemm_flops(co) -> float:
    """GEMM FLOPs of a compound op: the number the kernel's FLOP formula
    must reproduce."""
    total = 0.0
    for op in co.gemm_ops():
        pts = 1
        for d in op.dims:
            pts *= co.dim_sizes[d]
        total += pts * op.flops_per_point
    return total


def _plan_fp(plan) -> Dict:
    return {"op_sig": plan.op_sig, "arch_sig": plan.arch_sig,
            "best_index": plan.best_index,
            "engine_version": plan.engine_version}


# ------------------------------------------------------------- kernel arm


def _bf16(*shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="cuda")


def _trace_gemm_softmax(co, blocks):
    from ..kernels.gemm_softmax import gemm_softmax as kernel
    M, K, N = co.dim_sizes["M"], co.dim_sizes["K"], co.dim_sizes["N"]
    with fake_mode():
        return trace_counts(kernel, _bf16(M, K), _bf16(K, N))


def _trace_gemm_layernorm(co, blocks):
    from ..kernels.gemm_layernorm import gemm_layernorm as kernel
    M, K, N = co.dim_sizes["M"], co.dim_sizes["K"], co.dim_sizes["N"]
    with fake_mode():
        return trace_counts(kernel, _bf16(M, K), _bf16(K, N), _bf16(N),
                            _bf16(N))


def _trace_flash_attention(co, blocks):
    from ..kernels.flash_attention import flash_attention_fwd as kernel
    # co dims (workload.flash_attention(M, K, N, L)): M=Sq, K=L=head dim,
    # N=Skv.  causal=False: the compound op models the full score matrix
    M, N, D = co.dim_sizes["M"], co.dim_sizes["N"], co.dim_sizes["K"]
    with fake_mode():
        return trace_counts(lambda q, k, v: kernel(q, k, v, causal=False),
                            _bf16(1, 1, M, D), _bf16(1, 1, N, D),
                            _bf16(1, 1, N, D))


def _trace_ssd(co, chunk):
    from ..kernels.ssd import ssd_scan_fwd as kernel
    # ssd_chunk dims: Cq=chunk, Ds=state, Pd=head dim x heads, Sq=sequence
    S, P, N = co.dim_sizes["Sq"], co.dim_sizes["Pd"], co.dim_sizes["Ds"]
    with fake_mode():
        dA = torch.empty((1, S), dtype=torch.float32, device="cuda")
        return trace_counts(lambda x, a, b, c: kernel(x, a, b, c,
                                                      chunk=chunk),
                            _bf16(1, S, P), dA, _bf16(1, S, N),
                            _bf16(1, S, N))


# family -> tracer(co, blocks) -> TraceCounts.  Tests substitute a broken
# tracer here (the ``tracers`` argument) to show a mismatch is caught.
KERNEL_TRACERS: Dict[str, Callable] = {
    "gemm_softmax": _trace_gemm_softmax,
    "gemm_layernorm": _trace_gemm_layernorm,
    "flash_attention": _trace_flash_attention,
    "ssd": _trace_ssd,
}

SSD_SPLIT_NOTE = (
    "ROADMAP C.18: the bf16 kernel issues (S o L) X twice, once for S o L's "
    "bf16 high part and once for its low part (csrc/ssd_scan.cu), a "
    "product the compound op counts once: predicted = gemm_flops(co) x "
    "chunks + 2 chunk^2 P x chunks, named, not a tolerance")


PASS_NOTE = (
    "the bf16 instance computes every pass's whole width (256 columns a CTA "
    "at 128 rows, 512 at 64; gemm_epilogue.pass_columns) whatever its "
    "slice holds, products the compound op does not count: predicted = "
    "gemm_flops(co) x cluster x pass columns / N, named, not a tolerance")

DSMEM_NOTE = (
    "the plan's stats All-Reduce moves each row's statistic once, in the "
    "op's dtype (DV = rows x dtype bytes a round); the kernel all-reduces "
    "f32 partials (4 B) and every CTA reads all cluster ranks' partials "
    "(csrc/gemm_epilogue.cu, Bf16View::allreduce): predicted = the plan's "
    "bytes x (4 / dtype bytes) x participants, named, not a tolerance")


def _attention_launch_tiling(shape) -> Tuple[int, int]:
    """The pair FlashAttention's launch takes at a kernel-arm shape: (q rows
    an item, keys a tile)."""
    from ..kernels.flash_attention import tiling
    sq, skv, d = shape
    t = tiling(1, 1, 1, max(sq, 128), max(skv, 128), d, torch.bfloat16)
    return (t.q_rows * t.consumers, t.keys)


def _wrapper(family: str):
    """The fused GEMM wrapper a kernel-arm family traces."""
    from ..kernels import gemm_epilogue as ge
    return ge.COUNTERS[family[len("gemm_"):]]


def _plan_allreduces(co, arch, spec) -> List:
    """The AllReduce nodes of the plan's mapping tree."""
    from ..core.ir import build_tree
    from ..core.mapping import CollectiveNode
    root, _ = build_tree(co, arch, spec)
    out, stack = [], [root]
    while stack:
        node = stack.pop()
        if isinstance(node, CollectiveNode):
            if node.col_type == "AllReduce":
                out.append(node)
        else:
            stack.extend(getattr(node, "children", ()))
    return out


def kernel_contract_checks(
        shapes: Optional[Dict[str, Sequence[Tuple[int, ...]]]] = None,
        tol: float = DEFAULT_TOL,
        tracers: Optional[Dict[str, Callable]] = None,
) -> List[ContractCheck]:
    """Contract checks for every kernel shape in ``shapes`` (default: the
    paper shapes).  Each resolves the kernel's plan, runs the entry on
    fake CUDA tensors at the plan's tiling, and compares the formula's
    FLOPs with the compound op's GEMM FLOPs, asserts zero collectives
    (single-card kernels) and that the plan's pair is the launch's."""
    from ..core.plan import get_plan_cache
    from ..core.workload import gemm_softmax
    from ..kernels import gemm_epilogue as ge
    from ..kernels.autotune import (PAPER_KERNEL_SHAPES, _pair_of,
                                    attention_plan_job,
                                    gemm_epilogue_plan_job,
                                    gemm_epilogue_tiling, ssd_chunk_len,
                                    ssd_plan_jobs)
    shapes = shapes if shapes is not None else PAPER_KERNEL_SHAPES
    use = dict(KERNEL_TRACERS)
    if tracers:
        use.update(tracers)
    cache = get_plan_cache()
    checks: List[ContractCheck] = []

    def add(family: str, shape, co, plan, blocks, trace: TraceCounts,
            predicted_flops: float, note: str = "",
            launched=None) -> None:
        name = f"{family}[{','.join(str(s) for s in shape)}]"
        detail = {"family": family, "shape": list(shape),
                  "blocks": list(blocks) if isinstance(blocks, tuple)
                  else blocks,
                  "plan": _plan_fp(plan)}
        if note:
            detail["note"] = note
        checks.append(_mk_check(name, "gemm_flops", predicted_flops,
                                trace.flops, tol, detail))
        checks.append(_mk_check(name, "collective_volume", 0.0,
                                trace.total_collective_dv(), 0.0, detail))
        if launched is not None:
            checks.append(ContractCheck(
                name, "plan_tiling", 0.0, 0.0, 0.0, launched == blocks,
                dict(detail, launched=list(launched))))

    for m, n, k in shapes.get("gemm_epilogue_blocks", ()):
        t = gemm_epilogue_tiling(m, n, k)
        if t is None:
            continue
        # the job of the plan's tiling: one cluster's rows on h100_cluster
        co_cl, arch, kw, ts = next(j for j in gemm_epilogue_plan_job(m, n, k)
                                   if t in j[3])
        plan = cache.resolve(co_cl, arch, **kw)
        nodes = _plan_allreduces(co_cl, arch, plan.spec)
        plan_bytes = sum(nd.data_volume_bytes * nd.count for nd in nodes)
        e = co_cl.tensors["C"].dtype_bytes
        co = gemm_softmax(m, n, k)             # the whole launch
        issued = t.cluster * ge.pass_columns(t, torch.bfloat16)
        blocks = tuple(t)
        for family in ("gemm_softmax", "gemm_layernorm"):
            wrapper = _wrapper(family)
            wrapper.last_tiling = None
            trace = use[family](co, t)
            launched = wrapper.last_tiling
            add(family, (m, n, k), co, plan, blocks, trace,
                gemm_flops(co) * issued / n,
                note="both epilogue kernels share the gemm_softmax plan "
                     "(identical GEMM, different epilogue); "
                     f"{PASS_NOTE} ({gemm_flops(co):.6g} x {issued} / {n})",
                launched=() if launched is None else tuple(launched))
            rounds = ge.ROUNDS[family[len("gemm_"):]]
            kernel_bytes = rounds * t.rows * 4 * t.cluster
            parts = sorted({nd.participants for nd in nodes})
            predicted = plan_bytes * (4 / e) * t.cluster
            checks.append(ContractCheck(
                f"{family}[{m},{n},{k}]", "dsmem_allreduce",
                float(predicted), float(kernel_bytes), 0.0,
                parts == [t.cluster] and len(nodes) == rounds
                and predicted == kernel_bytes,
                {"family": family, "shape": [m, n, k],
                 "blocks": list(blocks), "plan": _plan_fp(plan),
                 "participants": parts, "cluster": t.cluster,
                 "plan_allreduces": len(nodes), "rounds": rounds,
                 "plan_bytes": plan_bytes, "kernel_bytes": kernel_bytes,
                 "note": DSMEM_NOTE}))

    for sq, skv, d in shapes.get("attention_blocks", ()):
        job = attention_plan_job(sq, skv, d)
        if job is None:
            continue
        co, arch, kw, pairs = job
        plan = cache.resolve(co, arch, **kw)
        blocks = _pair_of(plan, pairs)
        trace = use["flash_attention"](co, blocks)
        add("flash_attention", (sq, skv, d), co, plan, blocks, trace,
            gemm_flops(co),
            note="traced at the plan's aligned dims (M=max(sq,128)); "
                 "causal=False matches the non-causal compound op",
            launched=_attention_launch_tiling((sq, skv, d)))

    for s, p, n in shapes.get("ssd_chunk_len", ()):
        jobs = ssd_plan_jobs(s, p, n)
        if not jobs:
            continue
        c_win = ssd_chunk_len(s, p, n)
        for co, arch, kw, c in jobs:
            if c != c_win:
                continue
            plan = cache.resolve(co, arch, **kw)
            trace = use["ssd"](co, c_win)
            nchunks = -(-s // c_win)
            split = 2.0 * c_win * c_win * p * nchunks
            add("ssd", (s, p, n), co, plan, c_win, trace,
                gemm_flops(co) * nchunks + split,
                note=f"per-chunk compound op x {nchunks} chunks; "
                     f"{SSD_SPLIT_NOTE} ({gemm_flops(co) * nchunks:.6g} "
                     f"+ {split:.6g})")
    return checks


# ------------------------------------------------------------ sharded arm


def default_mesh(world: Optional[int] = None):
    """The arms' mesh over the world group: (2, n / 2) ``("data",
    "model")`` on an even world of 4 or more ranks, else (1, n)."""
    import torch.distributed as dist

    from ..launch.mesh import make_auto_mesh
    n = world or dist.get_world_size()
    data, model = (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)
    return make_auto_mesh((data, model), ("data", "model"), "cpu")


@contextlib.contextmanager
def _mesh_or_default(mesh, world: int = 8):
    """``mesh`` as given, or the default mesh of a fake world of ``world``
    ranks made for the block and destroyed after it."""
    if mesh is not None:
        yield mesh
        return
    with fake_world(world):
        yield default_mesh(world)


def _mesh_sizes(mesh) -> Dict[str, int]:
    return {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}


def _world(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= int(s)
    return n


def _wire_fn():
    from ..core.collectives import collective_cost
    from ..core.hardware import tpu_v5e
    noc = tpu_v5e().cluster_noc

    def wire(col_type: str, dv: float, P: int) -> float:
        return collective_cost(col_type, dv, P, noc).volume_bytes
    return wire


def sharded_contract_checks(mesh=None, *, batch: int = 8, seq: int = 16,
                            d_model: int = 64, vocab_p: int = 512,
                            strategies: Sequence[str] = ("dist", "gather"),
                            tol: float = DEFAULT_TOL,
                            ) -> List[ContractCheck]:
    """Run ``sharded_softmax_xent`` (forward) on this rank of ``mesh`` (a
    fake world's (2, 4) mesh when None) on fake tensors and check its
    recorded collectives against the declared schedule.  Records with
    participants <= 1 are ignored (the cost model charges them nothing)."""
    from ..parallel.collective_planner import (sharded_softmax_xent,
                                               softmax_collective_schedule)
    wire = _wire_fn()
    checks: List[ContractCheck] = []
    with _mesh_or_default(mesh) as mesh:
        sizes = _mesh_sizes(mesh)
        dp = sizes.get("pod", 1) * sizes.get("data", 1)
        P_model = sizes.get("model", 1)
        rows_local = (batch * seq) // dp
        v_local = vocab_p // P_model
        real_vocab = vocab_p - max(1, v_local // 4)
        for strategy in strategies:
            with fake_mode():
                h = torch.empty((batch // dp, seq, d_model),
                                device=FAKE_DEVICE)
                w = torch.empty((d_model, v_local), device=FAKE_DEVICE)
                y = torch.empty((batch // dp, seq), dtype=torch.int32,
                                device=FAKE_DEVICE)
                trace = trace_counts(
                    lambda h_, w_, y_, _s=strategy: sharded_softmax_xent(
                        h_, w_, y_, mesh, real_vocab=real_vocab,
                        strategy=_s), h, w, y)
            declared = softmax_collective_schedule(
                strategy, rows_local, vocab_p, P_model, dp_participants=dp)
            name = f"sharded_softmax_xent[{strategy},mesh={dp}x{P_model}]"
            detail_base = {"strategy": strategy, "mesh": [dp, P_model],
                           "rows_local": rows_local, "vocab_p": vocab_p,
                           "declared": [list(c) for c in declared]}
            # the vocab-sharded logits GEMM, over every rank
            predicted_flops = 2.0 * batch * seq * d_model * vocab_p
            checks.append(_mk_check(name, "gemm_flops", predicted_flops,
                                    trace.flops * _world(mesh), tol,
                                    dict(detail_base)))
            traced = {k: r for k, r in trace.collectives.items() if k[1] > 1}
            # distinct declared entries that share a (type, participants)
            # key, on a mesh whose axes have one size, aggregate first
            declared_by_key: dict = {}
            for col_type, dv, P, count in declared:
                agg = declared_by_key.setdefault(
                    (col_type, P), {"count": 0.0, "wire": 0.0})
                agg["count"] += count
                agg["wire"] += wire(col_type, dv * count, P)
            for (col_type, P), agg in declared_by_key.items():
                rec = traced.pop((col_type, P), None)
                detail = dict(detail_base, participants=P,
                              collective=col_type)
                t_count = rec.count if rec else 0.0
                t_dv = rec.dv_bytes if rec else 0.0
                checks.append(_mk_check(f"{name}/{col_type}@P{P}",
                                        "collective_count", agg["count"],
                                        t_count, 0.0, detail))
                checks.append(_mk_check(f"{name}/{col_type}@P{P}",
                                        "collective_wire_bytes", agg["wire"],
                                        wire(col_type, t_dv, P), tol,
                                        detail))
            if traced:
                detail = dict(detail_base)
                detail["undeclared"] = [r.to_dict() for r in traced.values()]
                detail["note"] = ("recorded collectives missing from "
                                  "softmax_collective_schedule")
                extra_dv = sum(r.dv_bytes for r in traced.values())
                checks.append(_mk_check(f"{name}/undeclared",
                                        "collective_volume", 0.0, extra_dv,
                                        0.0, detail))
    return checks


# -------------------------------------------------------------- train arm


# one dense, one MoE: the two loss/combine regimes the declaration
# distinguishes
TRAIN_CONTRACT_CONFIGS: Tuple[str, ...] = ("glm4-9b", "qwen3-moe-30b-a3b")


def train_trace(arch_id: str, mesh, *, batch: int = 8, seq: int = 16,
                microbatches: int = 1, softmax_strategy: Optional[str] = None):
    """(cfg, TraceCounts) of one planner-loss ``make_train_step`` run of
    the smoke config on this rank of ``mesh``, on fake tensors: the state
    and batch from ``launch.specs``, nothing allocated or launched."""
    from ..configs.registry import Shape, get_smoke_config
    from ..launch.specs import batch_specs, state_specs
    from ..models.model import Model
    from ..train.optimizer import OptConfig
    from ..train.train_step import make_train_step

    cfg = get_smoke_config(arch_id)
    if softmax_strategy:
        cfg = cfg.with_(softmax_strategy=softmax_strategy)
    model = Model(cfg)
    step = make_train_step(model, OptConfig(), mesh,
                           microbatches=microbatches, use_planner_loss=True)
    with fake_mode():
        state, _ = state_specs(model, mesh, device=FAKE_DEVICE)
        b = batch_specs(cfg, Shape("contract", seq, batch, "train"), mesh,
                        device=FAKE_DEVICE)
        return cfg, trace_counts(step, state, b)


def train_contract_checks(mesh=None, *,
                          configs: Sequence[str] = TRAIN_CONTRACT_CONFIGS,
                          batch: int = 8, seq: int = 16,
                          microbatches: int = 1,
                          tol: float = DEFAULT_TOL,
                          schedule_fn=None) -> List[ContractCheck]:
    """Audit the train step's collectives against the declared
    ``train_collective_schedule`` on ``mesh`` (a fake world's (2, 4) mesh
    when None).

    The records of explicit-family labels with participants > 1 equal the
    aggregated ``origin == "explicit"`` entries per (type, participants):
    counts exactly, wire through ``collective_cost``; an explicit-family
    record never declared fails.  The other records are reconciled
    against the ``gspmd`` entries (``reconcile_cell``): every finding must
    have a named cause that accounts for it.  The MoE "no token
    all-to-all" claim and a count with no finding are named checks.
    ``schedule_fn`` substitutes a (deliberately wrong) declaration."""
    from ..parallel.collective_planner import train_collective_schedule
    if schedule_fn is None:
        schedule_fn = train_collective_schedule
    wire = _wire_fn()
    checks: List[ContractCheck] = []
    with _mesh_or_default(mesh) as mesh:
        mesh_desc = "x".join(str(int(s)) for s in mesh.shape)
        for arch_id in configs:
            cfg, trace = train_trace(arch_id, mesh, batch=batch, seq=seq,
                                     microbatches=microbatches)
            sched = schedule_fn(cfg, mesh, batch, seq,
                                microbatches=microbatches)
            explicit = [d for d in sched
                        if d.origin == "explicit" and d.participants > 1]
            name = f"train[{arch_id},mesh={mesh_desc},mb={microbatches}]"
            detail_base = {"arch": arch_id, "mesh": mesh_desc,
                           "batch": batch, "seq": seq,
                           "microbatches": microbatches,
                           "schedule": [d.to_dict() for d in sched]}
            ex = TraceCounts()
            for label, col_type, dv, P in trace.records:
                if P > 1 and is_explicit(label):
                    ex.add_collective(col_type, P, 1.0, dv, dv)
            traced = dict(ex.collectives)
            declared_by_key: dict = {}
            for d in explicit:
                agg = declared_by_key.setdefault(
                    (d.col_type, d.participants),
                    {"count": 0.0, "wire": 0.0, "labels": []})
                agg["count"] += d.count
                agg["wire"] += wire(d.col_type, d.dv_bytes * d.count,
                                    d.participants)
                agg["labels"].append(d.label)
            for (col_type, P), agg in sorted(declared_by_key.items()):
                rec = traced.pop((col_type, P), None)
                detail = dict(detail_base, participants=P,
                              collective=col_type,
                              declared_labels=agg["labels"])
                detail["note"] = (
                    f"declared by train_collective_schedule entries "
                    f"{agg['labels']} (parallel/collective_planner.py); a "
                    f"count mismatch means the implementation gained or "
                    f"lost a collective, or an autograd rule changed: "
                    f"update the declaration with the implementation")
                t_count = rec.count if rec else 0.0
                t_dv = rec.dv_bytes if rec else 0.0
                checks.append(_mk_check(f"{name}/{col_type}@P{P}",
                                        "collective_count", agg["count"],
                                        t_count, 0.0, detail))
                checks.append(_mk_check(f"{name}/{col_type}@P{P}",
                                        "collective_wire_bytes", agg["wire"],
                                        wire(col_type, t_dv, P), tol,
                                        detail))
            if traced:
                detail = dict(detail_base)
                detail["undeclared"] = [r.to_dict() for r in traced.values()]
                detail["note"] = (
                    "explicit-family collectives missing from "
                    "train_collective_schedule: the step issues collectives "
                    "the cost model never charges; declare them (with "
                    "origin='explicit') in parallel/collective_planner.py")
                extra_dv = sum(r.dv_bytes for r in traced.values())
                checks.append(_mk_check(f"{name}/undeclared",
                                        "collective_volume", 0.0, extra_dv,
                                        0.0, detail))
            report = reconcile_cell(trace, schedule=sched)
            left = [f for f in report.findings if not f["explained"]]
            detail = dict(detail_base, reconcile=report.to_dict())
            detail["note"] = ("every disagreement of the recorded tp/, "
                              "grads/ and zero1/ collectives with the gspmd "
                              "entries must have a named cause: "
                              + "; ".join(f["detail"] for f in left))
            checks.append(_mk_check(f"{name}/gspmd-reconciled",
                                    "reconcile_findings", 0.0,
                                    float(len(left)), 0.0, detail))
            if cfg.is_moe:
                a2a = sum(r.count for r in trace.collectives.values()
                          if r.col_type == "AllToAll")
                detail = dict(detail_base)
                detail["note"] = ("models/moe.py claims the expert combine "
                                  "needs no token all-to-all; the step "
                                  "must record zero AllToAll")
                checks.append(_mk_check(f"{name}/moe-no-all-to-all",
                                        "collective_count", 0.0, a2a, 0.0,
                                        detail))
            detail = dict(detail_base, findings=list(trace.findings))
            checks.append(_mk_check(f"{name}/statically-bounded",
                                    "analysis_findings", 0.0,
                                    float(len(trace.findings)), 0.0,
                                    detail))
    return checks


# ------------------------------------------------------------------ entry


ARMS = ("kernel", "sharded", "train")


def run_contracts(shapes=None, *, sharded: bool = True,
                  arms: Optional[Sequence[str]] = None,
                  tol: float = DEFAULT_TOL, mesh=None) -> ContractReport:
    """Selected contract arms as one report (the CLI's entry point).
    ``arms`` selects from ``("kernel", "sharded", "train")``; when None,
    ``sharded`` picks kernel(+sharded).  The sharded and train arms share
    one fake world of 8 ranks (a (2, 4) mesh) unless ``mesh`` is given."""
    if arms is None:
        arms = ("kernel", "sharded") if sharded else ("kernel",)
    unknown = set(arms) - set(ARMS)
    if unknown:
        raise ValueError(f"unknown contract arms {sorted(unknown)}; "
                         f"pick from {ARMS}")
    report = ContractReport()
    if "kernel" in arms:
        report.checks.extend(kernel_contract_checks(shapes, tol=tol))
    if "sharded" in arms or "train" in arms:
        with _mesh_or_default(mesh) as m:
            if "sharded" in arms:
                report.checks.extend(sharded_contract_checks(m, tol=tol))
            if "train" in arms:
                report.checks.extend(train_contract_checks(m, tol=tol))
    return report
