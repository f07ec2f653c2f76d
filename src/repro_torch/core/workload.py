"""Workload description for compound operations (COMET §II, §IV).

A *compound operation* is a DAG of elementary operations (GEMM and
non-GEMM/SIMD ops) connected through named tensors.  Each elementary op
declares its iteration space as a set of named dimensions; tensors declare
which dimensions they span.  This is the direct analogue of the paper's
YAML workload description.

Builders are provided for the paper's three case-study compound ops:
GEMM-Softmax, GEMM-LayerNorm and self-attention (plus the FlashAttention
decomposition of Fig. 2(a)), and for the SSD (Mamba-2) chunk dataflow used
by the TPU integration.

Port-local copy of ``repro/core/workload.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "TensorSpec",
    "Operation",
    "CompoundOp",
    "gemm",
    "gemm_softmax",
    "gemm_layernorm",
    "attention",
    "flash_attention",
    "ssd_chunk",
]


@dataclass(frozen=True)
class TensorSpec:
    """A named tensor spanning a subset of the compound op's dimensions."""

    name: str
    dims: Tuple[str, ...]
    dtype_bytes: int = 2  # bf16 by default

    def size_elems(self, dim_sizes: Dict[str, int]) -> int:
        n = 1
        for d in self.dims:
            n *= dim_sizes[d]
        return n

    def size_bytes(self, dim_sizes: Dict[str, int]) -> int:
        return self.size_elems(dim_sizes) * self.dtype_bytes


@dataclass(frozen=True)
class Operation:
    """One elementary operation inside a compound op.

    kind:          'gemm' (runs on the systolic/MXU unit) or 'simd'
                   (runs on the vector/SIMD unit).
    dims:          iteration-space dimensions of this op.
    reduce_dims:   subset of ``dims`` reduced away in the output.
    inputs/output: tensor names.
    flops_per_point: arithmetic ops per iteration-space point (e.g. a GEMM
                   point is one MAC = 2 flops; exp ~ 1 'op' on the SIMD
                   unit; fused multiply-adds in normalization count each).
    """

    name: str
    kind: str  # 'gemm' | 'simd'
    dims: Tuple[str, ...]
    inputs: Tuple[str, ...]
    output: str
    reduce_dims: Tuple[str, ...] = ()
    flops_per_point: float = 2.0

    def __post_init__(self) -> None:
        if self.kind not in ("gemm", "simd"):
            raise ValueError(f"unknown op kind {self.kind!r}")
        for d in self.reduce_dims:
            if d not in self.dims:
                raise ValueError(f"reduce dim {d} not in dims of {self.name}")


@dataclass
class CompoundOp:
    """A compound operation: dims, tensors and a topologically-ordered op list."""

    name: str
    dim_sizes: Dict[str, int]
    tensors: Dict[str, TensorSpec]
    ops: List[Operation] = field(default_factory=list)
    # Tensors that live in DRAM at the boundary of the compound op.
    external_inputs: Tuple[str, ...] = ()
    external_outputs: Tuple[str, ...] = ()

    # ------------------------------------------------------------------ DAG
    def producer(self, tensor: str) -> Optional[Operation]:
        for op in self.ops:
            if op.output == tensor:
                return op
        return None

    def consumers(self, tensor: str) -> List[Operation]:
        return [op for op in self.ops if tensor in op.inputs]

    def intermediates(self) -> List[str]:
        ext = set(self.external_inputs) | set(self.external_outputs)
        return [t for t in self.tensors if t not in ext]

    # ----------------------------------------------------------------- util
    def op(self, name: str) -> Operation:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    def validate(self) -> None:
        for op in self.ops:
            for t in op.inputs + (op.output,):
                if t not in self.tensors:
                    raise ValueError(f"{op.name}: unknown tensor {t}")
            for d in op.dims:
                if d not in self.dim_sizes:
                    raise ValueError(f"{op.name}: unknown dim {d}")
        # topological order: every input is external or already produced
        produced = set(self.external_inputs)
        for op in self.ops:
            for t in op.inputs:
                if t not in produced:
                    raise ValueError(
                        f"{op.name}: input {t} not produced before use"
                    )
            produced.add(op.output)

    def total_flops(self) -> float:
        total = 0.0
        for op in self.ops:
            pts = 1
            for d in op.dims:
                pts *= self.dim_sizes[d]
            total += pts * op.flops_per_point
        return total

    def gemm_ops(self) -> List[Operation]:
        return [o for o in self.ops if o.kind == "gemm"]

    def simd_ops(self) -> List[Operation]:
        return [o for o in self.ops if o.kind == "simd"]


# ===================================================================== builders


def gemm(M: int, N: int, K: int, *, name: str = "gemm", dtype_bytes: int = 2) -> CompoundOp:
    """Plain C[M,N] = A[M,K] @ B[K,N] (single-operator baseline)."""
    t = {
        "A": TensorSpec("A", ("M", "K"), dtype_bytes),
        "B": TensorSpec("B", ("K", "N"), dtype_bytes),
        "C": TensorSpec("C", ("M", "N"), dtype_bytes),
    }
    ops = [
        Operation("Op1_gemm", "gemm", ("M", "N", "K"), ("A", "B"), "C",
                  reduce_dims=("K",), flops_per_point=2.0),
    ]
    co = CompoundOp(name, {"M": M, "N": N, "K": K}, t, ops,
                    external_inputs=("A", "B"), external_outputs=("C",))
    co.validate()
    return co


def gemm_softmax(M: int, N: int, K: int, *, dtype_bytes: int = 2) -> CompoundOp:
    """GEMM followed by row-softmax over N, decomposed as Fig. 4(a).

    Op1: C = A@B          (gemm)
    Op3: m = rowmax(C)    (simd, reduce N)
    Op4: D = C - m        (simd)
    Op5: E = exp(D)       (simd)
    Op6: s = rowsum(E)    (simd, reduce N)
    Op7: P = E / s        (simd)
    """
    t = {
        "A": TensorSpec("A", ("M", "K"), dtype_bytes),
        "B": TensorSpec("B", ("K", "N"), dtype_bytes),
        "C": TensorSpec("C", ("M", "N"), dtype_bytes),
        "mx": TensorSpec("mx", ("M",), dtype_bytes),
        "D": TensorSpec("D", ("M", "N"), dtype_bytes),
        "E": TensorSpec("E", ("M", "N"), dtype_bytes),
        "sm": TensorSpec("sm", ("M",), dtype_bytes),
        "P": TensorSpec("P", ("M", "N"), dtype_bytes),
    }
    ops = [
        Operation("Op1_gemm", "gemm", ("M", "N", "K"), ("A", "B"), "C",
                  reduce_dims=("K",), flops_per_point=2.0),
        Operation("Op3_rowmax", "simd", ("M", "N"), ("C",), "mx",
                  reduce_dims=("N",), flops_per_point=1.0),
        Operation("Op4_sub", "simd", ("M", "N"), ("C", "mx"), "D",
                  flops_per_point=1.0),
        Operation("Op5_exp", "simd", ("M", "N"), ("D",), "E",
                  flops_per_point=1.0),
        Operation("Op6_rowsum", "simd", ("M", "N"), ("E",), "sm",
                  reduce_dims=("N",), flops_per_point=1.0),
        Operation("Op7_div", "simd", ("M", "N"), ("E", "sm"), "P",
                  flops_per_point=1.0),
    ]
    co = CompoundOp("gemm_softmax", {"M": M, "N": N, "K": K}, t, ops,
                    external_inputs=("A", "B"), external_outputs=("P",))
    co.validate()
    return co


def gemm_layernorm(M: int, N: int, K: int, *, dtype_bytes: int = 2) -> CompoundOp:
    """GEMM followed by LayerNorm over N.

    LayerNorm decomposes into more elementary ops than Softmax (the paper
    notes this is why its fusion win is larger):
    Op1: C = A@B            (gemm)
    Op2: mu = rowmean(C)    (simd, reduce N)
    Op3: D  = C - mu        (simd)
    Op4: sq = D*D           (simd)
    Op5: var= rowmean(sq)   (simd, reduce N)
    Op6: r  = rsqrt(var+e)  (simd, on M-vector)
    Op7: Nm = D * r         (simd)
    Op8: Y  = Nm*gamma+beta (simd, affine)
    """
    t = {
        "A": TensorSpec("A", ("M", "K"), dtype_bytes),
        "B": TensorSpec("B", ("K", "N"), dtype_bytes),
        "C": TensorSpec("C", ("M", "N"), dtype_bytes),
        "mu": TensorSpec("mu", ("M",), dtype_bytes),
        "D": TensorSpec("D", ("M", "N"), dtype_bytes),
        "sq": TensorSpec("sq", ("M", "N"), dtype_bytes),
        "var": TensorSpec("var", ("M",), dtype_bytes),
        "r": TensorSpec("r", ("M",), dtype_bytes),
        "Nm": TensorSpec("Nm", ("M", "N"), dtype_bytes),
        "gamma": TensorSpec("gamma", ("N",), dtype_bytes),
        "beta": TensorSpec("beta", ("N",), dtype_bytes),
        "Y": TensorSpec("Y", ("M", "N"), dtype_bytes),
    }
    ops = [
        Operation("Op1_gemm", "gemm", ("M", "N", "K"), ("A", "B"), "C",
                  reduce_dims=("K",), flops_per_point=2.0),
        Operation("Op2_mean", "simd", ("M", "N"), ("C",), "mu",
                  reduce_dims=("N",), flops_per_point=1.0),
        Operation("Op3_sub", "simd", ("M", "N"), ("C", "mu"), "D",
                  flops_per_point=1.0),
        Operation("Op4_sq", "simd", ("M", "N"), ("D",), "sq",
                  flops_per_point=1.0),
        Operation("Op5_var", "simd", ("M", "N"), ("sq",), "var",
                  reduce_dims=("N",), flops_per_point=1.0),
        Operation("Op6_rsqrt", "simd", ("M",), ("var",), "r",
                  flops_per_point=4.0),
        Operation("Op7_norm", "simd", ("M", "N"), ("D", "r"), "Nm",
                  flops_per_point=1.0),
        Operation("Op8_affine", "simd", ("M", "N"), ("Nm", "gamma", "beta"), "Y",
                  flops_per_point=2.0),
    ]
    co = CompoundOp("gemm_layernorm", {"M": M, "N": N, "K": K}, t, ops,
                    external_inputs=("A", "B", "gamma", "beta"),
                    external_outputs=("Y",))
    co.validate()
    return co


def attention(M: int, K: int, N: int, L: int, *, dtype_bytes: int = 2) -> CompoundOp:
    """Self-attention: S = Q@K^T, P = softmax_N(S), O = P@V.

    Q: (M, K)  Kt: (K, N)  V: (N, L)  O: (M, L)  — the paper's Table III/IV
    shape convention.
    """
    t = {
        "Q": TensorSpec("Q", ("M", "K"), dtype_bytes),
        "Kt": TensorSpec("Kt", ("K", "N"), dtype_bytes),
        "V": TensorSpec("V", ("N", "L"), dtype_bytes),
        "S": TensorSpec("S", ("M", "N"), dtype_bytes),
        "mx": TensorSpec("mx", ("M",), dtype_bytes),
        "D": TensorSpec("D", ("M", "N"), dtype_bytes),
        "E": TensorSpec("E", ("M", "N"), dtype_bytes),
        "sm": TensorSpec("sm", ("M",), dtype_bytes),
        "P": TensorSpec("P", ("M", "N"), dtype_bytes),
        "O": TensorSpec("O", ("M", "L"), dtype_bytes),
    }
    ops = [
        Operation("Op1_score", "gemm", ("M", "N", "K"), ("Q", "Kt"), "S",
                  reduce_dims=("K",), flops_per_point=2.0),
        Operation("Op3_rowmax", "simd", ("M", "N"), ("S",), "mx",
                  reduce_dims=("N",), flops_per_point=1.0),
        Operation("Op4_sub", "simd", ("M", "N"), ("S", "mx"), "D",
                  flops_per_point=1.0),
        Operation("Op5_exp", "simd", ("M", "N"), ("D",), "E",
                  flops_per_point=1.0),
        Operation("Op6_rowsum", "simd", ("M", "N"), ("E",), "sm",
                  reduce_dims=("N",), flops_per_point=1.0),
        Operation("Op7_div", "simd", ("M", "N"), ("E", "sm"), "P",
                  flops_per_point=1.0),
        Operation("Op8_context", "gemm", ("M", "L", "N"), ("P", "V"), "O",
                  reduce_dims=("N",), flops_per_point=2.0),
    ]
    co = CompoundOp("attention", {"M": M, "N": N, "K": K, "L": L}, t, ops,
                    external_inputs=("Q", "Kt", "V"), external_outputs=("O",))
    co.validate()
    return co


def flash_attention(M: int, K: int, N: int, L: int, *, dtype_bytes: int = 2) -> CompoundOp:
    """FlashAttention decomposition (Fig. 2(a)): online softmax adds extra
    non-GEMM work (running max merge, rescale of the accumulator) relative
    to plain attention — the paper observes this increases SIMD latency
    while eliminating off-chip traffic for S/P.
    """
    base = attention(M, K, N, L, dtype_bytes=dtype_bytes)
    t = dict(base.tensors)
    t.update({
        "m_run": TensorSpec("m_run", ("M",), dtype_bytes),
        "alpha": TensorSpec("alpha", ("M",), dtype_bytes),
        "Oacc": TensorSpec("Oacc", ("M", "L"), dtype_bytes),
    })
    ops = list(base.ops)
    # Extra online-softmax ops (block-merge arithmetic), all SIMD:
    ops.insert(2, Operation("Op3b_maxmerge", "simd", ("M",), ("mx",), "m_run",
                            flops_per_point=2.0))
    ops.insert(6, Operation("Op6b_scale", "simd", ("M",), ("sm",), "alpha",
                            flops_per_point=3.0))
    ops.append(Operation("Op9_rescale", "simd", ("M", "L"), ("O", "alpha"),
                         "Oacc", flops_per_point=2.0))
    co = CompoundOp("flash_attention", dict(base.dim_sizes), t, ops,
                    external_inputs=("Q", "Kt", "V"),
                    external_outputs=("Oacc",))
    co.validate()
    return co


def ssd_chunk(S: int, H: int, P: int, Dst: int, C: int, *, dtype_bytes: int = 2) -> CompoundOp:
    """One SSD (Mamba-2) chunk step as a compound op (TPU integration):

    per chunk of length C with H heads, head dim P, state Dst:
      Op1: G  = Bc^T @ Xc        (gemm,  K=C contraction  -> state update)
      Op2: Sdec = decay(G)       (simd,  cumulative decay weights)
      Op3: Yl = (Cc @ state)     (gemm,  inter-chunk output)
      Op4: A  = Cc @ Bc^T        (gemm,  intra-chunk attention-like)
      Op5: Am = A * Lmask        (simd,  causal decay mask)
      Op6: Yd = Am @ Xc          (gemm,  intra-chunk output)
      Op7: Y  = Yl + Yd          (simd)
    Dimensions: Sq=C (chunk len), Dst (state), P (head dim); H folded into
    the M dimension.
    """
    t = {
        "Xc": TensorSpec("Xc", ("Cq", "Pd"), dtype_bytes),
        "Bc": TensorSpec("Bc", ("Cq", "Ds"), dtype_bytes),
        "Cc": TensorSpec("Cc", ("Cq", "Ds"), dtype_bytes),
        "G": TensorSpec("G", ("Ds", "Pd"), dtype_bytes),
        "St": TensorSpec("St", ("Ds", "Pd"), dtype_bytes),
        "Yl": TensorSpec("Yl", ("Cq", "Pd"), dtype_bytes),
        "A": TensorSpec("A", ("Cq", "Cq2"), dtype_bytes),
        "Am": TensorSpec("Am", ("Cq", "Cq2"), dtype_bytes),
        "Lmask": TensorSpec("Lmask", ("Cq", "Cq2"), dtype_bytes),
        "Yd": TensorSpec("Yd", ("Cq", "Pd"), dtype_bytes),
        "Y": TensorSpec("Y", ("Cq", "Pd"), dtype_bytes),
    }
    ops = [
        Operation("Op1_state", "gemm", ("Ds", "Pd", "Cq"), ("Bc", "Xc"), "G",
                  reduce_dims=("Cq",), flops_per_point=2.0),
        Operation("Op2_decay", "simd", ("Ds", "Pd"), ("G",), "St",
                  flops_per_point=2.0),
        Operation("Op3_inter", "gemm", ("Cq", "Pd", "Ds"), ("Cc", "St"), "Yl",
                  reduce_dims=("Ds",), flops_per_point=2.0),
        Operation("Op4_intra", "gemm", ("Cq", "Cq2", "Ds"), ("Cc", "Bc"), "A",
                  reduce_dims=("Ds",), flops_per_point=2.0),
        Operation("Op5_mask", "simd", ("Cq", "Cq2"), ("A", "Lmask"), "Am",
                  flops_per_point=1.0),
        Operation("Op6_out", "gemm", ("Cq", "Pd", "Cq2"), ("Am", "Xc"), "Yd",
                  reduce_dims=("Cq2",), flops_per_point=2.0),
        Operation("Op7_add", "simd", ("Cq", "Pd"), ("Yl", "Yd"), "Y",
                  flops_per_point=1.0),
    ]
    dims = {"Cq": C, "Cq2": C, "Ds": Dst, "Pd": P * H, "Sq": S}
    co = CompoundOp("ssd_chunk", dims, t, ops,
                    external_inputs=("Xc", "Bc", "Cc", "Lmask"),
                    external_outputs=("Y",))
    co.validate()
    return co
