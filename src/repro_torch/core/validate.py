"""Memory-fit validation (COMET Fig. 3: 'Validation' stage).

Before a mapping instance is converted to the IR and costed, COMET checks
that all tensors staged at each memory level fit within that level's
capacity (×2 for double buffering, §IV-B).  Invalid mappings are rejected
by the mapping-instance generator / search.

Port-local copy of ``repro/core/validate.py`` (the port imports nothing of
the JAX package); ``tests/test_torch_core.py`` and
``tests/test_torch_plan.py`` hold it to the original.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .hardware import Arch
from .mapping import CollectiveNode, Node, TileNode, Tiling
from .numerics import vmin
from .workload import TensorSpec

__all__ = ["validate_tree", "validate_and_headroom", "validity_mask",
           "validity_and_headroom", "validity_headroom_levels",
           "validate_headroom_levels", "capacity_headroom",
           "ValidationError", "residency_report"]


class ValidationError(Exception):
    pass


def _staged_tensors(node: TileNode) -> List[str]:
    """Tensors resident at this node: its own i/o plus everything its
    direct children exchange (fused intermediates live here)."""
    names = set(node.input_tensors) | set(node.output_tensors)
    for ch in node.children:
        if isinstance(ch, TileNode):
            names |= set(ch.input_tensors) | set(ch.output_tensors)
        elif isinstance(ch, CollectiveNode):
            names.add(ch.tensor)
    return sorted(names)


def residency_report(node: Node, arch: Arch, tiling: Tiling,
                     tensors: Dict[str, TensorSpec]) -> List[Tuple[str, str, float, float]]:
    """[(level, label, resident_bytes, capacity_bytes)] for every TileNode."""
    out: List[Tuple[str, str, float, float]] = []

    def rec(n: Node) -> None:
        if not isinstance(n, TileNode):
            return
        staged = _staged_tensors(n)
        dbl = 2.0 if arch.level(n.level).double_buffered else 1.0
        resident = n.extra_resident_bytes * 1.0
        for t in staged:
            if t in n.bypass_tensors:
                continue
            resident = resident + tiling.tensor_tile_bytes(
                tensors[t], n.level, below=True) * dbl
        if n.level == "OB":
            # split: inputs -> IB+WB, outputs -> OB
            cap = (arch.ib.size_bytes + arch.wb.size_bytes + arch.ob.size_bytes)
        else:
            cap = arch.level(n.level).size_bytes
        out.append((n.level, n.label or f"T[{n.level}]^{n.index}", resident, cap))
        for ch in n.children:
            rec(ch)

    rec(node)
    return out


def validate_tree(node: Node, arch: Arch, tiling: Tiling,
                  tensors: Dict[str, TensorSpec], *, raise_on_fail: bool = False) -> bool:
    """True iff every TileNode's staged tensors fit its level capacity."""
    tiling.validate()
    for level, label, resident, cap in residency_report(node, arch, tiling, tensors):
        if level == "DRAM":
            continue  # DRAM holds full tensors by construction
        if resident > cap:
            if raise_on_fail:
                raise ValidationError(
                    f"{label}: {resident/1024:.1f} KiB > capacity {cap/1024:.1f} KiB")
            return False
    return True


def validity_mask(node: Node, arch: Arch, tiling: Tiling,
                  tensors: Dict[str, TensorSpec]) -> np.ndarray:
    """Batched analogue of :func:`validate_tree` for array-valued tilings:
    elementwise True where the tiling is not over-factored AND every
    TileNode's staged tensors fit its level capacity (exactly the grid
    points for which the per-spec path would return True rather than
    raising or returning False)."""
    return validity_and_headroom(node, arch, tiling, tensors)[0]


def validity_and_headroom(node: Node, arch: Arch, tiling: Tiling,
                          tensors: Dict[str, TensorSpec]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(validity mask, capacity headroom) from one residency walk.

    Headroom is the mapping's worst relative slack: ``min`` over all
    non-DRAM TileNodes of ``(capacity - resident) / capacity``.  1.0 means
    the buffers are untouched, 0.0 exactly full, negative over capacity
    (such points are also invalid).  It is the third objective channel of
    the provisioning-study Pareto fronts (``objective='pareto3'``)."""
    ok, hr, _levels = validity_headroom_levels(node, arch, tiling, tensors)
    return ok, hr


def validity_headroom_levels(node: Node, arch: Arch, tiling: Tiling,
                             tensors: Dict[str, TensorSpec]
                             ) -> Tuple[np.ndarray, np.ndarray,
                                        Dict[str, np.ndarray]]:
    """(validity mask, folded headroom, per-level headroom) from one
    residency walk.

    The per-level dict maps each non-DRAM memory level present in the
    tree (``'GB'`` — the per-cluster global buffer — and ``'OB'`` — the
    per-core IB+WB+OB budget) to the worst relative slack among that
    level's TileNodes only, so provisioning studies can size the cluster
    and core buffers independently instead of reading the folded
    worst-over-all-levels scalar.  The folded headroom equals the ``min``
    across the per-level values (bit-identical to the historical
    scalar)."""
    ok = np.asarray(tiling.overfactor_mask())
    levels: Dict[str, np.ndarray] = {}
    for level, _label, resident, cap in residency_report(node, arch, tiling,
                                                         tensors):
        if level == "DRAM":
            continue  # DRAM holds full tensors by construction
        ok = np.logical_and(ok, resident <= cap)
        frac = (cap - np.asarray(resident, dtype=np.float64)) / cap
        prev = levels.get(level)
        levels[level] = frac if prev is None else np.minimum(prev, frac)
    hr = np.asarray(1.0)
    for frac in levels.values():
        hr = np.minimum(hr, frac)
    return ok, hr, levels


def validate_and_headroom(node: Node, arch: Arch, tiling: Tiling,
                          tensors: Dict[str, TensorSpec]
                          ) -> Tuple[bool, float]:
    """Scalar-path fusion of :func:`validate_tree` and
    :func:`capacity_headroom`: one residency walk yields both the
    validity verdict and the headroom (the per-spec evaluation hot path
    must not pay the tensor-tile walk twice).  Raises like
    ``validate_tree`` for inconsistent tilings."""
    valid, hr, _levels = validate_headroom_levels(node, arch, tiling, tensors)
    return valid, hr


def validate_headroom_levels(node: Node, arch: Arch, tiling: Tiling,
                             tensors: Dict[str, TensorSpec]
                             ) -> Tuple[bool, float, Dict[str, float]]:
    """Scalar-path analogue of :func:`validity_headroom_levels`: one
    residency walk yields (valid, folded headroom, per-level headroom).
    The per-level dict holds each non-DRAM level's own worst slack (GB =
    cluster buffer, OB = per-core IB+WB+OB budget); the folded value is
    their ``min``.  Raises like ``validate_tree`` for inconsistent
    tilings."""
    tiling.validate()
    valid = True
    levels: Dict[str, float] = {}
    for level, _label, resident, cap in residency_report(node, arch, tiling,
                                                         tensors):
        if level == "DRAM":
            continue
        if resident > cap:
            valid = False
        frac = (cap - resident) / cap
        levels[level] = frac if level not in levels \
            else vmin(levels[level], frac)
    hr = 1.0
    for frac in levels.values():
        hr = vmin(hr, frac)
    return valid, hr, levels


def capacity_headroom(node: Node, arch: Arch, tiling: Tiling,
                      tensors: Dict[str, TensorSpec]) -> float:
    """Scalar-path capacity headroom: ``min`` over non-DRAM TileNodes of
    ``(capacity - resident) / capacity`` (see
    :func:`validity_and_headroom`); plain Python float for scalar
    tilings."""
    hr = 1.0
    for level, _label, resident, cap in residency_report(node, arch, tiling,
                                                         tensors):
        if level == "DRAM":
            continue
        hr = vmin(hr, (cap - resident) / cap)
    return hr
