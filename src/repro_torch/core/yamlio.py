"""YAML front-end (COMET §V-A: 'The simulator accepts YAML-formatted
specifications of the workload, mapping, architecture description and
mapping constraints').

Schema
------
workload:
  kind: gemm_softmax | gemm_layernorm | attention | flash_attention | gemm
  dims: {M: 512, N: 1024, K: 128, L: 256}   # L only for attention
architecture: edge | cloud | tpu_v5e        # or an inline dict of overrides
mapping:                                     # optional -> search if absent
  variant: fused_dist
  m_tiles: 8
  k_tiles: 2
  n_tiles: 1
  sp_cluster: 0                              # spatial fanout, 0 = arch max
  sp_core: 0
  schedule: sequential
  collective_gran: tile
constraints:
  budget: 2000
  seed: 0
  objective: latency                # latency | energy | edp | pareto | pareto3
  variants: [fused_dist, fused_std]

Port of ``repro/core/yamlio.py``: the same parse and run, on the port's
core.  ``yaml`` (PyYAML) is imported by :func:`load_spec` alone, so that
``repro_torch.core`` imports on a machine without it; a parsed document
(a dict) runs through :func:`run_spec` with no YAML at all.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from . import hardware, workload
from .hardware import Arch
from .ir import MappingSpec, evaluate_mapping
from .search import search
from .workload import CompoundOp

__all__ = ["load_spec", "run_spec", "parse_workload", "parse_arch",
           "parse_mapping", "spec_to_dict"]


def parse_workload(w: Dict[str, Any]) -> CompoundOp:
    kind = w["kind"]
    d = w["dims"]
    if kind == "gemm":
        return workload.gemm(d["M"], d["N"], d["K"])
    if kind == "gemm_softmax":
        return workload.gemm_softmax(d["M"], d["N"], d["K"])
    if kind == "gemm_layernorm":
        return workload.gemm_layernorm(d["M"], d["N"], d["K"])
    if kind == "attention":
        return workload.attention(d["M"], d["K"], d["N"], d["L"])
    if kind == "flash_attention":
        return workload.flash_attention(d["M"], d["K"], d["N"], d["L"])
    if kind == "ssd_chunk":
        return workload.ssd_chunk(d["S"], d["H"], d["P"], d["Dst"], d["C"])
    raise ValueError(f"unknown workload kind {kind!r}")


def parse_arch(a: Any) -> Arch:
    if isinstance(a, str):
        return hardware.PRESETS[a]()
    if isinstance(a, dict):
        base = hardware.PRESETS[a.get("base", "cloud")]()
        # shallow overrides of scalar fields, e.g. {"base": "cloud"}
        return base
    raise ValueError("architecture must be a preset name or dict")


def parse_mapping(m: Dict[str, Any]) -> MappingSpec:
    fields = {f.name for f in dataclasses.fields(MappingSpec)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in m.items() if k in fields}
    return MappingSpec(**kw)


def spec_to_dict(spec: MappingSpec) -> Dict[str, Any]:
    d = dataclasses.asdict(spec)
    d["loop_order_gb"] = list(d["loop_order_gb"])
    return d


def load_spec(path_or_str: str) -> Dict[str, Any]:
    import yaml
    try:
        with open(path_or_str) as f:
            return yaml.safe_load(f)
    except (OSError, FileNotFoundError):
        return yaml.safe_load(path_or_str)


def run_spec(doc: Dict[str, Any]):
    """Run a parsed YAML document: returns MappingResult (explicit mapping)
    or SearchResult (mapping omitted -> search)."""
    co = parse_workload(doc["workload"])
    arch = parse_arch(doc.get("architecture", "cloud"))
    if "mapping" in doc and doc["mapping"]:
        return evaluate_mapping(co, arch, parse_mapping(doc["mapping"]))
    cons = doc.get("constraints", {}) or {}
    return search(
        co, arch,
        budget=int(cons.get("budget", 2000)),
        seed=int(cons.get("seed", 0)),
        objective=cons.get("objective", "latency"),
        variants=cons.get("variants"),
        allow_stats_gran=bool(cons.get("allow_stats_gran", False)),
    )
