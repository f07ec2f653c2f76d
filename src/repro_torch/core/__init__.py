"""The port's copy of the COMET core — the paper's primary contribution:
explicit-collective mapping representation + compound-operation cost model
+ map-space search, with the plan store the serve engine warms, and the
YAML front end.  The same exports as ``repro/core/__init__.py``, plus the
port's card, :func:`~.hardware.h100`."""
from . import (batcheval, collectives, cost, hardware, ir, mapping, plan,
               search, validate, workload, yamlio)
from .batcheval import (BatchResult, ParetoArchive, Topology,
                        evaluate_specs_batch, evaluate_topology_grid,
                        pareto_merge, pareto_merge3)
from .hardware import Arch, cloud, edge, h100, tpu_v5e
from .ir import MappingResult, MappingSpec, build_tree, evaluate_mapping
from .plan import ENGINE_VERSION, MappingPlan, PlanCache, get_plan_cache
from .search import SearchResult, search as map_search, search_many
from .workload import (CompoundOp, attention, flash_attention, gemm,
                       gemm_layernorm, gemm_softmax, ssd_chunk)

__all__ = [
    "Arch", "cloud", "edge", "h100", "tpu_v5e",
    "MappingResult", "MappingSpec", "build_tree", "evaluate_mapping",
    "SearchResult", "map_search", "search_many",
    "BatchResult", "ParetoArchive", "Topology", "evaluate_specs_batch",
    "evaluate_topology_grid", "pareto_merge", "pareto_merge3",
    "ENGINE_VERSION", "MappingPlan", "PlanCache", "get_plan_cache",
    "CompoundOp", "attention", "flash_attention", "gemm",
    "gemm_layernorm", "gemm_softmax", "ssd_chunk",
]
