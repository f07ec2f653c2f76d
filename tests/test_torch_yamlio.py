"""The port's YAML front end against the JAX package's on the CPU: for every
workload kind of the schema, with an explicit mapping and with the search
a missing mapping starts, the port's ``run_spec`` on the same YAML text
gives the same result, bit for bit (latency, energy, validity, headroom,
the cost breakdown, the mapping tree, the search's counts, history and
front).  ``import repro_torch.core`` works where PyYAML cannot be imported.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import yamlio as jy
from repro.core.mapping import tree_str as jtree_str
from repro_torch.core import yamlio as ty
from repro_torch.core.mapping import tree_str as ttree_str

ROOT = Path(__file__).resolve().parents[1]

WORKLOADS = {
    "gemm": "{M: 256, N: 1024, K: 128}",
    "gemm_softmax": "{M: 512, N: 1024, K: 128}",
    "gemm_layernorm": "{M: 256, N: 2048, K: 64}",
    "attention": "{M: 256, K: 128, N: 512, L: 128}",
    "flash_attention": "{M: 256, K: 128, N: 512, L: 128}",
    "ssd_chunk": "{S: 256, H: 4, P: 64, Dst: 16, C: 64}",
}
MAPPINGS = {
    "gemm": "variant: unfused\n  m_tiles: 4\n  k_tiles: 2",
    "gemm_softmax": "variant: fused_dist\n  m_tiles: 8\n  k_tiles: 2\n"
                    "  collective_gran: stats",
    "gemm_layernorm": "variant: fused_std\n  m_tiles: 4\n  k_tiles: 1\n"
                      "  schedule: pipelined",
    "attention": "variant: pfa\n  m_tiles: 4",
    "flash_attention": "variant: fa\n  m_tiles: 4\n  n_tiles: 2",
    "ssd_chunk": "variant: ssd_fused\n  m_tiles: 4",
}


def _doc(kind, arch, mapping):
    text = f"workload:\n  kind: {kind}\n  dims: {WORKLOADS[kind]}\n" \
           f"architecture: {arch}\n"
    if mapping:
        text += f"mapping:\n  {MAPPINGS[kind]}\n"
    else:
        text += "constraints:\n  budget: 40\n  seed: 3\n"
    return text


def _mapping_summary(r, tree_str):
    return (r.latency, r.energy_pj, r.valid, r.headroom, r.headroom_levels,
            dataclasses.asdict(r.spec), dict(r.cost.lat_breakdown),
            tree_str(r.root))


def _outcome(run, doc, tree_str):
    """The result's summary, or the error an impossible mapping raises
    (e.g. cloud's full spatial fanout over a small M)."""
    try:
        return _summary(run(doc), tree_str)
    except ValueError as e:
        return ("ValueError", str(e))


def _summary(r, tree_str):
    if hasattr(r, "best"):
        front = None if r.front is None else [
            tuple(dataclasses.asdict(x) if dataclasses.is_dataclass(x)
                  else x for x in p) for p in r.front]
        return (_mapping_summary(r.best, tree_str), r.evaluated, r.valid,
                r.mode, r.history, front, r.best_index)
    return _mapping_summary(r, tree_str)


@pytest.mark.parametrize("kind", sorted(WORKLOADS))
@pytest.mark.parametrize("arch", ["edge", "cloud"])
@pytest.mark.parametrize("mapping", [True, False], ids=["mapped", "search"])
def test_run_spec_matches_jax(kind, arch, mapping):
    text = _doc(kind, arch, mapping)
    jdoc, tdoc = jy.load_spec(text), ty.load_spec(text)
    assert jdoc == tdoc
    assert _outcome(ty.run_spec, tdoc, ttree_str) == \
        _outcome(jy.run_spec, jdoc, jtree_str)


def test_objectives_and_file_path(tmp_path):
    for objective in ("energy", "pareto"):
        text = (f"workload: {{kind: gemm_softmax, dims: {WORKLOADS['gemm_softmax']}}}\n"
                f"architecture: edge\nconstraints: {{objective: {objective}, "
                f"variants: [fused_dist, fused_std]}}\n")
        path = tmp_path / f"{objective}.yaml"
        path.write_text(text)
        want = _summary(jy.run_spec(jy.load_spec(str(path))), jtree_str)
        assert _summary(ty.run_spec(ty.load_spec(str(path))), ttree_str) \
            == want
    spec = ty.parse_mapping({"variant": "fused_dist", "m_tiles": 8,
                             "loop_order_gb": ["M", "N"]})
    assert ty.spec_to_dict(spec) == jy.spec_to_dict(
        jy.parse_mapping({"variant": "fused_dist", "m_tiles": 8,
                          "loop_order_gb": ["M", "N"]}))
    with pytest.raises(ValueError, match="unknown workload"):
        ty.parse_workload({"kind": "conv", "dims": {}})


_NO_YAML = """
import sys
sys.modules["yaml"] = None          # import yaml raises ImportError
sys.path.insert(0, {src!r})
import repro_torch.core
from repro_torch.core import yamlio
r = yamlio.run_spec({{"workload": {{"kind": "gemm_softmax",
                                  "dims": {{"M": 64, "N": 256, "K": 32}}}},
                     "architecture": "edge",
                     "mapping": {{"variant": "fused_dist", "m_tiles": 4}}}})
try:
    yamlio.load_spec("workload: {{}}")
except ImportError:
    print("OK", r.valid)
"""


def test_core_imports_without_yaml():
    res = subprocess.run([sys.executable, "-c",
                          _NO_YAML.format(src=str(ROOT / "src"))],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[0] == "OK"
