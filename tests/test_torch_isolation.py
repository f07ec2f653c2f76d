"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke`` loads neither JAX, nor the JAX package, nor ``ml_dtypes``
(which the card's machine does not have), and no source line of the port
imports them."""
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, json, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
base = set(sys.modules)     # torch itself loads a few torch.testing modules
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
import torch.distributed as dist
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "ml_dtypes")
             or m.startswith(("jax.", "repro.", "ml_dtypes.")))
testing = sorted(m for m in set(sys.modules) - base
                 if m.startswith("torch.testing._internal"))
print(json.dumps({{"modules": names, "bad": bad, "testing": testing,
                  "world": dist.is_available() and dist.is_initialized()}}))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    # the static contracts and the dry run make their fake world only when
    # an arm or a cell runs: importing them makes none and loads no
    # torch.testing module beyond those ``import torch`` loads
    assert out["testing"] == [] and out["world"] is False
    for name in ("repro_torch.launch.serve", "repro_torch.launch.train",
                 "repro_torch.train", "repro_torch.parallel",
                 "repro_torch.train.checkpoint",
                 "repro_torch.parallel.compression",
                 "repro_torch.models.moe", "repro_torch.models.encdec",
                 "repro_torch.core.yamlio",
                 "repro_torch.parallel.sharding",
                 "repro_torch.parallel.collective_planner",
                 "repro_torch.launch.mesh", "repro_torch.launch.paper_tables",
                 "repro_torch.launch.moe_dispatch",
                 "repro_torch.examples.quickstart",
                 "repro_torch.examples.comet_attention",
                 "repro_torch.examples.serve_lm",
                 "repro_torch.examples.train_lm",
                 "repro_torch.calibrate", "repro_torch.calibrate.harness",
                 "repro_torch.calibrate.fitter",
                 "repro_torch.calibrate.persist",
                 "repro_torch.calibrate.driver",
                 "repro_torch.calibrate.__main__",
                 "repro_torch.launch.costmodel_compare",
                 "repro_torch.analysis", "repro_torch.analysis.contracts",
                 "repro_torch.analysis.counts", "repro_torch.analysis.lint",
                 "repro_torch.analysis.reconcile",
                 "repro_torch.analysis.roofline",
                 "repro_torch.analysis.__main__",
                 "repro_torch.launch.dryrun", "repro_torch.launch.specs",
                 "repro_torch.launch.roofline"):
        assert name in out["modules"], name
    assert len(out["modules"]) >= 25


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro|ml_dtypes)(\.|\s|$)|"
                     r"import_module\(\s*[\"'](jax|repro|ml_dtypes)[.\"']")
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in PORT_SOURCES
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []
    assert len(PORT_SOURCES) >= 25
