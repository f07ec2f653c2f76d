"""The port stands alone: importing every module of ``repro_torch`` and
``chip_smoke`` loads neither JAX nor the JAX package, and no source line
of the port imports them."""
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
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert "repro_torch.launch.serve" in out["modules"]
    assert len(out["modules"]) >= 25


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(from|import)\s+(jax|repro)(\.|\s|$)|"
                     r"import_module\(\s*[\"'](jax|repro)[.\"']")
    hits = [f"{p.relative_to(ROOT)}:{i}: {line.strip()}"
            for p in PORT_SOURCES
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []
    assert len(PORT_SOURCES) >= 25
