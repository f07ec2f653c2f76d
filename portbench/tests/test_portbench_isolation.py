"""What the benchmark may load: nothing of JAX or of the JAX package
anywhere, and nothing of the program in the reference."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SMOKE = Path(__file__).resolve().parent / "smoke.py"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for f in ROOT.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_reference_imports_only_torch_and_the_standard_library():
    allowed = {"__future__", "math", "typing", "torch"}
    for f in (ROOT / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert tops <= allowed, (f, tops - allowed)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import reference.model, reference.params, reference.train\n"
            "bad = sorted({n.split('.')[0] for n in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'})\n"
            "print(bad)" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_module_loaded_in_a_rank_stops_the_result():
    """A rank of the mesh cell that loads a module of JAX's family (a
    stand-in ``flax``, planted through the run's hook) stops the run
    before its result line, though the printing process loaded none."""
    out = subprocess.run(
        [sys.executable, str(SMOKE), "--workload",
         "glm4-9b.train-fsdp-4chip", "--hook", "faults:loads_flax"],
        capture_output=True, text=True, timeout=600, cwd=ROOT.parent)
    assert out.returncode == 3, out.stderr[-2000:]
    assert "flax" in out.stderr.strip().splitlines()[-1]
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result line was printed: {line[:200]}")
