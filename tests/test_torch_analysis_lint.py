"""The port's lint (``repro_torch.analysis.lint``) against the JAX
package's (``repro.analysis.lint``): the rules they share give the same
findings on the JAX tests' snippets at the same paths; the port's
``kernel-no-host`` is aimed at the kernels' launch path and CUDA sources,
and ``smem-budget`` holds every kernel instance inside the H100's shared
memory; the port's tree is clean."""
import pytest
import torch

from repro.analysis import lint as jlint
from repro_torch.analysis import lint as tlint

# (source, path) of tests/test_static_analysis.py's snippets, for the rules
# both packages share
SHARED = [
    ("import math\ndef f(x):\n    return math.ceil(x)\n", "core/cost.py"),
    ("import math\ndef f(x):\n    return math.ceil(x)\n", "models/layers.py"),
    ("import math\ndef _factor_table(x):\n    return math.ceil(x)\n",
     "core/collectives.py"),
    ("def f(dv):\n    if dv <= 0:\n        return 0\n    return dv\n",
     "core/cost.py"),
    ("def f(dv):\n    if dv <= 0:  # scalar-ok: audited\n"
     "        return 0\n    return dv\n", "core/cost.py"),
    ("def f(mode, xs):\n    if mode == 'tree':\n        return 1\n"
     "    if len(xs) > 2:\n        return 2\n    return 0\n", "core/cost.py"),
    ("def f(a, b):\n    return max(a, b)\n", "core/numerics.py"),
    ("def f(a, b):\n    return max(a, b)  # scalar-ok: ints\n",
     "core/numerics.py"),
    ("import sqlite3\n", "core/foo.py"),
    ("from sqlite3 import connect\n", "core/foo.py"),
    ("import sqlite3\n", "core/planstore.py"),
    ("import sqlite3\n", "serve/api.py"),
]
SHARED_RULES = {"poly-no-math", "poly-array-branch", "core-no-sqlite"}


def _keys(findings):
    return sorted((f.rule, f.path, f.line, f.col, f.message)
                  for f in findings if f.rule in SHARED_RULES)


@pytest.mark.parametrize("source,path", SHARED)
def test_shared_rules_match_the_jax_lint(source, path):
    assert _keys(tlint.lint_source(source, path)) == \
        _keys(jlint.lint_source(source, path))


def test_shared_rule_tables_are_the_jax_packages():
    assert tlint.POLY_FILES == jlint.POLY_FILES
    assert tlint.MATH_ALLOWED_FUNCS == jlint.MATH_ALLOWED_FUNCS
    assert tlint.SCALAR_ONLY_FUNCS == jlint.SCALAR_ONLY_FUNCS
    assert tlint.CORE_SQLITE_OWNER == jlint.CORE_SQLITE_OWNER
    assert tlint.PRAGMA == jlint.PRAGMA


KERNEL = '''import numpy as np
import torch
from ._op import register_kernel_op

def helper(x):
    return x.{bad}

def _run(x: torch.Tensor) -> torch.Tensor:
    return helper(x)

def host_only(x):
    return np.sum(x.item())

_op = register_kernel_op("k", _run, None, None)

def entry(x):
    return _op(x)
'''


@pytest.mark.parametrize("bad", ["item()", "tolist()", "cpu()", "numpy()",
                                 "to(torch.float64)", "double()"])
def test_kernel_no_host_catches_a_planted_host_call(bad):
    findings = tlint.lint_source(KERNEL.format(bad=bad), "kernels/foo.py")
    assert findings and {f.rule for f in findings} == {"kernel-no-host"}
    # the call sits in ``helper``, on _run's path; host_only is not on it
    assert {f.line for f in findings} == {6}


def test_kernel_no_host_follows_the_launch_path_only():
    src = KERNEL.format(bad="clone()") + (
        "\ndef sync_entry(x):\n    torch.cuda.synchronize()\n"
        "    return _op(np.asarray(x))\n")
    findings = tlint.lint_source(src, "kernels/foo.py")
    msgs = "\n".join(f.message for f in findings)
    assert "synchronize" in msgs and "np.asarray" in msgs
    assert all(f.line >= 19 for f in findings)
    for exempt in ("kernels/autotune.py", "kernels/_build.py",
                   "kernels/ref.py"):
        assert tlint.lint_source(src, exempt) == []


def test_kernel_no_host_catches_double_in_a_global_body():
    cu = ("// a double in a comment is fine\n"
          "__device__ double host_side(double x) { return x; }\n"
          "__global__ void k(float* y) {\n"
          "  double acc = 0.0;  /* double */\n"
          "  y[0] = (float)acc;\n"
          "}\n")
    findings = tlint.lint_cuda_source(cu, "kernels/csrc/k.cu")
    assert [(f.rule, f.line) for f in findings] == [("kernel-no-host", 4)]
    assert tlint.lint_cuda_source(cu.replace("double acc", "float acc"),
                                  "kernels/csrc/k.cu") == []


def test_smem_budget_catches_an_oversized_instance():
    cases = {"flash_attention": ("kernels/flash_attention.py",
                                 lambda dt, d: 1024 * d,
                                 [(torch.bfloat16, 64), (torch.bfloat16,
                                                         256)])}
    findings = tlint.smem_findings(cases)
    assert len(findings) == 1 and findings[0].rule == "smem-budget"
    assert "exceeds" in findings[0].message and "256" in \
        findings[0].message


def test_smem_budget_flags_an_instance_it_cannot_evaluate():
    def broken(dt, d):
        raise KeyError("no such instance")
    findings = tlint.smem_findings(
        {"ssd_scan": ("kernels/ssd.py", broken, [(torch.bfloat16, 64)])})
    assert findings and findings[0].rule == "smem-budget"
    assert "could not evaluate" in findings[0].message


def test_smem_cases_cover_every_kernel_at_its_instances():
    cases = tlint.smem_cases()
    assert set(cases) == {"flash_attention", "gemm_epilogue", "ssd_scan",
                          "streamed_gemm"}
    fa = cases["flash_attention"][2]
    assert {d for _, d in fa} == {16, 32, 64, 128}
    ge = cases["gemm_epilogue"][2]
    assert {(r, p) for dt, r, p in ge if dt == torch.bfloat16} == \
        {(128, 1), (64, 1), (64, 2)}
    # every instance a plan may launch at the paper shapes
    from repro_torch.kernels import autotune
    from repro_torch.kernels import gemm_epilogue as gem
    for _, n, _ in autotune.PAPER_KERNEL_SHAPES["gemm_epilogue_blocks"]:
        for dt in (torch.bfloat16, torch.float32):
            assert {(dt, t.rows, t.passes) for t in gem.tilings(n, dt)} \
                <= set(ge)
    worst = max(fn(*i) for _, fn, insts in cases.values() for i in insts)
    assert worst <= tlint.SMEM_OPTIN


def test_lint_repo_is_clean():
    findings = tlint.lint_repo()
    assert findings == [], "\n".join(f.describe() for f in findings)
