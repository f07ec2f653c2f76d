"""Repo-invariant AST lint of the port (no dependency beyond ``ast``).

Port of ``repro/analysis/lint.py``, run over ``src/repro_torch``:

``poly-no-math``, ``poly-array-branch``, ``core-no-sqlite``
    The JAX package's rules, copied unchanged with its ``POLY_FILES``,
    allowlists and pragma: the port's ``core/`` holds the same files.

``kernel-no-host``
    Aimed at the port's launch path.  In each kernel entry's launch path
    in ``kernels/*.py`` (but ``autotune.py``, ``_build.py`` and
    ``ref.py``): the op's ``run`` function (``register_kernel_op``), the
    entries that call the op, and every function of the module they call,
    none of ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize``, host NumPy (``np.*``) or float64 may
    appear: each is a device-to-host round trip or a silent cliff in a
    launch.  In ``kernels/csrc/*.cu``, no ``double`` inside a
    ``__global__`` function's body (:func:`lint_cuda_source`).

``smem-budget``
    Replaces ``vmem-budget``.  For every instance each kernel's tiling can
    launch (the paper shapes, ``BOUNDARY_CASES`` and ``boundary_shapes``),
    the dynamic shared memory it asks for, from the source's layout in
    Python (``layout_smem_bytes``, ``ssd.bf16_layout``,
    ``ssd.f32_smem_bytes``), must be at most the H100's per-block opt-in,
    232448 B.  An instance that cannot be evaluated is itself a finding.
    The built libraries' own figures (``fa_smem_bytes``,
    ``ge_smem_bytes``) are read on the card, where chip_smoke holds the
    launches to them and to the card's opt-in limit.

Adding a rule: write a ``check_<name>(ctx) -> Iterable[LintFinding]``
function and register it in ``RULES``.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

__all__ = ["LintFinding", "lint_repo", "lint_source", "lint_cuda_source",
           "RULES", "smem_findings", "smem_cases", "SMEM_OPTIN"]

_PKG_ROOT = Path(__file__).resolve().parents[1]   # src/repro_torch

PRAGMA = "scalar-ok"

# Files on the scalar/array-polymorphic Eq. 1-7 path.
POLY_FILES = (
    "core/cost.py",
    "core/collectives.py",
    "core/validate.py",
    "core/numerics.py",
    "core/batcheval.py",
    "core/mapping.py",
)

# Scalar-only helpers inside poly files where math.* is legitimate.
MATH_ALLOWED_FUNCS: Dict[str, Set[str]] = {
    "core/collectives.py": {"_step_distances", "_scalar_factors",
                            "_factor_table", "_mesh_avg_distance",
                            "overlapped_collective_seconds"},
}

# Functions that are documented scalar-only paths (validated entry points,
# table builders): array-truthiness rules do not apply inside them.
SCALAR_ONLY_FUNCS: Dict[str, Set[str]] = {
    "core/collectives.py": {"_step_distances", "_scalar_factors",
                            "_factor_table", "_mesh_avg_distance",
                            "overlapped_collective_seconds"},
    "core/validate.py": {"validate_headroom_levels", "validate_tree"},
}

KERNEL_DIR = "kernels"
# host-side planner, the build and the plain versions: no launch path
KERNEL_EXEMPT = {"kernels/autotune.py", "kernels/_build.py", "kernels/ref.py"}

CORE_SQLITE_OWNER = "core/planstore.py"

# the H100's shared memory a block may opt in to
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KB)
SMEM_OPTIN = 232448


@dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str        # package-relative, e.g. "core/cost.py"
    line: int
    col: int
    message: str

    def describe(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: [{self.rule}] "
                f"{self.message}")

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


@dataclass
class _Ctx:
    path: str                  # package-relative posix path
    tree: ast.AST
    lines: List[str]

    def pragma(self, node: ast.AST) -> bool:
        ln = getattr(node, "lineno", 0)
        if 1 <= ln <= len(self.lines):
            return PRAGMA in self.lines[ln - 1]
        return False


def _enclosing_funcs(tree: ast.AST) -> Dict[ast.AST, str]:
    """Map every node to the name of its innermost enclosing function."""
    owner: Dict[ast.AST, str] = {}

    def walk(node: ast.AST, fn: str) -> None:
        for child in ast.iter_child_nodes(node):
            name = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            owner[child] = name
            walk(child, name)

    owner[tree] = ""
    walk(tree, "")
    return owner


# --------------------------------------------------------- rule: poly math


def check_poly_math(ctx: _Ctx) -> Iterable[LintFinding]:
    if ctx.path not in POLY_FILES:
        return []
    allowed = MATH_ALLOWED_FUNCS.get(ctx.path, set())
    owner = _enclosing_funcs(ctx.tree)
    out = []
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "math"):
            if owner.get(node, "") in allowed or ctx.pragma(node):
                continue
            out.append(LintFinding(
                "poly-no-math", ctx.path, node.lineno, node.col_offset,
                f"math.{node.attr} in the scalar/array-polymorphic path "
                f"(use numerics.* / numpy ufuncs, or allowlist the "
                f"scalar-only helper)"))
    return out


# ------------------------------------------------- rule: poly array branch


_SCALAR_ATTRS = {"size", "ndim", "shape"}
_SCALAR_CALLS = {"len", "int", "float", "bool", "isinstance", "is_array",
                 "hasattr", "getattr", "callable"}


def _is_scalar_expr(node: ast.expr) -> bool:
    """Conservatively true when an expression is guaranteed non-array.

    Numeric constants are deliberately NOT scalar evidence: ``dv <= 0``
    with an array ``dv`` is the canonical array-truthiness bug, so a
    numeric literal on one side says nothing about the other side.
    """
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (str, bytes, bool)) or node.value is None
    if isinstance(node, ast.UnaryOp):
        return _is_scalar_expr(node.operand)
    if isinstance(node, ast.Attribute):
        return node.attr in _SCALAR_ATTRS
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _SCALAR_CALLS:
            return True
        if isinstance(fn, ast.Attribute) and fn.attr in ("all", "any"):
            return True   # np.all(...) / arr.all() reduce to a scalar bool
    if isinstance(node, ast.BinOp):
        return _is_scalar_expr(node.left) and _is_scalar_expr(node.right)
    return False


def _compare_is_scalar(node: ast.Compare) -> bool:
    if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
           for op in node.ops):
        return True
    operands = [node.left, *node.comparators]
    if any(isinstance(o, ast.Constant) and isinstance(o.value, (str, bytes))
           for o in operands):
        return True   # string equality (schedule names etc.)
    if any(isinstance(o, ast.Tuple) and not o.elts for o in operands):
        return True   # sentinel compare against the empty tuple
    return any(_is_scalar_expr(o) for o in operands)


def _condition_findings(ctx: _Ctx, cond: ast.expr, owner: Dict[ast.AST, str],
                        scalar_funcs: Set[str]) -> Iterable[LintFinding]:
    stack = [cond]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.BoolOp):
            stack.extend(node.values)
            continue
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            stack.append(node.operand)
            continue
        if isinstance(node, ast.Compare):
            if _compare_is_scalar(node):
                continue
            if owner.get(node, "") in scalar_funcs or ctx.pragma(node):
                continue
            yield LintFinding(
                "poly-array-branch", ctx.path, node.lineno, node.col_offset,
                "comparison used as a branch condition in the "
                "array-polymorphic path — ambiguous for arrays (use "
                "numerics.vwhere / np.where, or mark the audited scalar "
                "site with '# scalar-ok')")


def check_poly_branches(ctx: _Ctx) -> Iterable[LintFinding]:
    if ctx.path not in POLY_FILES:
        return []
    scalar_funcs = SCALAR_ONLY_FUNCS.get(ctx.path, set())
    owner = _enclosing_funcs(ctx.tree)
    out: List[LintFinding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.If, ast.While)):
            out.extend(_condition_findings(ctx, node.test, owner,
                                           scalar_funcs))
        elif isinstance(node, ast.IfExp):
            out.extend(_condition_findings(ctx, node.test, owner,
                                           scalar_funcs))
        elif isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Name) and fn.id in ("max", "min")
                    and len(node.args) >= 2
                    and not any(isinstance(a, ast.Starred)
                                for a in node.args)):
                if owner.get(node, "") in scalar_funcs or ctx.pragma(node):
                    continue
                out.append(LintFinding(
                    "poly-array-branch", ctx.path, node.lineno,
                    node.col_offset,
                    f"builtin {fn.id}() over multiple args in the "
                    f"array-polymorphic path (use numerics.vmax/vmin, or "
                    f"'# scalar-ok')"))
    return out


# ------------------------------------------------- rule: the launch path


_HOST_ATTRS = {"item", "tolist", "cpu", "numpy"}
_F64 = {"float64", "double", "f64"}


def _called_names(fn: ast.AST) -> Set[str]:
    """Names of the module-level functions ``fn`` calls by name."""
    return {n.func.id for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


def _launch_roots(tree: ast.AST) -> Set[str]:
    """The op's ``run`` functions (``register_kernel_op(name, run, ...)``)
    and the functions that call a kernel op (``_op(...)``, a module's
    ``.run(...)``)."""
    roots: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "register_kernel_op" \
                and len(node.args) > 1 and isinstance(node.args[1], ast.Name):
            roots.add(node.args[1].id)
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and (
                    (isinstance(sub.func, ast.Name) and sub.func.id == "_op")
                    or (isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "run"
                        and isinstance(sub.func.value, ast.Name))):
                roots.add(node.name)
    return roots


def _launch_path(tree: ast.AST) -> Dict[str, ast.AST]:
    """The module's functions on a kernel entry's launch path: the roots
    and every module function they call, transitively."""
    funcs = {n.name: n for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        for n in cls.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                funcs.setdefault(n.name, n)
    todo = [r for r in _launch_roots(tree) if r in funcs]
    path: Dict[str, ast.AST] = {}
    while todo:
        name = todo.pop()
        if name in path:
            continue
        path[name] = funcs[name]
        todo.extend(c for c in _called_names(funcs[name]) if c in funcs)
    return path


def check_kernel_host(ctx: _Ctx) -> Iterable[LintFinding]:
    if not ctx.path.startswith(KERNEL_DIR + "/") or ctx.path in KERNEL_EXEMPT:
        return []
    out: List[LintFinding] = []
    for name, node in sorted(_launch_path(ctx.tree).items()):
        for sub in ast.walk(node):
            msg = None
            if isinstance(sub, ast.Attribute):
                if sub.attr in _F64:
                    msg = (f"float64 reference in '{name}' on a kernel's "
                           f"launch path (the kernels are f32/bf16)")
                elif isinstance(sub.value, ast.Name) and \
                        sub.value.id in ("np", "numpy"):
                    msg = (f"host numpy ({sub.value.id}.{sub.attr}) in "
                           f"'{name}' on a kernel's launch path")
                elif sub.attr in _HOST_ATTRS:
                    msg = (f".{sub.attr}() host round trip in '{name}' on a "
                           f"kernel's launch path")
                elif sub.attr == "synchronize" and "cuda" in ast.unparse(
                        sub.value):
                    msg = (f"torch.cuda.synchronize in '{name}' on a "
                           f"kernel's launch path")
            elif isinstance(sub, ast.Constant) and sub.value in ("float64",
                                                                 "double"):
                msg = f"'{sub.value}' dtype string in '{name}'"
            if msg:
                out.append(LintFinding("kernel-no-host", ctx.path,
                                       sub.lineno, sub.col_offset, msg))
    return out


_GLOBAL_RE = re.compile(r"__global__")
_DOUBLE_RE = re.compile(r"\bdouble\b")


def _strip_comments(text: str) -> str:
    """The text with // and /* */ comments blanked, line breaks kept."""
    text = re.sub(r"/\*.*?\*/", lambda m: re.sub(r"[^\n]", " ", m.group()),
                  text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def lint_cuda_source(text: str, path: str) -> List[LintFinding]:
    """``kernel-no-host`` over one CUDA source: no ``double`` inside the
    body of a ``__global__`` function (the f32 and bf16 kernels issue no
    f64 arithmetic, which runs at 1/2 the f32 rate or worse)."""
    code = _strip_comments(text)
    out: List[LintFinding] = []
    for m in _GLOBAL_RE.finditer(code):
        start = code.find("{", m.end())
        if start < 0:
            continue
        depth, i = 0, start
        while i < len(code):
            if code[i] == "{":
                depth += 1
            elif code[i] == "}":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        for d in _DOUBLE_RE.finditer(code, start, i):
            line = code.count("\n", 0, d.start()) + 1
            out.append(LintFinding(
                "kernel-no-host", path, line, 0,
                "'double' inside a __global__ function's body"))
    return out


# ------------------------------------------------------ rule: core sqlite


def check_core_sqlite(ctx: _Ctx) -> Iterable[LintFinding]:
    if not ctx.path.startswith("core/") or ctx.path == CORE_SQLITE_OWNER:
        return []
    out = []
    for node in ast.walk(ctx.tree):
        bad = None
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "sqlite3" for a in node.names):
                bad = "import sqlite3"
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "sqlite3":
                bad = "from sqlite3 import"
        if bad:
            out.append(LintFinding(
                "core-no-sqlite", ctx.path, node.lineno, node.col_offset,
                f"{bad} outside planstore.py — all SQLite access goes "
                f"through core/planstore.py's retry/degradation wrapper"))
    return out


# ------------------------------------------------------- rule: smem budget


def smem_cases() -> Dict[str, Tuple[str, Callable, List[tuple]]]:
    """Per kernel: (its file, the function of (dtype, ...) giving an
    instance's dynamic shared memory, the instances its tiling launches
    over the paper shapes, ``BOUNDARY_CASES`` and ``boundary_shapes``; the
    fused GEMMs' at every tiling of ``gemm_epilogue.tilings``)."""
    import importlib

    import torch

    from ..kernels.autotune import PAPER_KERNEL_SHAPES
    ag, fa, ge, ssd = (importlib.import_module(f"repro_torch.kernels.{m}")
                       for m in ("allgather_gemm", "flash_attention",
                                 "gemm_epilogue", "ssd"))
    dtypes = (torch.bfloat16, torch.float32)
    fa_inst = {(dt, d) for dt in dtypes
               for d in ({c[6] for c in fa.BOUNDARY_CASES}
                         | {s[2] for s in
                            PAPER_KERNEL_SHAPES["attention_blocks"]})}
    ge_inst = set()
    for dt in dtypes:
        ns = [n for _, _, n in ge.boundary_shapes(dt)] + list(
            ge.TILING_BOUNDARIES) + [n for _, n, _ in
                                     PAPER_KERNEL_SHAPES[
                                         "gemm_epilogue_blocks"]]
        for n in ns:                     # every tiling the plan may launch
            ge_inst.update((dt, t.rows, t.passes)
                           for t in ge.tilings(n, dt))

    def ssd_smem(dt, N, P):
        return ssd.bf16_layout(N, P)[1] if dt == torch.bfloat16 \
            else ssd.f32_smem_bytes(N, P)
    ssd_inst = {(dt, c[5], c[4]) for dt in dtypes
                for c in ssd.BOUNDARY_CASES} | {
        (dt, n, p) for dt in dtypes
        for _, p, n in PAPER_KERNEL_SHAPES["ssd_chunk_len"]}
    return {
        "flash_attention": ("kernels/flash_attention.py",
                            fa.layout_smem_bytes, sorted(fa_inst, key=str)),
        "gemm_epilogue": ("kernels/gemm_epilogue.py", ge.layout_smem_bytes,
                          sorted(ge_inst, key=str)),
        "ssd_scan": ("kernels/ssd.py", ssd_smem, sorted(ssd_inst, key=str)),
        "streamed_gemm": ("kernels/allgather_gemm.py", ag.layout_smem_bytes,
                          [(dt,) for dt in dtypes]),
    }


def smem_findings(cases=None, limit: int = SMEM_OPTIN) -> List[LintFinding]:
    """Every instance of every kernel asks for at most ``limit`` bytes of
    dynamic shared memory; an instance whose figure cannot be evaluated
    is a finding too."""
    cases = smem_cases() if cases is None else cases
    out: List[LintFinding] = []
    for kernel, (rel, fn, instances) in cases.items():
        worst = (0, None)
        for inst in instances:
            try:
                n = int(fn(*inst))
            except Exception as exc:  # noqa: BLE001 - the rule reports it
                out.append(LintFinding(
                    "smem-budget", rel, 1, 0,
                    f"{kernel}: could not evaluate the shared memory of "
                    f"instance {inst} ({exc!r})"))
                continue
            if n > worst[0]:
                worst = (n, inst)
            if n > limit:
                out.append(LintFinding(
                    "smem-budget", rel, 1, 0,
                    f"{kernel}: instance {inst} asks for {n} B of dynamic "
                    f"shared memory, which exceeds the H100's per-block "
                    f"opt-in of {limit} B"))
    return out


# ------------------------------------------------------------ entry points


RULES = {
    "poly-no-math": check_poly_math,
    "poly-array-branch": check_poly_branches,
    "kernel-no-host": check_kernel_host,
    "core-no-sqlite": check_core_sqlite,
}


def lint_source(source: str, path: str) -> List[LintFinding]:
    """Lint one in-memory module under a package-relative ``path`` (the
    path selects which rules apply): the unit-test entry point."""
    ctx = _Ctx(path=path, tree=ast.parse(source),
               lines=source.splitlines())
    out: List[LintFinding] = []
    for check in RULES.values():
        out.extend(check(ctx))
    return out


def lint_repo(root: Optional[Path] = None,
              with_smem: bool = True) -> List[LintFinding]:
    """Every rule over the package tree (``src/repro_torch``), its CUDA
    sources and the kernels' shared memory."""
    root = root or _PKG_ROOT
    out: List[LintFinding] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        try:
            out.extend(lint_source(path.read_text(), rel))
        except SyntaxError as exc:
            out.append(LintFinding("parse-error", rel,
                                   exc.lineno or 1, 0, str(exc)))
    for path in sorted((root / KERNEL_DIR / "csrc").glob("*.cu")):
        out.extend(lint_cuda_source(path.read_text(),
                                    path.relative_to(root).as_posix()))
    if with_smem:
        out.extend(smem_findings())
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))
