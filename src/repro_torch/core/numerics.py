"""Scalar/array-polymorphic arithmetic helpers.

The cost model (Eqs. 1-7), the tree builders and the validator are written
once and evaluated through two paths:

* the classic per-spec path, where every tiling parameter is a Python int
  and results are Python floats;
* the batched path (core/batcheval.py), where the numeric tiling
  parameters are NumPy int arrays spanning a whole grid of mapping
  instances and every intermediate quantity becomes a structure-of-arrays.

These helpers dispatch between the two so both paths execute the *same*
formulas: ``ceil_div`` uses exact integer ceil-division (identical for
ints and int arrays), and ``vmax``/``vmin`` fall back to builtin
``max``/``min`` for scalars so the per-spec path keeps producing plain
Python numbers.

Port-local copy of ``repro/core/numerics.py`` (``collectives`` needs
``is_array``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["ceil_div", "vmax", "vmin", "vwhere", "is_array", "reduce_max"]


def is_array(x) -> bool:
    return isinstance(x, np.ndarray)


def ceil_div(a, b):
    """Exact ceil(a / b) for non-negative ints or int arrays."""
    return -(-a // b)


def vmax(a, b):
    """Elementwise max that preserves Python scalars on the scalar path."""
    if is_array(a) or is_array(b):
        return np.maximum(a, b)
    return a if a >= b else b  # scalar-ok: the scalar fallback itself


def vmin(a, b):
    """Elementwise min that preserves Python scalars on the scalar path."""
    if is_array(a) or is_array(b):
        return np.minimum(a, b)
    return a if a <= b else b  # scalar-ok: the scalar fallback itself


def vwhere(mask, a, b):
    """Elementwise mask-select that preserves Python scalars on the scalar
    path (used by the Eq. 5-7 schedule select in the batched engine)."""
    if is_array(mask) or is_array(a) or is_array(b):
        return np.where(mask, a, b)
    return a if mask else b


def reduce_max(values):
    """max() over a non-empty sequence of scalars and/or arrays."""
    it = iter(values)
    out = next(it)
    for v in it:
        out = vmax(out, v)
    return out
