"""Parameters from the JAX package into the port.

The JAX package's parameter tree, given as numpy arrays (``np.asarray`` of
each leaf), becomes the port's tree: the same nesting, the same names and
the same stacked ``(L, ...)`` leaves.  Values are carried bit for bit.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from .. import resolve_device
from .param import tree_map

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A numpy array -> a CPU tensor with the same bits.  ``np.asarray`` of
    a JAX bf16 array has the ``ml_dtypes`` dtype ``bfloat16``, which
    ``torch.from_numpy`` refuses: it goes through its 16-bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:     # JAX hands out read-only buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device: Optional[Union[str, torch.device]] = None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (``cuda`` unless ``"cpu"`` is passed)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(np.asarray(a)).to(dev), tree)
