"""The kernels' entries as ``torch.library`` custom ops.

Each entry of a hand-written kernel is one op, ``repro_torch::<name>``,
with three faces:

- real tensors run ``run``: the plain version on the CPU, the kernel's
  launch on the card (a CUDA tensor launches or raises);
- fake tensors (``torch._subclasses.FakeTensorMode``, as the dry run makes
  them) run ``fake``, a shape function that builds and launches nothing;
- ``torch.utils.flop_counter.FlopCounterMode`` counts ``flops``, the
  products the launch issues on its tiling (the same on every face).

The ops are registered when their kernel's module is imported, once a
process.  The dispatcher costs a launch tens of microseconds of host
time, so where nothing could see the op (no ``TorchDispatchMode`` is
active, no input is fake) the entry calls ``run`` itself: the same
function the op's real face runs, so a CUDA tensor launches (or raises)
and a CPU tensor takes the plain version either way.  Any other tensor
subclass goes through the dispatcher, where its own handler runs.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import is_in_torch_dispatch_mode
from torch.utils.flop_counter import flop_registry, register_flop_formula

__all__ = ["register_kernel_op", "aligned16", "is_fake"]


def register_kernel_op(name: str, run: Callable, fake: Callable,
                       flops: Callable):
    """``repro_torch::name`` from ``run`` (annotated: its annotations are
    the op's schema), its shape function ``fake`` and its FLOP formula
    ``flops`` (called with the op's raw arguments and ``out_val``).
    Returns the entry: the op, or ``run`` itself where no dispatch mode
    is active and no input is fake (the module docstring)."""
    op = torch.library.custom_op(f"repro_torch::{name}", run,
                                 mutates_args=())
    op.register_fake(fake)
    packet = getattr(torch.ops.repro_torch, name)
    if packet not in flop_registry:
        register_flop_formula(packet, get_raw=True)(flops)

    def entry(*args):
        # a plain tensor's exact type is torch.Tensor; a fake one's (or
        # any subclass's, which the dispatcher must see) is not
        if is_in_torch_dispatch_mode() or any(
                type(a) is not torch.Tensor and isinstance(a, torch.Tensor)
                for a in args):
            return op(*args)
        return run(*args)
    entry.op = op
    return entry


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s first element is 16-byte aligned: its address on a
    real tensor; its offset into its storage on a fake one, which has no
    address (the allocator's blocks are aligned far beyond 16 bytes)."""
    if type(t) is not torch.Tensor and is_fake(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0
