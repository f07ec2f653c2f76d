"""COMET port to PyTorch and CUDA on an NVIDIA Hopper card (H100, sm_90a).

The JAX package ``repro`` is the reference; this package imports nothing
of it and nothing of JAX.  Module layout and names follow ``repro`` so that
each function's counterpart is found under the same path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
They never fall back to the CPU on their own: :func:`resolve_device`
raises when CUDA is missing or the card is not Hopper.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["__version__", "resolve_device", "HOPPER_CAPABILITY"]

__version__ = "0.1.0"

HOPPER_CAPABILITY = (9, 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    ``cpu``.  Raises if CUDA is asked for (explicitly or by default) and no
    CUDA device is present, or if the card is not compute capability 9.0."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != HOPPER_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap}; the port's kernels are built for sm_90a (Hopper)")
    return dev
