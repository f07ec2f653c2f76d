"""Model facade: one object tying config -> specs -> init params ->
logits/prefill/decode callables."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from .. import resolve_device
from . import transformer
from .config import ModelConfig
from .param import count_params, init_tree

__all__ = ["Model"]


@dataclass
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params
    @property
    def specs(self):
        return transformer.decoder_specs(self.cfg)

    def init(self, seed: int = 0,
             device: Optional[Union[str, torch.device]] = None):
        """Random parameters from ``torch.Generator`` seeded with ``seed``
        on ``device`` (``cuda`` unless ``"cpu"`` is passed)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_tree(self.specs, gen)

    def n_params(self) -> int:
        return count_params(self.specs)

    # ------------------------------------------------------------ forward
    def logits(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return transformer.forward(self.cfg, params, batch["tokens"])

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int,
                   device: Optional[Union[str, torch.device]] = None):
        return transformer.init_cache(self.cfg, batch, cache_len,
                                      resolve_device(device))

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_len: int):
        return transformer.prefill(self.cfg, params, batch["tokens"],
                                   cache_len)

    def decode(self, params, cache, tokens: torch.Tensor):
        """One decode step; updates ``cache``'s tensors in place."""
        return transformer.decode(self.cfg, params, cache, tokens)
