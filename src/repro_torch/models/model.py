"""Model facade: one object tying config -> specs -> init params ->
logits/loss/prefill/decode callables, uniform across all families (the
enc-dec family's batches carry ``src_embeds`` beside ``tokens``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from .. import resolve_device
from . import encdec, transformer
from .config import ModelConfig
from .layers import cross_entropy_loss
from .param import count_params, init_tree

__all__ = ["Model"]


@dataclass
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------- params
    @property
    def specs(self):
        if self.cfg.is_encdec:
            return encdec.encdec_specs(self.cfg)
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
    def logits(self, params, batch: Dict[str, torch.Tensor],
               mesh=None) -> torch.Tensor:
        """Full-sequence logits.  On a ``(data, model)`` mesh ``batch`` is
        this rank's rows and ``params`` its shards (``transformer.forward``,
        ``encdec.encdec_forward``)."""
        if self.cfg.is_encdec:
            return encdec.encdec_forward(self.cfg, params,
                                         batch["src_embeds"], batch["tokens"],
                                         mesh)
        return transformer.forward(self.cfg, params, batch["tokens"], mesh)

    def loss(self, params, batch: Dict[str, torch.Tensor],
             mesh=None) -> torch.Tensor:
        """Mean token NLL of ``batch["labels"]`` under the logits of
        ``batch["tokens"]`` (f32 scalar); on a mesh, of this rank's rows."""
        logits = self.logits(params, batch, mesh)
        return cross_entropy_loss(logits, batch["labels"],
                                  self.cfg.vocab_size)

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, cache_len: int,
                   device: Optional[Union[str, torch.device]] = None,
                   mesh=None):
        """The empty cache; on a ``(data, model)`` mesh this rank's shards
        of it (``cache_shardings``), each made at its own size."""
        init = (encdec.encdec_init_cache if self.cfg.is_encdec
                else transformer.init_cache)
        return init(self.cfg, batch, cache_len, resolve_device(device), mesh)

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                cache_len: int, mesh=None):
        """(last position's logits, cache of ``cache_len`` slots).  On a
        mesh ``batch`` is this rank's rows and ``params`` its shards; the
        logits are its block of the vocab, the cache its shards."""
        if self.cfg.is_encdec:
            return encdec.encdec_prefill(self.cfg, params,
                                         batch["src_embeds"], batch["tokens"],
                                         cache_len, mesh)
        return transformer.prefill(self.cfg, params, batch["tokens"],
                                   cache_len, mesh)

    def decode(self, params, cache, tokens: torch.Tensor, mesh=None,
               cache_len: Optional[int] = None):
        """One decode step; updates ``cache``'s tensors in place.  On a
        mesh as :meth:`prefill`; ``cache_len`` (the cache's slots) is read
        by MLA's layers, whose shard does not show it."""
        if self.cfg.is_encdec:
            return encdec.encdec_decode(self.cfg, params, cache, tokens, mesh)
        return transformer.decode(self.cfg, params, cache, tokens, mesh,
                                  cache_len)
