"""Faults planted in the program underneath a run, for the tests that see
``correct`` come out false and for the runs that read a fault's numbers
at a cell's size (``calibrate.py --hook faults:<name>``).  Each patches the
program in the process that calls it, through ``setattr`` (a test passes
``monkeypatch.setattr``, which undoes it)."""
from __future__ import annotations

import builtins


def alter_tokens(setattr=builtins.setattr) -> None:
    """Every decode step's greedy token of slot 0 moved half the vocab
    away from the model's, where the step produces it."""
    from repro_torch.models.model import Model
    decode = Model.decode

    def altered(self, *a, **k):
        logits, cache = decode(self, *a, **k)
        logits = logits.clone()
        V = self.cfg.vocab_size
        other = (logits[0, -1, :V].argmax() + V // 2) % V
        logits[0, -1, other] = logits[0, -1].max() + 1
        return logits, cache
    setattr(Model, "decode", altered)


def state_unchanged(setattr=builtins.setattr) -> None:
    """The step returns its state as it found it: AdamW applies nothing."""
    from repro_torch.train import train_step as ts
    from repro_torch.train.optimizer import OptState

    def frozen(cfg, params, grads, state, **k):
        return params, OptState(state.step + 1, state.m, state.v,
                                state.err), {"grad_norm": 0.0, "lr": 0.0}
    setattr(ts, "adamw_update", frozen)


def half_batch(setattr=builtins.setattr) -> None:
    """The loss taken over the first half of the batch's rows alone."""
    from repro_torch.train import train_step as ts
    make = ts.make_loss_fn

    def halved(model, mesh=None, use_planner_loss=False):
        fn = make(model, mesh, use_planner_loss)

        def loss_fn(params, batch):
            n = batch["tokens"].shape[0] // 2
            return fn(params, {k: v[:n] for k, v in batch.items()})
        return loss_fn
    setattr(ts, "make_loss_fn", halved)


def no_exchange(setattr=builtins.setattr) -> None:
    """The exchange of gradients between the chips left out: a collective
    of a ``grads/`` label over more than one rank keeps this rank's own
    share, unsummed."""
    import torch.distributed as dist
    from repro_torch.parallel import collective_planner as cp
    from repro_torch.train import optimizer, train_step
    real = cp.collective

    def local(col_type, label, x, group, **kw):
        P = dist.get_world_size(group)
        if not label.startswith("grads/") or P == 1:
            return real(col_type, label, x, group, **kw)
        if col_type == "ReduceScatter":
            return x.chunk(P, kw.get("dim", -1))[dist.get_rank(group)] \
                .contiguous()
        return x.clone()
    for mod in (cp, train_step, optimizer):
        setattr(mod, "collective", local)


def loads_flax(setattr=builtins.setattr) -> None:
    """A module of JAX's family loaded in the process: a stand-in module
    registered as ``flax``, as an import of it would leave it."""
    import sys
    import types
    sys.modules.setdefault("flax", types.ModuleType("flax"))
