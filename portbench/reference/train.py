"""Training steps in float32: the mean token NLL, its gradients layer by
layer, and AdamW.

The loss and its gradients run one layer at a time: a forward that keeps
each layer's input, then the head's backward and each layer's again from
its input (the layer recomputed under autograd), the embedding's gradient
a sum over the rows of the tokens.  AdamW is the decoupled one with
global-norm clipping and a linearly warmed, cosine-decayed rate (the
``optimizer`` settings of the traffic file):

    g <- g min(1, clip / (|g| + 1e-9));  m <- b1 m + (1 - b1) g;
    v <- b2 v + (1 - b2) g^2;  p <- p - lr (m^ / (sqrt(v^) + eps) + wd p)

with every leaf decayed.  The parameters are kept between steps in the
dtype the configuration states (the port's AdamW keeps no float32 master
copy), and every step is computed in float32.

Over several processes (``group``), each holds the whole parameters and
its own rows of the batch; each gradient block (a layer's slice of a
stacked leaf, or a whole leaf) is summed over the processes as soon as it
is made, each keeping a 1/world share of it, of the moments and of the
update, and the updated shares are gathered back.  With one process the
share is the whole.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from .model import F32, Ref, xent
from .params import SKETCH, blocks_of, build, direction, get, leaves


def lr_at(opt: Dict, step: int) -> float:
    """The rate of step ``step`` (0 first): linear warmup over
    ``warmup_steps``, then cosine decay to ``min_lr_frac`` of ``lr`` by
    ``total_steps``."""
    warm = min(1.0, (step + 1.0) / max(1, opt["warmup_steps"]))
    t = min(1.0, max(0.0, (step - opt["warmup_steps"])
                     / max(1, opt["total_steps"] - opt["warmup_steps"])))
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 \
        * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


class Shares:
    """Each process's 1/world share of a flat block (zero-padded to a
    multiple of world), over ``group``; the whole block with none."""

    def __init__(self, group=None):
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(flat, (0, (-flat.numel())
                                              % self.world))

    def own(self, block: torch.Tensor) -> torch.Tensor:
        """This process's share of a block every process holds whole."""
        flat = self._pad(block.reshape(-1))
        return flat.view(self.world, -1)[self.rank]

    def summed(self, block: torch.Tensor) -> torch.Tensor:
        """This process's share of the block summed over the processes."""
        if self.group is None:
            return block.reshape(-1).clone()
        parts = list(self._pad(block.reshape(-1)).view(self.world, -1))
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, [p.contiguous() for p in parts],
                            group=self.group)
        return out

    def gathered(self, share: torch.Tensor, like: torch.Tensor
                 ) -> torch.Tensor:
        """The whole block, shaped like ``like``, from every share."""
        if self.group is None:
            return share.view(like.shape)
        parts = [torch.empty_like(share) for _ in range(self.world)]
        dist.all_gather(parts, share.contiguous(), group=self.group)
        return torch.cat(parts)[:like.numel()].view(like.shape)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the processes."""
        if self.group is not None:
            x = x.clone()
            dist.all_reduce(x, group=self.group)
        return x


def _blocks(path, t: torch.Tensor) -> List[torch.Tensor]:
    """A leaf's blocks: its layers' slices where stacked, else itself."""
    return list(t) if path[0] == "layers" else [t]


def loss_and_grads(ref: Ref, tokens: torch.Tensor, labels: torch.Tensor,
                   shares: Shares, rows_total: int, block: int = 1024):
    """(mean loss over the ``rows_total`` rows of all processes, each
    leaf's gradient summed over them as this process's shares of its
    blocks, (blocks, share) float32)."""
    z = ref.z
    B, S = tokens.shape
    n_tok = rows_total * S
    xs = [ref.embed(tokens)]
    with torch.no_grad():
        for l in range(z["L"]):
            xs.append(ref.layer(ref.layer_weights(l), xs[-1]))
    Wh = ref.head_weights(grad=True)
    xl = xs[-1].detach().requires_grad_(True)
    loss = torch.zeros((), dtype=F32, device=tokens.device)
    flat_x, flat_y = xl.reshape(B * S, -1), labels.reshape(B * S)
    for r0 in range(0, B * S, block):
        part = xent(ref.logits(Wh, flat_x[r0:r0 + block]),
                    flat_y[r0:r0 + block], z["V"]) / n_tok
        part.backward()
        loss += part.detach()
    grads: Dict = {("final_norm", "scale"):
                   shares.summed(Wh["final_norm"].grad)[None],
                   ("unembed",): shares.summed(Wh["unembed"].grad)[None]}
    del Wh
    gx = xl.grad
    for l in reversed(range(z["L"])):
        W = ref.layer_weights(l, grad=True)
        xin = xs[l].detach().requires_grad_(True)
        ref.layer(W, xin).backward(gx)
        gx = xin.grad
        for path, t in leaves(W):
            share = shares.summed(t.grad)
            key = ("layers",) + path
            if key not in grads:
                grads[key] = torch.zeros((z["L"], share.numel()), dtype=F32,
                                         device=share.device)
            grads[key][l] = share
        del W, xin
        xs[l + 1] = None
    emb = torch.zeros(ref.w["embedding"].shape, dtype=F32,
                      device=tokens.device)
    emb.index_add_(0, tokens.reshape(-1), gx.reshape(B * S, -1))
    grads[("embedding",)] = shares.summed(emb)[None]
    return shares.total(loss), grads


def run_steps(cfg: Dict, make: Callable[[], Dict], batches: List,
              opt: Dict, *, lowp: Optional[str] = None, group=None,
              rows_total: Optional[int] = None, sketch_seed: int = 0,
              directions: int = SKETCH) -> Dict:
    """AdamW steps of the reference from the weights ``make()`` gives (a
    fresh copy each call) over ``batches`` [(tokens, labels), ...] (over
    ``group``: this process's rows of ``rows_total``).  Returns the loss
    of each step, the norm of each leaf's first gradient as the optimizer
    takes it (clipped), its projections on ``directions`` random
    directions, and the norm of each leaf's change over the steps, by
    dotted leaf name."""
    shares = Shares(group)
    rows_total = rows_total or batches[0][0].shape[0]
    params = dict(leaves(make()))
    names = [".".join(p) for p in params]
    m: Dict = {}
    v: Dict = {}
    out: Dict = {"loss": [], "grad_norm": {}, "grad_sketch": {},
                 "change_norm": {}}
    for step, (tokens, labels) in enumerate(batches):
        ref = Ref(cfg, build(params, params.get), lowp=lowp)
        loss, grads = loss_and_grads(ref, tokens, labels, shares,
                                     rows_total)
        out["loss"].append(float(loss))
        sq = shares.total(torch.stack([torch.sum(grads[p] * grads[p])
                                       for p in params]))
        scale = min(1.0, opt["clip_norm"]
                    / (math.sqrt(float(sq.sum())) + 1e-9))
        if step == 0:
            out["grad_norm"] = {n: scale * math.sqrt(float(s))
                                for n, s in zip(names, sq)}
            out["grad_sketch"] = _sketch(params, grads, shares, scale,
                                         sketch_seed, directions)
            m = {p: torch.zeros_like(g) for p, g in grads.items()}
            v = {p: torch.zeros_like(g) for p, g in grads.items()}
        _adamw(params, grads, m, v, scale, lr_at(opt, step), step, opt,
               shares)
        del grads, ref
    del m, v
    weights = make()
    sq = []
    for p, t in params.items():
        d = [shares.own(a.to(F32) - b.to(F32))
             for a, b in zip(_blocks(p, t), _blocks(p, get(weights, p)))]
        sq.append(sum(torch.sum(x * x) for x in d))
    sq = shares.total(torch.stack(sq))
    out["change_norm"] = {n: math.sqrt(float(s)) for n, s in zip(names, sq)}
    return out


@torch.no_grad()
def _adamw(params, grads, m, v, scale, lr, step, opt, shares) -> None:
    """One AdamW update of every leaf, share by share, the shares
    gathered back into the whole parameters (kept in their dtype)."""
    b1, b2 = opt["betas"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    for p, g in grads.items():
        g = g * scale
        m[p].mul_(b1).add_(g, alpha=1 - b1)
        v[p].mul_(b2).addcmul_(g, g, value=1 - b2)
        t = params[p]
        new = []
        for i, blk in enumerate(_blocks(p, t)):
            pf = shares.own(blk).to(F32)
            delta = (m[p][i] / bc1) / (torch.sqrt(v[p][i] / bc2)
                                       + opt["eps"]) \
                + opt["weight_decay"] * pf
            new.append(shares.gathered((pf - lr * delta).to(t.dtype), blk))
        params[p] = torch.stack(new) if p[0] == "layers" else new[0]


def _sketch(params, grads, shares, scale, seed, directions
            ) -> Dict[str, List[float]]:
    """Each leaf's (clipped) gradient projected on its random directions:
    the dot products of this process's shares, summed over the
    processes."""
    names, dots = [], []
    for i, (p, t) in enumerate(params.items()):
        n, shape = blocks_of(p, t.shape)
        acc = torch.zeros(directions, dtype=F32, device=t.device)
        for b in range(n):
            for k in range(directions):
                u = shares.own(direction(seed, i, b, k, shape, t.device))
                acc[k] += torch.dot(u, grads[p][b])
        names.append(".".join(p))
        dots.append(acc * scale)
    dots = shares.total(torch.stack(dots)).tolist()
    return dict(zip(names, dots))
