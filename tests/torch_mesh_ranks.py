"""The port's mesh paths over gloo ranks on the CPU, for the mesh tests
(tests/test_torch_collective_planner.py, test_torch_tensor_parallel.py,
test_torch_zero1_elastic.py); a helper script, not a test file.

    python tests/torch_mesh_ranks.py WORLD OUT_DIR [SUITE]

starts WORLD ranks with ``spawn``; they meet through a ``FileStore`` in
OUT_DIR and write what they computed there, one ``.npz`` and one ``.json``
a rank and case; the tests compare it with the JAX package.  Suites:

- ``planner`` (the default): world 2 runs ``sharded_softmax_xent`` on a
  (1, 2) mesh; world 4 runs it on (2, 2) and (1, 4), ``compressed_psum``
  on both, and two steps of the mesh train step (glm4's smoke config) on
  (2, 2) under both planner strategies and the plain loss;
- ``tp``: two steps of the tensor-, expert- and ZeRO-1-parallel train
  step under the three losses: glm4 on (1, 2) (world 2) and on (1, 4),
  qwen3-moe on (2, 2) and (1, 4) (world 4); one qwen3-moe layer on (2, 2)
  at the smoke capacity, where each data rank's capacity drops tokens;
- ``tp_families``: two steps of the same train step for the other
  families, ``FAMILY_CASES`` (mamba2, hymba and its 5-head variant,
  seamless on world 2; deepseek-v3 on (2, 2) and mamba2 on (1, 4) on
  world 4), under the losses each case lists;
- ``elastic`` (world 4): a checkpoint of two glm4 steps written on (2, 2)
  (the whole leaves its gathers hold at once metered) and restored on
  (1, 4), (4, 1) and with no mesh; ``remesh`` and ``shrink_mesh``; the
  int8-compressed mesh step;
- ``serve``: ``Model.prefill``/``decode(mesh=)`` on fixed inputs (the
  logits, every cache shard, the collectives) and ``ServeEngine(mesh=)``
  through continuous-batching refills (the tokens, the collectives, the
  MoE drops), for each of ``SERVE_CASES``;
- ``pod`` (world 4): ``(pod, data, model)`` meshes: two steps of the train
  step for each of ``POD_CASES``, the int8-compressed step on (2, 2, 1),
  a checkpoint written on (2, 2, 1) and restored onto (2, 2, 1) and (1,
  4), and the serve cases of glm4 on (2, 1, 2) and (2, 2, 1);
- ``seq``: two steps with ``seq_shard`` on for each of ``SEQ_CASES`` (a
  case's arch ends in ``+seq``; glm4's ``+seq+tpoff`` has both knobs),
  and one prefill with it for each of ``SEQ_PREFILL``;
- ``tp_off``: two steps with ``tensor_parallel=False`` for each of
  ``TP_OFF_CASES`` (arch ending in ``+tpoff``);
- ``dryrun`` (world 4): two steps of the planner-loss ('dist') train
  step for each of ``DRYRUN_CASES`` on (2, 2), with the bytes of each
  rank's state, for the dry run's comparison
  (tests/test_torch_dryrun.py);
- ``fsdp`` (world 4): ZeRO-3 (a case's arch ends in ``+fsdp``): two
  steps of the train step for each of ``FSDP_CASES`` and
  ``FSDP_SEQ_CASES``, glm4's int8-compressed step on (2, 2) and a
  checkpoint of glm4's written there and restored onto (2, 2) and with no
  mesh, and
  the prefill, decode and engine of each of ``FSDP_SERVE`` on (2, 2).

:func:`run_worlds` starts the worlds of a suite side by side for a test
module.  Nothing here imports JAX.
"""
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]

# the loss inputs: glm4's smoke width, a real vocab that is not a multiple
# of any shard width (500 of a padded 512)
B, S, D, VOCAB = 4, 8, 64, 500
STEP_BATCH, STEP_SEQ, STEPS = 4, 16, 2
# (name, softmax strategy, planner loss) of the train step's variants
VARIANTS = (("dist", "dist", True), ("gather", "gather", True),
            ("plain", "auto", False))
# the tp suite's cases: (arch, mesh shape), by world
TP_CASES = {2: (("glm4-9b", (1, 2)),),
            4: (("glm4-9b", (1, 4)), ("qwen3-moe-30b-a3b", (2, 2)),
                ("qwen3-moe-30b-a3b", (1, 4)))}
# the tp_families suite's cases: (arch, mesh shape, variants), by world
FAMILY_CASES = {2: (("mamba2-130m", (1, 2), ("plain",)),
                    ("hymba-1.5b", (1, 2), ("dist", "gather", "plain")),
                    ("hymba-1.5b-h5", (1, 2), ("plain",)),
                    ("seamless-m4t-medium", (1, 2), ("plain",)),
                 ("glm4-9b+seq+tpoff", (1, 2), ("plain",))),
                4: (("deepseek-v3-671b", (2, 2), ("dist", "plain")),
                    ("mamba2-130m", (1, 4), ("plain",)))}
RESTORE_SHAPES = ((1, 4), (4, 1))
# the dryrun suite's (arch) cases on (2, 2), world 4
DRYRUN_CASES = ("glm4-9b", "qwen3-moe-30b-a3b")
# the MoE layer at the smoke capacity: 64 tokens a data rank on (2, 2),
# where the capacity is 32 (the whole batch's would be 40)
MOE_ARCH, MOE_B, MOE_S = "qwen3-moe-30b-a3b", 8, 16
RANKS_TIMEOUT = 240
# the serve suite's cases: (arch, mesh shape), by world; "hymba-1.5b-h5" is
# hymba's smoke config with 5 q and 5 kv heads of 12, whose wq and wk
# columns a 2-rank model axis splits mid-head, as hymba-1.5b's at full size
SERVE_CASES = {2: (("glm4-9b", (2, 1)), ("glm4-9b", (1, 2)),
                   ("mamba2-130m", (1, 2)), ("hymba-1.5b", (1, 2)),
                   ("hymba-1.5b-h5", (1, 2)), ("deepseek-v3-671b", (1, 2)),
                   ("seamless-m4t-medium", (1, 2))),
               4: (("glm4-9b", (1, 4)), ("mamba2-130m", (1, 4)),
                   ("hymba-1.5b", (1, 4)), ("qwen3-moe-30b-a3b", (2, 2)))}
# the pod suite's train cases: (arch, mesh shape, variants), world 4
POD_CASES = (("glm4-9b", (2, 2, 1), ("plain",)),
             ("glm4-9b", (2, 1, 2), ("dist", "gather", "plain")),
             ("qwen3-moe-30b-a3b", (2, 1, 2), ("dist", "plain")),
             ("mamba2-130m", (2, 2, 1), ("plain",)))
POD_CKPT_SHAPE, POD_RESTORE_SHAPES = (2, 2, 1), ((2, 2, 1), (1, 4))
# the pod suite's engine cases: (arch, mesh shape)
POD_SERVE = (("glm4-9b", (2, 1, 2)), ("glm4-9b", (2, 2, 1)))
# a case's config knob, by the suffix of its arch
KNOBS = {"+seq": {"seq_shard": True}, "+tpoff": {"tensor_parallel": False},
         "+fsdp": {"fsdp": True}}
# the fsdp suite's train cases (arch, mesh shape, variants), world 4:
# mamba2's smoke conv_b and norm_scale split over data on their layer dim
# on (2, 2); qwen3-moe's router and experts, and the planner loss's
# unembed, have gradients that the step sums over data itself; with
# tensor_parallel=False the whole unembed is gathered, then cut to the
# rank's vocab block; deepseek's two stacks and shared experts, hymba's
# two mixers and seamless's encoder and decoder stacks gather alike
FSDP_CASES = (("glm4-9b+fsdp", (2, 2), ("dist", "plain")),
              ("glm4-9b+fsdp", (4, 1), ("plain",)),
              ("mamba2-130m+fsdp", (2, 2), ("plain",)),
              ("qwen3-moe-30b-a3b+fsdp", (2, 2), ("dist",)),
              ("glm4-9b+tpoff+fsdp", (2, 2), ("dist",)),
              ("deepseek-v3-671b+fsdp", (2, 2), ("dist",)),
              ("hymba-1.5b+fsdp", (2, 2), ("plain",)),
              ("seamless-m4t-medium+fsdp", (2, 2), ("plain",)))
# ZeRO-3 beside seq_shard: the norms' Reduce-Scattered gradients are
# partial sums over model too
FSDP_SEQ_CASES = (("glm4-9b+seq+fsdp", (2, 2), ("dist",)),)
# the fsdp suite's serve cases on FSDP_SHAPE, and its checkpoint's arch
FSDP_SERVE = ("glm4-9b+fsdp", "mamba2-130m+fsdp", "seamless-m4t-medium+fsdp")
FSDP_SHAPE, FSDP_CKPT = (2, 2), "glm4-9b+fsdp"
# the seq suite's cases, by world; seamless without the knob beside it
SEQ_CASES = {2: (("glm4-9b+seq", (1, 2), ("dist", "plain")),
                 ("mamba2-130m+seq", (1, 2), ("plain",)),
                 ("hymba-1.5b+seq", (1, 2), ("dist",)),
                 ("deepseek-v3-671b+seq", (1, 2), ("dist",)),
                 ("qwen3-moe-30b-a3b+seq", (1, 2), ("plain",)),
                 ("seamless-m4t-medium+seq", (1, 2), ("plain",)),
                 ("seamless-m4t-medium", (1, 2), ("plain",)),
                 ("glm4-9b+seq+tpoff", (1, 2), ("plain",))),
             4: (("glm4-9b+seq", (1, 4), ("gather",)),
                 ("glm4-9b+seq", (2, 2, 1), ("plain",)))}
# the prefills with seq_shard on (1, 2) (world 2)
SEQ_PREFILL = ("glm4-9b+seq", "hymba-1.5b+seq", "deepseek-v3-671b+seq")
TP_OFF_CASES = {2: (("glm4-9b+tpoff", (1, 2), ("dist", "plain")),
                    ("qwen3-moe-30b-a3b+tpoff", (1, 2), ("plain",))),
                4: (("glm4-9b+tpoff", (2, 2), ("gather",)),
                    ("qwen3-moe-30b-a3b+tpoff", (2, 2), ("dist",)))}
# (slots, prompt length, cache length): hymba's prompt is longer than its
# smoke window of 32, so that its ring cache wraps
SERVE_SIZES = {"hymba-1.5b": (4, 40, 48), "hymba-1.5b-h5": (4, 40, 48)}
SERVE_DEFAULT_SIZES = (4, 8, 32)
# the engine's requests: more than its slots, finishing at different
# steps, so that slots are refilled mid-decode
SERVE_NEW_TOKENS = (3, 2, 4, 3, 2, 3)


def _split_knobs(arch):
    """(the arch without its knob suffixes, the knobs they set)."""
    knobs = {}
    while any(arch.endswith(s) for s in KNOBS):
        suffix = next(s for s in KNOBS if arch.endswith(s))
        knobs.update(KNOBS[suffix])
        arch = arch[:-len(suffix)]
    return arch, knobs


def reference_arch(arch) -> str:
    """A mesh case's arch without its knob suffixes: the arch of its
    mesh-free reference (the JAX package reads neither knob without a
    mesh)."""
    return _split_knobs(arch)[0]


def case_base(arch) -> str:
    """The registry arch of a mesh case's arch ("hymba-1.5b-h5" is
    hymba-1.5b's, "glm4-9b+seq" glm4-9b's)."""
    arch = reference_arch(arch)
    return arch[:-3] if arch.endswith("-h5") else arch


def mesh_axes_of(shape) -> tuple:
    """The axis names of a case's mesh shape: ``(pod, data, model)`` for
    three dims."""
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def case_overrides(arch) -> dict:
    """The smoke config's changes for the mesh cases, the same for both
    packages: f32; a MoE config at capacity factor E / k, where every
    expert takes all the tokens: the mesh step's capacity is that of each
    data rank's tokens (the JAX package's ``_cap(t_local)``), the
    mesh-free step's that of the whole batch, and the two agree only where
    nothing drops (the ranks count the drops); the 5-head variant's
    heads."""
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config(case_base(arch))
    out = {"dtype": "float32"}
    if cfg.is_moe:
        out["capacity_factor"] = cfg.n_experts / cfg.top_k
    if reference_arch(arch).endswith("-h5"):
        out.update(n_heads=5, n_kv_heads=5)
    out.update(_split_knobs(arch)[1])
    return out


def case_config(arch):
    from repro_torch.configs.registry import get_smoke_config
    return get_smoke_config(case_base(arch)).with_(**case_overrides(arch))


def serve_sizes(arch):
    return SERVE_SIZES.get(reference_arch(arch), SERVE_DEFAULT_SIZES)


def serve_inputs(cfg, arch):
    """Numpy seed 0: the prefill's tokens (B, prompt) and, for an enc-dec
    model, frames (B, prompt // enc_ratio, d); the decode step's tokens (B,
    1); the engine's prompts, one for each of ``SERVE_NEW_TOKENS``."""
    B, P, _ = serve_sizes(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, P))
    src = (rng.standard_normal((B, max(1, P // cfg.enc_ratio), cfg.d_model))
           .astype(np.float32) if cfg.is_encdec else None)
    nxt = rng.integers(0, cfg.vocab_size, size=(B, 1))
    prompts = [rng.integers(0, cfg.vocab_size, size=P).astype(np.int32)
               for _ in SERVE_NEW_TOKENS]
    return toks, src, nxt, prompts


def xent_inputs(Vp):
    """h (B, S, D), unembed (D, Vp), labels (B, S) from numpy, seed 0."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, Vp)) * 0.2).astype(np.float32)
    y = rng.integers(0, VOCAB, size=(B, S)).astype(np.int64)
    return h, w, y


def moe_layer_inputs():
    """The smoke config (f32, its own capacity factor), one MoE layer's
    params (L = 1), x (MOE_B, MOE_S, d) and the output's cotangent, from
    numpy seed 0.  x's tokens share one direction, so that the router
    sends most of them to the same experts and the capacity binds."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.moe import moe_specs
    cfg = get_smoke_config(MOE_ARCH).with_(dtype="float32")
    rng = np.random.default_rng(0)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
             ).astype(np.float32) for k, s in moe_specs(cfg, 1).items()}
    d = cfg.d_model
    x = (rng.standard_normal(d)
         + 0.3 * rng.standard_normal((MOE_B, MOE_S, d))).astype(np.float32)
    cot = rng.standard_normal((MOE_B, MOE_S, d)).astype(np.float32)
    return cfg, p, x, cot


def run_pod(rank, out_dir, meshes):
    """The pod suite: the train cases, the int8 step and the checkpoint on
    (2, 2, 1), restored onto each of ``POD_RESTORE_SHAPES``, and the serve
    case."""
    from repro_torch.train.checkpoint import (flatten_with_names,
                                              restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.train_step import state_placements
    for arch, shape, variants in POD_CASES:
        run_train_steps(meshes[shape], rank, out_dir, arch,
                        f"pod_{arch}_{tag_of(shape)}_{{variant}}", variants)
    m221 = meshes[POD_CKPT_SHAPE]
    _, cstate, arrays, cmeta = train_case("glm4-9b", m221, "auto", False,
                                          compression=True)
    for n, t in flatten_with_names(cstate.opt.err):
        arrays[f"err{n}"] = t.numpy().copy()
    _save(out_dir, "pod_int8", rank, arrays, cmeta)
    model, state, _, meta = train_case("glm4-9b", m221, "auto", False)
    ckpt = f"{out_dir}/ckpt"
    save_checkpoint(ckpt, STEPS, state, extra={"mesh": list(POD_CKPT_SHAPE)},
                    placements=state_placements(model, m221), mesh=m221)
    _save(out_dir, "pod_ckpt_saved", rank,
          _whole(state, state_placements(model, m221), m221), meta)
    for shape in POD_RESTORE_SHAPES:
        mesh = meshes[shape]
        placed = state_placements(model, mesh)
        got, step, extra = restore_checkpoint(ckpt, state, shardings=placed,
                                              mesh=mesh)
        local = {f"local{n}": t.numpy().copy()
                 for n, t in flatten_with_names(got)}
        _save(out_dir, f"pod_ckpt_restored_{tag_of(shape)}", rank,
              dict(_whole(got, placed, mesh), **local),
              {"coord": list(mesh.get_coordinate()), "step": step,
               "extra": extra})
    for arch, shape in POD_SERVE:
        run_serve(meshes[shape], rank, out_dir, arch)


def run_fsdp(rank, out_dir, meshes):
    """The fsdp suite: the train cases; the int8-compressed step and the
    checkpoint on ``FSDP_SHAPE``, written and restored through
    ``state_placements`` alone; the serve cases."""
    from repro_torch.train.checkpoint import (flatten_with_names,
                                              restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.train_step import state_placements
    for arch, shape, variants in FSDP_CASES + FSDP_SEQ_CASES:
        run_train_steps(meshes[shape], rank, out_dir, arch,
                        f"fsdp_{arch}_{tag_of(shape)}_{{variant}}", variants)
    mesh = meshes[FSDP_SHAPE]
    _, cstate, arrays, cmeta = train_case(FSDP_CKPT, mesh, "auto", False,
                                          compression=True)
    for n, t in flatten_with_names(cstate.opt.err):
        arrays[f"err{n}"] = t.numpy().copy()
    _save(out_dir, "fsdp_int8", rank, arrays, cmeta)
    model, state, _, meta = train_case(FSDP_CKPT, mesh, "auto", False)
    placed = state_placements(model, mesh)
    ckpt = f"{out_dir}/ckpt"
    save_checkpoint(ckpt, STEPS, state, placements=placed, mesh=mesh)
    _save(out_dir, "fsdp_ckpt_saved", rank, _whole(state, placed, mesh), meta)
    got, step, _ = restore_checkpoint(ckpt, state, shardings=placed,
                                      mesh=mesh)
    _save(out_dir, "fsdp_ckpt_restored", rank,
          dict(_whole(got, placed, mesh),
               **{f"local{n}": t.numpy().copy()
                  for n, t in flatten_with_names(got)}),
          {"coord": list(mesh.get_coordinate()), "step": step})
    whole, step, _ = restore_checkpoint(ckpt, state)
    _save(out_dir, "fsdp_ckpt_restored_none", rank,
          {n: t.numpy() for n, t in flatten_with_names(whole)},
          {"step": step})
    for arch in FSDP_SERVE:
        run_serve(mesh, rank, out_dir, arch)


def run_seq_prefill(mesh, rank, out_dir, arch):
    """One prefill of :func:`serve_inputs` with ``seq_shard`` on: the
    rank's rows and block of the logits, its cache shards, the
    collectives."""
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.parallel.sharding import (batch_spec, param_shardings,
                                               shard_bounds, shard_tree)
    from repro_torch.train.checkpoint import flatten_with_names
    cfg = case_config(arch)
    model = Model(cfg)
    params = shard_tree(model.init(0, device="cpu"),
                        param_shardings(model.specs, mesh), mesh)
    B, P, C = serve_sizes(arch)
    r0, r1 = shard_bounds((B,), batch_spec(mesh, B), mesh)[0]
    toks = serve_inputs(cfg, arch)[0]
    with torch.no_grad(), record_collectives() as rec:
        logits, cache = model.prefill(
            params, {"tokens": torch.from_numpy(toks[r0:r1]).long()}, C,
            mesh)
    _save(out_dir, f"prefill_{arch}", rank,
          dict({f"prefill{n}": t.numpy().copy()
                for n, t in flatten_with_names(cache)},
               prefill_logits=logits.numpy().copy()),
          {"coord": list(mesh.get_coordinate()), "rows": [r0, r1],
           "records": list(rec)})


def tag_of(shape) -> str:
    return "x".join(str(s) for s in shape)


def _save(out_dir, name, rank, arrays, meta):
    np.savez(f"{out_dir}/{name}.r{rank}.npz", **arrays)
    with open(f"{out_dir}/{name}.r{rank}.json", "w") as f:
        json.dump(meta, f)


def run_xent(mesh, rank, out_dir, tag):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.parallel.collective_planner import (record_collectives,
                                                         sharded_softmax_xent)
    from repro_torch.parallel.sharding import (batch_spec, local_shard,
                                               spec_for)
    Vp = get_smoke_config("glm4-9b").with_(vocab_size=VOCAB).padded_vocab
    h, w, y = (torch.from_numpy(a) for a in xent_inputs(Vp))
    rows = batch_spec(mesh, B)
    cols = spec_for(("embed", "vocab"), (D, Vp), mesh)
    for strategy in ("dist", "gather"):
        hl = local_shard(h, rows, mesh).clone().requires_grad_(True)
        wl = local_shard(w, cols, mesh).clone().requires_grad_(True)
        yl = local_shard(y, rows, mesh)
        with record_collectives() as fwd:
            loss = sharded_softmax_xent(hl, wl, yl, mesh, real_vocab=VOCAB,
                                        strategy=strategy)
        with record_collectives() as bwd:
            loss.backward()
        _save(out_dir, f"xent_{tag}_{strategy}", rank,
              {"loss": loss.detach().numpy(), "gh": hl.grad.numpy(),
               "gw": wl.grad.numpy()},
              {"coord": list(mesh.get_coordinate()), "fwd": fwd, "bwd": bwd,
               "Vp": Vp})


def run_compressed(mesh, rank, out_dir, tag):
    from repro_torch.parallel.compression import compressed_psum
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    mine = torch.from_numpy(np.random.default_rng(10 + rank).normal(
        size=(16, 8)).astype(np.float32))
    out = {}
    for axis in mesh.mesh_dim_names:
        out[f"same_{axis}"] = compressed_psum(g, mesh, axis).numpy()
        out[f"mine_{axis}"] = compressed_psum(mine, mesh, axis).numpy()
    _save(out_dir, f"compressed_{tag}", rank,
          dict(out, g=g.numpy(), x=mine.numpy()),
          {"coord": list(mesh.get_coordinate())})


def step_data(cfg, synthetic):
    """The mesh steps' data: ``synthetic`` (either package's
    ``SyntheticLM``) at seed 0, with an enc-dec model's frames."""
    return synthetic(cfg.vocab_size, STEP_SEQ, STEP_BATCH, seed=0,
                     encdec=cfg.is_encdec, d_model=cfg.d_model,
                     enc_ratio=cfg.enc_ratio)


def _batches(cfg):
    from repro_torch.train.data import SyntheticLM
    data = step_data(cfg, SyntheticLM)
    return [{k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
             else torch.from_numpy(v) for k, v in data.batch(i).items()}
            for i in range(STEPS)]


class _DropCounter:
    """Counts the (token, choice) assignments that ``moe_local`` drops
    (slot at or past the capacity), over every expert, per call."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.drops = moe, moe.moe_local, []

        def counted(cfg, x2d, gates, idx, *args):
            capacity = args[-1]
            self.drops.append(int((moe.slot_positions(cfg, idx)
                                   >= capacity).sum()))
            return self.orig(cfg, x2d, gates, idx, *args)
        moe.moe_local = counted

    def close(self):
        self.moe.moe_local = self.orig


def run_moe_capacity(mesh, rank, out_dir):
    """:func:`moe_layer_inputs`' layer through ``moe_apply(mesh=)``, forward
    and backward, with the params placed by ``param_shardings`` and x by
    ``batch_spec``; the drops counted."""
    from repro_torch.models.moe import capacity, moe_apply, moe_specs
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.parallel.sharding import (batch_spec, local_shard,
                                               param_shardings, shard_tree)
    cfg, p, x, cot = moe_layer_inputs()
    local = shard_tree({k: torch.from_numpy(v) for k, v in p.items()},
                       param_shardings(moe_specs(cfg, 1), mesh), mesh)
    local = {k: v[0].clone().requires_grad_(True) for k, v in local.items()}
    rows = batch_spec(mesh, MOE_B)
    xl = local_shard(torch.from_numpy(x), rows, mesh).clone() \
        .requires_grad_(True)
    cl = local_shard(torch.from_numpy(cot), rows, mesh)
    counter = _DropCounter()
    try:
        with record_collectives() as rec:
            out = moe_apply(cfg, local, xl, mesh)
            (out * cl).sum().backward()
    finally:
        counter.close()
    _save(out_dir, "moe_capacity", rank,
          dict({f"g_{k}": v.grad.numpy() for k, v in local.items()},
               out=out.detach().numpy(), gx=xl.grad.numpy()),
          {"coord": list(mesh.get_coordinate()), "drops": counter.drops,
           "capacity": capacity(cfg, MOE_B // mesh.shape[0] * MOE_S),
           "records": list(rec)})


class _GatherMeter:
    """The most bytes of whole leaves that ``train.checkpoint``'s gathers
    hold at once (a leaf counted from its gather until it is freed), and
    the largest and the sum of the leaves it gathered."""

    def __init__(self):
        from repro_torch.train import checkpoint
        self.mod, self.orig = checkpoint, checkpoint.gather_leaf
        self.alive, self.peak, self.largest, self.total = {}, 0, 0, 0

        def metered(t, placement, mesh):
            whole = self.orig(t, placement, mesh)
            if whole is not t:
                n = whole.numel() * whole.element_size()
                self.alive[id(whole)] = n
                weakref.finalize(whole, self.alive.pop, id(whole), None)
                self.largest, self.total = max(self.largest, n), \
                    self.total + n
                self.peak = max(self.peak, sum(self.alive.values()))
            return whole
        checkpoint.gather_leaf = metered

    def close(self) -> dict:
        self.mod.gather_leaf = self.orig
        return {"peak": self.peak, "largest": self.largest,
                "total": self.total}


def train_case(arch, mesh, strategy, planner, *, compression=False):
    """Two steps of the mesh train step from ``Model.init(0)``: the state,
    each step's loss, its collectives (outside and inside the remat
    recompute), the MoE drops, each step's local params."""
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.train.checkpoint import flatten_with_names
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    cfg = case_config(arch).with_(softmax_strategy=strategy)
    model = Model(cfg)
    opt_cfg = OptConfig(warmup_steps=1, total_steps=STEPS,
                        grad_compression=compression)
    state = init_train_state(model, model.init(0, device="cpu"), mesh,
                             compression=compression)
    step = make_train_step(model, opt_cfg, mesh, use_planner_loss=planner)
    arrays, losses, records, recompute = {}, [], [], []
    counter = _DropCounter()
    try:
        for i, batch in enumerate(_batches(cfg)):
            with record_collectives() as rec:
                state, metrics = step(state, batch)
            records.append(list(rec))
            recompute.append(list(rec.recompute))
            losses.append(float(metrics["loss"]))
            for n, t in flatten_with_names(state.params):
                arrays[f"step{i}{n}"] = t.detach().numpy().copy()
            for n, t in flatten_with_names(state.opt.m):
                arrays[f"step{i}m{n}"] = t.numpy().copy()
    finally:
        counter.close()
    for n, t in flatten_with_names(state.opt.m):
        arrays[f"m{n}"] = t.numpy().copy()
    meta = {"coord": list(mesh.get_coordinate()), "losses": losses,
            "records": records, "recompute": recompute,
            "drops": counter.drops}
    return model, state, arrays, meta


def run_train_steps(mesh, rank, out_dir, arch="glm4-9b", name=None,
                    variants=None):
    for variant, strategy, planner in VARIANTS:
        if variants is not None and variant not in variants:
            continue
        _, _, arrays, meta = train_case(arch, mesh, strategy, planner)
        _save(out_dir, name.format(variant=variant) if name
              else f"train_{variant}", rank, arrays, meta)


def _whole(tree, placements, mesh):
    """Every leaf of a tree of shards gathered whole, by JAX name."""
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.train.checkpoint import flatten_with_names
    names, leaves = zip(*flatten_with_names(tree))
    where = [p for _, p in flatten_with_names(placements)]
    whole = gather_tree(dict(enumerate(leaves)), dict(enumerate(where)),
                        mesh)
    return {n: whole[i].numpy().copy() for i, n in enumerate(names)}


def run_elastic(rank, out_dir, meshes):
    """A checkpoint written on (2, 2), restored on (1, 4), (4, 1) and with
    no mesh; the async writer on a mesh; ``remesh`` from (2, 2) to (1, 4)
    and onto ``shrink_mesh``'s mesh; the int8-compressed step."""
    from repro_torch.parallel.sharding import param_shardings
    from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                              flatten_with_names,
                                              restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.elastic import remesh, shrink_mesh
    from repro_torch.train.train_step import state_placements
    m22 = meshes[(2, 2)]
    model, state, _, meta = train_case("glm4-9b", m22, "auto", False)
    ckpt = f"{out_dir}/ckpt"
    meter = _GatherMeter()
    try:
        save_checkpoint(ckpt, STEPS, state, extra={"mesh": [2, 2]},
                        placements=state_placements(model, m22), mesh=m22)
    finally:
        gathered = meter.close()
    saved = _whole(state, state_placements(model, m22), m22)
    _save(out_dir, "ckpt_saved", rank, saved, dict(meta, gathered=gathered))
    for shape in RESTORE_SHAPES:
        mesh = meshes[shape]
        placed = state_placements(model, mesh)
        got, step, extra = restore_checkpoint(ckpt, state, shardings=placed,
                                              mesh=mesh)
        local = {f"local{n}": t.numpy().copy()
                 for n, t in flatten_with_names(got)}
        _save(out_dir, f"ckpt_restored_{tag_of(shape)}", rank,
              dict(_whole(got, placed, mesh), **local),
              {"coord": list(mesh.get_coordinate()), "step": step,
               "extra": extra})
    whole, step, _ = restore_checkpoint(ckpt, state)
    _save(out_dir, "ckpt_restored_none", rank,
          {n: t.numpy() for n, t in flatten_with_names(whole)},
          {"step": step})
    # the async writer on a mesh: rank 0 writes, every rank waits
    ckptr = AsyncCheckpointer(f"{out_dir}/ckpt_async", keep=2,
                              placements=state_placements(model, m22),
                              mesh=m22)
    meter = _GatherMeter()
    try:
        ckptr.save(STEPS, state)
    finally:
        gathered = meter.close()
    ckptr.wait()
    _save(out_dir, "ckpt_async", rank, {},
          {"errors": ckptr.errors, "gathered": gathered})

    def placements(m):
        return param_shardings(model.specs, m)
    moved = remesh(state.params, placements, m22, meshes[(1, 4)])
    _save(out_dir, "remesh_1x4", rank,
          {n: t.numpy() for n, t in flatten_with_names(moved)},
          {"coord": list(meshes[(1, 4)].get_coordinate())})
    small = shrink_mesh(1, model_parallel=2, device="cpu")
    shrunk = remesh(state.params, placements, m22, small)
    coord = small.get_coordinate()
    _save(out_dir, "shrink", rank,
          {} if shrunk is None else
          {n: t.numpy() for n, t in flatten_with_names(shrunk)},
          {"coord": None if coord is None else list(coord),
           "ranks": small.mesh.tolist(), "shape": list(small.shape),
           "names": list(small.mesh_dim_names)})
    # the int8-compressed step on (2, 2): error feedback by zero1_spec
    _, cstate, arrays, cmeta = train_case("glm4-9b", m22, "auto", False,
                                          compression=True)
    for n, t in flatten_with_names(cstate.opt.err):
        arrays[f"err{n}"] = t.numpy().copy()
    _save(out_dir, "train_int8", rank, arrays, cmeta)


def run_serve(mesh, rank, out_dir, arch):
    """One serve case on ``mesh``: prefill and one decode step of
    :func:`serve_inputs` through ``Model(mesh=)`` (with the greedy token),
    then the engine over the requests; the glm4 (1, 2) case also runs an
    engine whose deadline every request blows at its first token."""
    from repro_torch.models.layers import greedy_token
    from repro_torch.models.model import Model
    from repro_torch.parallel.collective_planner import record_collectives
    from repro_torch.parallel.sharding import (batch_spec, shard_bounds,
                                               shard_tree)
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.checkpoint import flatten_with_names
    from repro_torch.train.train_step import state_placements
    cfg = case_config(arch)
    model = Model(cfg)
    params = shard_tree(model.init(0, device="cpu"),
                        state_placements(model, mesh).params, mesh)
    B, P, C = serve_sizes(arch)
    r0, r1 = shard_bounds((B,), batch_spec(mesh, B), mesh)[0]
    toks, src, nxt, prompts = serve_inputs(cfg, arch)
    batch = {"tokens": torch.from_numpy(toks[r0:r1]).long()}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.from_numpy(src[r0:r1])
    arrays = {}
    counter = _DropCounter()
    try:
        with torch.no_grad():
            with record_collectives() as pre:
                logits, cache = model.prefill(params, batch, C, mesh)
                greedy_token(cfg, logits[:, -1], mesh)
            arrays["prefill_logits"] = logits.numpy().copy()
            arrays.update({f"prefill{n}": t.numpy().copy()
                           for n, t in flatten_with_names(cache)})
            with record_collectives() as dec:
                logits, cache = model.decode(
                    params, cache, torch.from_numpy(nxt[r0:r1]).long(), mesh,
                    C)
                greedy_token(cfg, logits[:, -1], mesh)
            arrays["decode_logits"] = logits.numpy().copy()
            arrays.update({f"decode{n}": t.numpy().copy()
                           for n, t in flatten_with_names(cache)})
        drops = list(counter.drops)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, SERVE_NEW_TOKENS))]
        eng = ServeEngine(model, params, batch_size=B, cache_len=C,
                          prompt_len=P, mesh=mesh, plan_warmup=False)
        with record_collectives() as run:
            eng.run(reqs)
        empty = model.init_cache(B, C, "cpu", mesh)
        meta = {"coord": list(mesh.get_coordinate()), "rows": [r0, r1],
                "init_cache": {n: [list(t.shape), float(t.float().sum())]
                               for n, t in flatten_with_names(empty)},
                "prefill": list(pre), "decode": list(dec),
                "engine": list(run), "stats": eng.stats,
                "outputs": [r.output for r in reqs], "drops": drops,
                "engine_drops": counter.drops[len(drops):]}
        if arch == "glm4-9b" and tuple(mesh.shape) == (1, 2):
            late = [Request(rid=i, prompt=p.copy(), max_new_tokens=4)
                    for i, p in enumerate(prompts)]
            eng = ServeEngine(model, params, batch_size=B, cache_len=C,
                              prompt_len=P, mesh=mesh, plan_warmup=False,
                              default_deadline_s=0.0)
            with record_collectives() as run:
                eng.run(late)
            meta["late"] = {"outputs": [r.output for r in late],
                            "timed_out": [r.timed_out for r in late],
                            "stats": eng.stats, "records": list(run)}
    finally:
        counter.close()
    _save(out_dir, f"serve_{arch}_{tag_of(mesh.shape)}", rank, arrays, meta)


def _rank(rank, world, out_dir, suite):
    from repro_torch.launch.mesh import make_auto_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(out_dir + "/store", world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)

    def mesh(shape):
        return make_auto_mesh(shape, mesh_axes_of(shape), "cpu")
    try:
        if suite == "planner" and world == 2:
            run_xent(mesh((1, 2)), rank, out_dir, "1x2")
        elif suite == "planner":
            m22, m14 = mesh((2, 2)), mesh((1, 4))
            run_xent(m22, rank, out_dir, "2x2")
            run_xent(m14, rank, out_dir, "1x4")
            run_compressed(m22, rank, out_dir, "2x2")
            run_compressed(m14, rank, out_dir, "1x4")
            run_train_steps(m22, rank, out_dir)
        elif suite == "tp":
            for arch, shape in TP_CASES[world]:
                run_train_steps(mesh(shape), rank, out_dir, arch,
                                f"tp_{arch}_{tag_of(shape)}_{{variant}}")
            if world == 4:
                run_moe_capacity(mesh((2, 2)), rank, out_dir)
        elif suite == "tp_families":
            for arch, shape, variants in FAMILY_CASES[world]:
                run_train_steps(mesh(shape), rank, out_dir, arch,
                                f"tp_{arch}_{tag_of(shape)}_{{variant}}",
                                variants)
        elif suite == "elastic":
            meshes = {s: mesh(s) for s in ((2, 2),) + RESTORE_SHAPES}
            run_elastic(rank, out_dir, meshes)
        elif suite == "serve":
            for arch, shape in SERVE_CASES[world]:
                run_serve(mesh(shape), rank, out_dir, arch)
        elif suite == "pod" and world == 4:
            shapes = {s for _, s, _ in POD_CASES} | {POD_CKPT_SHAPE} | {
                s for _, s in POD_SERVE}
            meshes = {s: mesh(s) for s in sorted(shapes |
                                                 set(POD_RESTORE_SHAPES))}
            run_pod(rank, out_dir, meshes)
        elif suite == "dryrun" and world == 4:
            from repro_torch.launch.specs import tree_bytes
            for arch in DRYRUN_CASES:
                _, state, arrays, meta = train_case(arch, mesh((2, 2)),
                                                    "dist", True)
                meta["state_bytes"] = tree_bytes(state)
                _save(out_dir, f"dryrun_{arch}", rank, {}, meta)
        elif suite == "fsdp" and world == 4:
            shapes = {s for _, s, _ in FSDP_CASES} | {FSDP_SHAPE}
            run_fsdp(rank, out_dir, {s: mesh(s) for s in sorted(shapes)})
        elif suite in ("seq", "tp_off"):
            cases = SEQ_CASES if suite == "seq" else TP_OFF_CASES
            for arch, shape, variants in cases[world]:
                run_train_steps(mesh(shape), rank, out_dir, arch,
                                f"{suite}_{arch}_{tag_of(shape)}_{{variant}}",
                                variants)
            if suite == "seq" and world == 2:
                m12 = mesh((1, 2))
                for arch in SEQ_PREFILL:
                    run_seq_prefill(m12, rank, out_dir, arch)
        else:
            raise ValueError(f"unknown suite {suite!r} at world {world}")
    finally:
        dist.destroy_process_group()


def run_worlds(tmp_path_factory, worlds, suite):
    """Run this script's ``suite`` for each world size in ``worlds`` side by
    side, each in its own subprocess with a timeout; returns the directory
    of each world's output.  Fails with the ranks' errors."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dirs, procs = {}, {}
    for world in worlds:
        d = tmp_path_factory.mktemp(f"{suite}{world}")
        dirs[world] = d
        procs[world] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(world),
             str(d), suite], cwd=d, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    errors = {}
    for world, p in procs.items():
        try:
            _, err = p.communicate(timeout=RANKS_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errors[world] = "timed out\n" + err[-3000:]
            continue
        if p.returncode:
            errors[world] = err[-3000:]
    assert not errors, errors
    return dirs


def load(d, name, world):
    """Every rank's (arrays, meta) of case ``name``."""
    return [(dict(np.load(d / f"{name}.r{r}.npz")),
             json.loads((d / f"{name}.r{r}.json").read_text()))
            for r in range(world)]


if __name__ == "__main__":
    world, out = int(sys.argv[1]), sys.argv[2]
    suite = sys.argv[3] if len(sys.argv) > 3 else "planner"
    mp.start_processes(_rank, args=(world, out, suite), nprocs=world,
                       start_method="spawn")
