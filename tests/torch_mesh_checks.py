"""Checks of the port's mesh train steps (run by tests/torch_mesh_ranks.py)
against the JAX package, shared by the mesh test files; a helper module,
not a test file.

- :func:`jax_steps`: two steps of the JAX package's mesh-free
  ``make_train_step`` from the port's initial parameters, on the same
  global batches; the reference of every mesh case.
- :func:`check_train_matches_jax`: each step's loss on every rank within
  ``STEP_TOL`` relative, the parameters assembled from the ranks' shards
  within ``STEP_TOL`` of the JAX step's, and every rank's shard exactly its
  block of the assembled whole under the JAX ``PartitionSpec``
  (``param_shardings``; the ZeRO-1 moments under ``zero1_shardings``
  against the JAX moments): the placements are the JAX package's, and the
  replicas agree bit for bit; an SSD family's moments and later losses
  at ``SSD_TOL``, and (``adam=True``) each parameter element also within
  what its gradient's bar moves it through AdamW (:func:`adam_bar`).
- :func:`check_collectives`: the collectives each rank issues outside the
  remat recompute are ``train_collective_schedule``'s entries with
  ``participants > 1``, corrected where the declaration miscounts a
  family's layers, a knob's layout or ZeRO-3's gathers
  (:func:`declaration_corrections`, ROADMAP C.11-C.16, C.20, C.21), and
  the port's own (:func:`port_own_schedule`), nothing else.

A mesh shape of two dims is ``(data, model)``, of three ``(pod, data,
model)``; the data axes' size ``P_dp`` is the product of all but the
last.  A case's arch may end in a knob (``torch_mesh_ranks.KNOBS``):
``+seq`` (``seq_shard``), ``+tpoff`` (``tensor_parallel=False``) or
``+fsdp`` (ZeRO-3: each parameter at its ``zero1_shardings`` block); its
reference is the JAX mesh-free step of the arch without it.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro.parallel import collective_planner as jcp
from repro.parallel import sharding as jsh
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro.train.train_step import TrainState as JTrainState
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.models.model import Model
from repro_torch.models.moe import reduced_on_mesh
from repro_torch.models.transformer import acts_on_rows

import torch_mesh_ranks as ranks

# f32 sums over the ranks in another order than one device's, and AdamW's
# update of a few 1e-4 a step
STEP_TOL = 1e-5
# an SSD family's bar on its gradients and what they move, relative to the
# leaf's largest |JAX|: both packages round the scan's inputs to bf16, and
# an f32 difference in the order of a sum flips a few of those roundings
# (GRAD_TOL in tests/test_torch_train.py)
SSD_TOL = 1e-2
AXES = ("data", "model")
# the forward collectives a remat recompute may repeat ("params/": every
# ZeRO-3 gather of a layer's weights)
RECOMPUTED = {"tp/attn-out", "tp/ffn-out", "tp/q-gather", "tp/kv-gather",
              "tp/ssm-gather", "tp/ssm-norm", "tp/ssm-out", "moe/combine",
              "moe/shared-out", "tp/seq-gather", "params/"}
# the parameter stacks of the layers: a leaf under one is (L, ...)
STACKS = ("layers", "dense_layers", "enc_layers", "dec_layers")
SEQ = "tp/seq-gather"


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_config(arch):
    """The JAX package's config of a mesh case's arch (``ranks.
    case_config``'s)."""
    return jget_smoke(ranks.case_base(arch)).with_(
        **ranks.case_overrides(arch))


@functools.lru_cache(maxsize=None)
def jax_steps(arch):
    """[(loss, params by name, first moments by name)] after each step."""
    from repro.train.data import SyntheticLM as JSyntheticLM
    cfg = ranks.case_config(arch)
    p0 = Model(cfg).init(0, device="cpu")

    def to_jax(t):
        return {k: to_jax(v) for k, v in t.items()} if isinstance(t, dict) \
            else jnp.asarray(t.numpy())
    params = to_jax(p0)
    step = jax.jit(jmake_train_step(
        JModel(jax_config(arch)),
        JOptConfig(warmup_steps=1, total_steps=ranks.STEPS)))
    state = JTrainState(params, jinit_opt_state(params))
    data = ranks.step_data(cfg, JSyntheticLM)
    out = []
    for i in range(ranks.STEPS):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in data.batch(i).items()})
        out.append((float(metrics["loss"]), _flat(state.params),
                    _flat(state.opt.m)))
    return out, state


def _sizes(shape):
    """(P_dp, m) of a mesh shape."""
    return int(np.prod(shape[:-1])), shape[-1]


def _trimmed(spec) -> tuple:
    """A ``PartitionSpec`` as a tuple, trailing Nones dropped (the form of
    the port's ``partition_spec``)."""
    t = list(spec)
    while t and t[-1] is None:
        t.pop()
    return tuple(t)


def jax_specs(arch, shape, zero1=False):
    """Each parameter's JAX ``PartitionSpec`` on the mesh, by name, as a
    tuple without trailing Nones; with ``tensor_parallel=False`` from axes
    that are all None, as the JAX package's ``launch/specs.py::
    state_specs`` places them."""
    cfg = jax_config(arch)
    jm = JModel(cfg)
    rule = jsh.zero1_shardings if zero1 else jsh.param_shardings
    axes = jm.param_axes()
    if not cfg.tensor_parallel:
        axes = jax.tree.map(lambda t: tuple(None for _ in t), axes,
                            is_leaf=lambda x: isinstance(x, tuple) and all(
                                isinstance(e, (str, type(None)))
                                for e in x))
    tree = rule(axes, jm.abstract_params(),
                AbstractMesh(shape, ranks.mesh_axes_of(shape)))
    return {jax.tree_util.keystr(p): _trimmed(v.spec) for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))[0]}


def param_specs(arch, shape):
    """Each parameter's JAX ``PartitionSpec`` as the case places it: its
    ``zero1_shardings`` spec under ``fsdp`` (ZeRO-3, the JAX
    ``state_specs``), else its ``param_shardings`` spec."""
    return jax_specs(arch, shape, zero1=jax_config(arch).fsdp)


def block_index(spec, coord, shape, full_shape):
    """The slices of the block of a tensor of ``full_shape`` that the rank
    at ``coord`` holds under a JAX ``PartitionSpec``."""
    sizes = dict(zip(ranks.mesh_axes_of(shape), shape))
    at = dict(zip(ranks.mesh_axes_of(shape), coord))
    out = []
    for d, n in enumerate(full_shape):
        e = spec[d] if d < len(spec) else None
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        i, k = 0, 1
        for a in axes:
            i, k = i * sizes[a] + at[a], k * sizes[a]
        out.append(slice(i * n // k, (i + 1) * n // k))
    return tuple(out)


def assemble(res, key, spec, shape, full_shape):
    """The whole tensor from every rank's block ``key``, each rank's block
    checked to be exactly its block of the whole (replicas agree)."""
    full = np.zeros(full_shape, dtype=res[0][0][key].dtype)
    for arr, meta in res:
        full[block_index(spec, meta["coord"], shape, full_shape)] = arr[key]
    for arr, meta in res:
        np.testing.assert_array_equal(
            arr[key], full[block_index(spec, meta["coord"], shape,
                                       full_shape)], err_msg=key)
    return full


def check_train_matches_jax(res, arch, shape, *, adam=False):
    """Each step's loss, the parameters after it and the last moments
    against the JAX mesh-free step, at ``STEP_TOL``.  An SSD family's
    moments after step i at (i + 1) ``SSD_TOL`` of the leaf's largest
    |JAX| (after the first step the gradient's bar, as ``GRAD_TOL``), its
    losses after the first step at ``SSD_TOL`` relative.  With ``adam`` a parameter
    element is held to ``STEP_TOL`` plus what the gradients' own bar
    moves it through AdamW (:func:`adam_bar`)."""
    steps, _ = jax_steps(ranks.reference_arch(arch))
    for _, meta in res:
        assert not any(meta["drops"])       # nothing drops: see overrides
    ssd = ranks.case_config(arch).has_ssm
    b1 = JOptConfig().betas[0]
    specs, zspecs = param_specs(arch, shape), jax_specs(arch, shape, True)
    least, prev_m = {}, {}
    for i, (want_loss, want, want_m) in enumerate(steps):
        for _, meta in res:
            tol = SSD_TOL if ssd and i else STEP_TOL
            assert abs(meta["losses"][i] / want_loss - 1) <= tol, i
        for name, w in want.items():
            got = assemble(res, f"step{i}{name}", specs[name], shape,
                           w.shape)
            # this step's JAX gradient, from its first moments
            g = np.abs(want_m[name] - b1 * prev_m.get(name, 0.0)) / (1 - b1)
            prev_m[name] = want_m[name]
            least[name] = np.minimum(least.get(name, g), g)
            bar = STEP_TOL + (adam_bar(least[name], g.max(), i, ssd)
                              if adam else 0.0)
            err = np.abs(got - w)
            assert (err <= bar).all(), (i, name, err.max())
            if ssd:
                # each step adds its own bf16 flips to those that moved
                # the parameters its gradient is taken at
                got = assemble(res, f"step{i}m{name}", zspecs[name], shape,
                               w.shape)
                tol = (i + 1) * SSD_TOL * np.abs(want_m[name]).max()
                assert np.abs(got - want_m[name]).max() <= tol, (i, name)
    for name, w in want_m.items():
        got = assemble(res, f"m{name}", zspecs[name], shape, w.shape)
        if not ssd:
            assert np.abs(got - w).max() <= STEP_TOL, name


def adam_bar(g, g_max, step, ssd):
    """What AdamW's updates through ``step`` can move an element whose
    gradient was ``g`` at least, where each gradient is held to ``tau``
    of its leaf's largest, ``g_max`` (``SSD_TOL`` for an SSD family, else
    ``STEP_TOL``): an update is lr g / (|g| + eps) at the first step and a
    ratio of the moments after, so a relative error e of g moves it by
    about 2 lr e, and never by more than 2 lr.  A gradient near zero is
    decided by f32 noise, in the port's mesh-free step as on the mesh
    (``test_torch_tensor_parallel_families.py::
    test_adam_bar_is_needed_without_a_mesh``)."""
    tau = SSD_TOL if ssd else STEP_TOL
    lr = JOptConfig().lr
    e = np.minimum(1.0, tau * g_max / np.maximum(g, 1e-30))
    return 2 * lr * (step + 1) * e


def _model_shards(spec):
    return [e for e in spec if e is not None]


def _layer_counts(cfg):
    """(GQA attention, MLA, dense FFN, MoE layers) of a decoder."""
    L = cfg.n_layers
    n_moe = L - cfg.first_dense_layers if cfg.is_moe else 0
    n_attn = L if cfg.has_attention else 0
    n_mla = n_attn if cfg.attn_type == "mla" else 0
    return n_attn - n_mla, n_mla, (L - n_moe) * (cfg.d_ff > 0), n_moe


def _splits_sequence(cfg, shape):
    return cfg.seq_shard and not cfg.is_encdec \
        and ranks.STEP_SEQ % shape[-1] == 0


def _dp_entry(entry) -> bool:
    axes = entry if isinstance(entry, tuple) else (entry,)
    return any(a in ("pod", "data") for a in axes)


def port_own_schedule(arch, shape, planner):
    """The port's own collectives of one step, {(label, type, dv_bytes,
    participants): count}, participants > 1 only: the embedding's
    All-Reduce (under ``seq_shard`` its Reduce-Scatter and the
    transpose's All-Gather), the q and kv projections' All-Gathers and
    their Reduce-Scatters where a head is split, the q/k-norm scales'
    cotangents, the SSM mixer's (its in_proj and conv outputs' gathers and
    their transposes, the norm's sum and its transpose, *f* and *g* or,
    under ``seq_shard``, the rows' gather and scatter, the per-head
    leaves' cotangents), MLA's latents' cotangent, the shared experts' *f*
    and *g* (under ``seq_shard`` their rows' gather and scatter), the
    encoder output's cotangent under the cross-attention, the final hidden
    state's gather under ``seq_shard``, the plain loss's unembed gather
    and mean, the norm's model-axis sum, and ZeRO-1's All-Gather of each
    data-sliced parameter.  With ``tensor_parallel=False`` every layer
    runs whole: none of the ``tp/`` ones, but under ``seq_shard`` the
    embedding's block of rows and the final gather."""
    cfg = jax_config(arch)
    P_dp, m = _sizes(shape)
    seq, tp = _splits_sequence(cfg, shape), cfg.tensor_parallel
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    act = ranks.STEP_BATCH // P_dp * ranks.STEP_SEQ
    full = act * D * 4.0
    own = collections.Counter()
    if m > 1 and tp:
        if seq:
            own[("tp/embed", "ReduceScatter", full, m)] += 1
            own[("tp/embed", "AllGather", full, m)] += 1
            own[(SEQ, "AllGather", full, m)] += 1
        else:
            own[("tp/embed", "AllReduce", full, m)] += 1
        n_attn = L if cfg.has_attention and cfg.attn_type != "mla" else 0
        if cfg.n_heads % m and n_attn:
            q = act * cfg.n_heads * hd * 4.0
            own[("tp/q-gather", "AllGather", q, m)] += n_attn
            own[("tp/q-gather", "ReduceScatter", q, m)] += n_attn
        if cfg.n_kv_heads % m and n_attn:
            kv = act * cfg.n_kv_heads * hd * 4.0
            own[("tp/kv-gather", "AllGather", kv, m)] += 2 * n_attn
            own[("tp/kv-gather", "ReduceScatter", kv, m)] += 2 * n_attn
        if cfg.qk_norm:
            own[("tp/qk-norm-grad", "AllReduce", hd * 4.0, m)] += 2 * L
        if cfg.has_ssm:
            di, nh, cd = cfg.d_inner, cfg.ssm_nheads, cfg.conv_dim
            for cols in (di + cd + nh, cd):
                own[("tp/ssm-gather", "AllGather", act * cols * 4.0, m)] += L
                own[("tp/ssm-gather", "ReduceScatter", act * cols * 4.0,
                     m)] += L
            if nh % m == 0:
                own[("tp/ssm-norm", "AllReduce", act * 4.0, m)] += 2 * L
            if seq:
                own[("tp/ssm-out", "ReduceScatter", full, m)] += L
                own[("tp/ssm-out", "AllGather", full, m)] += L
                if not cfg.has_attention:
                    # a hybrid's mixers share the attention's gather
                    own[(SEQ, "AllGather", full, m)] += L
                    own[(SEQ, "ReduceScatter", full, m)] += L
            else:
                own[("tp/ssm-out", "AllReduce", full, m)] += 2 * L
            own[("tp/ssm-param-grad", "AllReduce", 3 * nh * 4.0, m)] += L
        if cfg.attn_type == "mla":
            lat = cfg.q_lora_rank + cfg.kv_lora_rank + cfg.rope_head_dim
            own[("tp/mla-latent", "AllReduce", act * lat * 4.0, m)] += L
        n_shared = (L - cfg.first_dense_layers) * bool(cfg.n_shared_experts)
        if seq:
            # the shared experts gather their rows and scatter their own
            for col in ("AllGather", "ReduceScatter"):
                own[("moe/shared-out", col, full, m)] += n_shared
                own[(SEQ, col, full, m)] += n_shared
        else:
            own[("moe/shared-out", "AllReduce", full, m)] += 2 * n_shared
        if cfg.is_encdec:
            frames = act // ranks.STEP_SEQ * max(
                1, ranks.STEP_SEQ // cfg.enc_ratio)
            own[("tp/cross-kv", "AllReduce", frames * D * 4.0, m)] += 1
        if not planner:
            own[("tp/unembed-gather", "AllGather",
                 D * cfg.padded_vocab * 4.0, m)] += 1
    elif m > 1 and seq:
        # a whole embedding's block of rows and the final rows' gather
        own[("tp/embed", "AllGather", full, m)] += 1
        own[(SEQ, "AllGather", full, m)] += 1
    specs, zspecs = jax_specs(arch, shape), jax_specs(arch, shape, True)
    leaves = jax.tree_util.tree_flatten_with_path(
        JModel(cfg).abstract_params())[0]
    for ms, ds in {(bool(_model_shards(specs[name])),
                    cfg.fsdp and _data_split(zspecs[name]))
                   for name in (jax.tree_util.keystr(p) for p, _ in leaves)}:
        # the norm's squares of each kind of leaf summed over its axes
        P = (m if ms else 1) * (P_dp if ds else 1)
        if P > 1:
            own[("grads/norm", "AllReduce", 4.0, P)] += 1
    if P_dp > 1:
        if not planner:
            own[("loss/mean", "AllReduce", 4.0, P_dp)] += 2
        for path, leaf in leaves:
            name = jax.tree_util.keystr(path)
            if _data_split(zspecs[name]) and not cfg.fsdp:
                n = np.prod(leaf.shape) / m ** len(_model_shards(specs[name]))
                own[("zero1/params", "AllGather", n * 4.0, P_dp)] += 1
    return own


def _data_split(zspec) -> bool:
    return any(e is not None and _dp_entry(e) for e in zspec)


def zero3_leaves(arch, shape):
    """Under ``fsdp``, each parameter's ZeRO-3 collectives as the step
    issues them outside the recompute, {name: (keys, kind, n, dv)}: the
    data axes split it on a dim of a layer's slice ("layer": n per-layer
    gathers of the slice, dv its bytes, each recomputed), on the stack's
    layer dim or on an unstacked leaf ("whole": n gathers of the leaf,
    two for a tied table, which the unembed gathers again), or not at all
    ("kept": its gradient All-Reduced, C.6-sized); dv is the rank's
    ``model`` shard's f32 bytes."""
    cfg = jax_config(arch)
    specs, zspecs = jax_specs(arch, shape), jax_specs(arch, shape, True)
    m = shape[-1]
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            JModel(cfg).abstract_params())[0]:
        name = jax.tree_util.keystr(path)
        keys = tuple(k.key for k in path)
        n = np.prod(leaf.shape) / m ** len(_model_shards(specs[name]))
        dims = [i for i, e in enumerate(zspecs[name])
                if e is not None and _dp_entry(e)]
        if not dims:
            out[name] = (keys, "kept", 1, n * 4.0)
        elif keys[0] in STACKS and dims[0] > 0:
            L = leaf.shape[0]
            out[name] = (keys, "layer", L, n * 4.0 / L)
        else:
            tied = keys == ("embedding",) and cfg.tie_embeddings
            out[name] = (keys, "whole", 2 if tied else 1, n * 4.0)
    return out


def _reduced_in_step(keys, planner) -> bool:
    """The leaves whose gradients the step sums over data itself (the
    planner loss's unembed, the MoE router and experts on a mesh)."""
    return (planner and keys == ("unembed",)) or reduced_on_mesh(keys)


def declaration_corrections(arch, shape, planner=True):
    """Where ``train_collective_schedule`` miscounts what the step issues
    (ROADMAP Queue C), each a named, counted correction of the declared
    entries: {Queue C item: {(label, type, dv_bytes, participants): signed
    count}}.  The declaration counts ``tp/attn-out`` twice for each of
    ``n_layers`` and ``tp/ffn-out`` twice for each layer without experts,
    whatever the layers hold:

    - C.11: an SSM layer has no attention, and mamba2 no MLP (d_ff 0):
      none of either is issued;
    - C.12: an enc-dec model's encoder layers and decoder cross-attention
      are left out: the encoder's attention and MLP (at the frames'
      activation) and the cross-attention each issue two;
    - C.13: MLA reduces its backward at the latents (``tp/mla-latent``,
      q_lora + kv_lora + rope columns), not at d_model: one
      ``tp/attn-out`` a layer (the forward *g*);
    - C.14: the shared experts' gradients are All-Reduced over the data
      axes (``grads/...moe.shared_*``), which the declaration leaves out
      with the routed experts' (the keys under ``moe``);
    - C.15: under ``seq_shard`` each block's two All-Reduces
      (``tp/attn-out``, ``tp/ffn-out``; MoE's three ``moe/combine``) are
      a Reduce-Scatter out and its transpose's All-Gather, with an
      All-Gather of the rows in (``tp/seq-gather``) and its transpose's
      Reduce-Scatter (none at MLA, whose latents' *f* makes the cotangent
      whole); the leaves that act on the residual's rows (the norms,
      hymba's mixing weights) hold partial gradients over ``model`` and
      are All-Reduced over every axis, not over the data axes; with
      ``tensor_parallel=False`` too, where the dense blocks' whole weights
      gather the rows in and take their block out, which the declaration
      (no ``tp/`` entry) leaves out;
    - C.16: with ``tensor_parallel=False`` the expert stack and the
      planner loss's unembed are whole on every rank and each rank cuts
      its block (as the JAX ``shard_map`` slices them): their gradients'
      blocks are All-Gathered over ``model`` (``moe/expert-block``,
      ``xent/unembed-block``), which GSPMD issues undeclared;
    - C.20: under ``fsdp`` the declaration counts one ``grads/`` Reduce-
      Scatter and two ``params/`` All-Gathers of each whole leaf: the
      step issues one of each a layer, of the layer's slice, its
      recompute's gathers in ``.recompute``; a leaf split on its layer
      dim, or unstacked, one of each of the whole leaf (a tied table
      two); a leaf that the data axes keep whole its ``grads/`` All-
      Reduce (under C.14 the shared experts are this item's too);
    - C.21: under ``fsdp`` the gathers of the leaves whose gradients the
      step sums over data itself (the MoE router and experts, the planner
      loss's unembed) are issued, one a layer or one of the leaf, and not
      declared."""
    cfg = jax_config(arch)
    P_dp, m = _sizes(shape)
    out = {}
    if cfg.fsdp and P_dp > 1:
        _zero3_corrections(arch, shape, planner, out)
    if m == 1:
        return out
    L, D = cfg.n_layers, cfg.d_model
    act = ranks.STEP_BATCH // P_dp * ranks.STEP_SEQ * D * 4.0

    def fix(item, label, count, dv=act, col_type="AllReduce", P=m):
        if count:
            out.setdefault(item, collections.Counter())[
                (label, col_type, dv, P)] += count
    n_gqa, n_mla, n_mlp, n_moe = _layer_counts(cfg)
    if cfg.tensor_parallel:
        if cfg.has_ssm:
            fix("C.11", "tp/attn-out", -2 * L * (not cfg.has_attention))
            fix("C.11", "tp/ffn-out", -2 * (L - n_moe) * (cfg.d_ff == 0))
        if cfg.is_encdec:
            enc = act // ranks.STEP_SEQ * max(1, ranks.STEP_SEQ
                                              // cfg.enc_ratio)
            fix("C.12", "tp/attn-out", 2 * cfg.n_enc_layers, enc)
            fix("C.12", "tp/ffn-out", 2 * cfg.n_enc_layers, enc)
            fix("C.12", "tp/attn-out", 2 * L)
        if cfg.attn_type == "mla":
            fix("C.13", "tp/attn-out", -L)
    abstract = jax.tree_util.tree_flatten_with_path(
        JModel(cfg).abstract_params())[0]
    specs = jax_specs(arch, shape)
    if cfg.n_shared_experts and n_moe and P_dp > 1 and not cfg.fsdp:
        for path, leaf in abstract:
            keys = [k.key for k in path]
            if "moe" in keys and keys[-1].startswith("shared_"):
                name = jax.tree_util.keystr(path)
                n = np.prod(leaf.shape) / m ** len(_model_shards(specs[name]))
                fix("C.14", "grads/" + ".".join(keys), 1, n * 4.0,
                    P=P_dp)
    if _splits_sequence(cfg, shape):
        blocks = (("tp/attn-out", n_gqa + n_mla, 2 * n_gqa + n_mla),
                  ("tp/ffn-out", n_mlp, 2 * n_mlp),
                  ("moe/combine", n_moe, 3 * n_moe))
        if not cfg.tensor_parallel:
            # whole weights: the dense blocks gather the rows in and take
            # their block of the output (its transpose an All-Gather);
            # none was declared
            for label, n, _ in blocks[:2]:
                fix("C.15", label, n, col_type="AllGather")
            fix("C.15", SEQ, n_gqa + n_mla + n_mlp, col_type="AllGather")
            blocks = blocks[2:]
        for label, n, ars in blocks:
            fix("C.15", label, -ars)
            fix("C.15", label, n, col_type="ReduceScatter")
            fix("C.15", label, n, col_type="AllGather")
        n_split = sum(n for _, n, _ in blocks)
        fix("C.15", SEQ, n_split, col_type="AllGather")
        # MLA's latents' *f* leaves no partial cotangent to scatter
        fix("C.15", SEQ, n_split - n_mla * cfg.tensor_parallel,
            col_type="ReduceScatter")
        for path, leaf in abstract:
            keys = [k.key for k in path]
            if acts_on_rows(keys):
                label = "grads/" + ".".join(keys)
                n = np.prod(leaf.shape) * 4.0
                fix("C.15", label, 1, n, P=P_dp * m)
                if P_dp > 1:
                    fix("C.15", label, -1, n, P=P_dp)
    if not cfg.tensor_parallel:
        if planner:
            fix("C.16", "xent/unembed-block", 1, D * cfg.padded_vocab * 4.0,
                "AllGather")
        fix("C.16", "moe/expert-block", 3 * n_moe,
            cfg.n_experts * D * cfg.moe_d_ff * 4.0, "AllGather")
    return out


def _zero3_corrections(arch, shape, planner, out):
    """C.20 and C.21 into ``out`` (:func:`declaration_corrections`)."""
    cfg = jax_config(arch)
    P_dp, m = _sizes(shape)
    declared = set()
    for d in jcp.train_collective_schedule(
            cfg, AbstractMesh(shape, ranks.mesh_axes_of(shape)),
            ranks.STEP_BATCH, ranks.STEP_SEQ, planner_loss=planner,
            params=JModel(cfg).abstract_params()):
        if d.label.startswith("params/"):
            declared.add(d.label[len("params/"):])
    for keys, kind, n, dv in zero3_leaves(arch, shape).values():
        name = ".".join(keys)
        fixes = out.setdefault(
            "C.21" if _reduced_in_step(keys, planner) else "C.20",
            collections.Counter())
        if name in declared:
            whole = dv * n if kind == "layer" else dv
            fixes[("grads/" + name, "ReduceScatter", whole, P_dp)] -= 1
            fixes[("params/" + name, "AllGather", whole, P_dp)] -= 2
        if kind == "kept":
            fixes[("grads/" + name, "AllReduce", dv, P_dp)] += 1
            continue
        fixes[("params/" + name, "AllGather", dv, P_dp)] += n
        if not _reduced_in_step(keys, planner):
            fixes[("grads/" + name, "ReduceScatter", dv, P_dp)] += n


def check_collectives(res, arch, shape, variant):
    """Every rank's collectives of each step outside the recompute against
    the declared schedule (participants > 1; a ``grads/...`` or
    ``params/...`` entry sized by the declaration as the whole leaf, which
    the port reduces or gathers in its ``model`` shards: the declared
    bytes divided by the leaf's shards)
    with :func:`declaration_corrections` applied, plus
    :func:`port_own_schedule`; the recompute's only forward ones."""
    cfg = jax_config(arch)
    planner = variant != "plain" and not cfg.tie_embeddings \
        and not cfg.is_encdec
    jcfg = cfg.with_(softmax_strategy=variant if planner else "auto")
    specs = jax_specs(arch, shape)
    m = shape[-1]
    want = collections.Counter()
    for d in jcp.train_collective_schedule(
            jcfg, AbstractMesh(shape, ranks.mesh_axes_of(shape)),
            ranks.STEP_BATCH, ranks.STEP_SEQ, planner_loss=planner,
            params=JModel(jcfg).abstract_params()):
        if d.participants <= 1:
            continue
        dv = d.dv_bytes
        if d.label.startswith(("grads/", "params/")):
            name = "".join(f"['{k}']" for k in
                           d.label.split("/", 1)[1].split("."))
            dv /= m ** len(_model_shards(specs[name]))
        want[(d.label, d.col_type, dv, d.participants)] += d.count
    for fixes in declaration_corrections(arch, shape, planner).values():
        for key, n in fixes.items():
            want[key] += n
    want.update(port_own_schedule(arch, shape, planner))
    assert min(want.values(), default=0) >= 0
    want = {k: n for k, n in want.items() if n}
    assert any(k[0].startswith("tp/") for k in want) == (
        m > 1 and (cfg.tensor_parallel or _splits_sequence(cfg, shape)))
    for _, meta in res:
        for rec, again in zip(meta["records"], meta["recompute"]):
            got = collections.Counter(tuple(r) for r in rec if r[3] > 1)
            assert dict(got) == want, {
                k: (got.get(k, 0), want.get(k, 0))
                for k in set(got) | set(want) if got.get(k) != want.get(k)}
            assert {"params/" if r[0].startswith("params/") else r[0]
                    for r in again} <= RECOMPUTED


# the share of a leaf's elements whose int8 rounding may flip
FLIP_SHARE = 1e-3


def within_but_flips(got, want, outlier_bound, what):
    """``got`` within ``STEP_TOL`` of ``want`` but at most ``FLIP_SHARE``
    of the elements, each of those within ``outlier_bound``."""
    off = np.abs(got - want)
    flips = off > STEP_TOL
    assert np.count_nonzero(flips) <= FLIP_SHARE * want.size, \
        (what, np.count_nonzero(flips), want.size)
    assert off.max() <= outlier_bound, (what, off.max(), outlier_bound)


def state_spec(arch, name, shape):
    """The JAX ``PartitionSpec`` of a train state's leaf by its name."""
    if name.startswith(".params"):
        return param_specs(arch, shape)[name[len(".params"):]]
    if name.startswith((".opt.m", ".opt.v")):
        return jax_specs(arch, shape, True)[name[len(".opt.m"):]]
    assert name == ".opt.step", name
    return ()


def check_int8_step(res, arch, shape):
    """The int8-compressed mesh step (``torch_mesh_ranks`` ``train_case``
    with ``compression``) against the JAX compressed step without a mesh:
    the losses within ``STEP_TOL``; the parameters and the error feedback,
    assembled by the JAX ``PartitionSpec``s, within it but at rounding
    flips (:func:`within_but_flips`: a flip moves Adam's update by up to
    lr and the error feedback by a quantum, held at four times the JAX
    step's largest residual); each leaf's int8 scale from one MAX
    All-Reduce over the whole mesh (``grads/compress-scale``)."""
    import jax.numpy as jnp
    from repro.train.data import SyntheticLM as JSyntheticLM
    zspecs, pspecs = jax_specs(arch, shape, True), param_specs(arch, shape)
    cfg = ranks.case_config(arch)
    p0 = Model(cfg).init(0, device="cpu")
    params = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p0)
    opt = JOptConfig(warmup_steps=1, total_steps=ranks.STEPS,
                     grad_compression=True)
    step = jax.jit(jmake_train_step(JModel(jax_config(arch)), opt))
    state = JTrainState(params, jinit_opt_state(params, compression=True))
    data = JSyntheticLM(cfg.vocab_size, ranks.STEP_SEQ, ranks.STEP_BATCH,
                        seed=0)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    for i in range(ranks.STEPS):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in data.batch(i).items()})
        for _, meta in res:
            assert abs(meta["losses"][i] / float(metrics["loss"]) - 1) \
                <= STEP_TOL, i
        for path, w in jax.tree_util.tree_flatten_with_path(
                state.params)[0]:
            name = jax.tree_util.keystr(path)
            got = assemble(res, f"step{i}{name}", pspecs[name], shape,
                           w.shape)
            within_but_flips(got, np.asarray(w), opt.lr, (i, name))
    for path, w in jax.tree_util.tree_flatten_with_path(state.opt.err)[0]:
        name = jax.tree_util.keystr(path)
        w = np.asarray(w)
        got = assemble(res, f"err{name}", zspecs[name], shape, w.shape)
        within_but_flips(got, w, 4 * np.abs(w).max() + STEP_TOL, name)
    for _, meta in res:
        for rec in meta["records"]:
            scale = [r for r in rec if r[0] == "grads/compress-scale"]
            assert scale == [["grads/compress-scale", "AllReduce",
                              4.0 * n_leaves, len(res)]]
