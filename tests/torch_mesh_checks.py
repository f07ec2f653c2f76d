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
  family's layers (:func:`declaration_corrections`, ROADMAP C.11-C.14),
  and the port's own (:func:`port_own_schedule`), nothing else.
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
# the forward collectives a remat recompute may repeat
RECOMPUTED = {"tp/attn-out", "tp/ffn-out", "tp/q-gather", "tp/kv-gather",
              "tp/ssm-gather", "tp/ssm-norm", "tp/ssm-out", "moe/combine",
              "moe/shared-out"}


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


def _trimmed(spec) -> tuple:
    """A ``PartitionSpec`` as a tuple, trailing Nones dropped (the form of
    the port's ``partition_spec``)."""
    t = list(spec)
    while t and t[-1] is None:
        t.pop()
    return tuple(t)


def jax_specs(arch, shape, zero1=False):
    """Each parameter's JAX ``PartitionSpec`` on the mesh, by name, as a
    tuple without trailing Nones."""
    jm = JModel(jax_config(arch))
    rule = jsh.zero1_shardings if zero1 else jsh.param_shardings
    tree = rule(jm.param_axes(), jm.abstract_params(),
                AbstractMesh(shape, AXES))
    return {jax.tree_util.keystr(p): _trimmed(v.spec) for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))[0]}


def block_index(spec, coord, shape, full_shape):
    """The slices of the block of a tensor of ``full_shape`` that the rank
    at ``coord`` holds under a JAX ``PartitionSpec``."""
    sizes = dict(zip(AXES, shape))
    at = dict(zip(AXES, coord))
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
    steps, _ = jax_steps(arch)
    for _, meta in res:
        assert not any(meta["drops"])       # nothing drops: see overrides
    ssd = ranks.case_config(arch).has_ssm
    b1 = JOptConfig().betas[0]
    specs, zspecs = jax_specs(arch, shape), jax_specs(arch, shape, True)
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


def port_own_schedule(arch, shape, planner):
    """The port's own collectives of one step, {(label, type, dv_bytes,
    participants): count}, participants > 1 only: the embedding's
    All-Reduce, the q and kv projections' All-Gathers and their
    Reduce-Scatters where a head is split, the q/k-norm scales'
    cotangents, the SSM mixer's (its in_proj and conv outputs' gathers and
    their transposes, the norm's sum and its transpose, *f* and *g*, the
    per-head leaves' cotangents), MLA's latents' cotangent, the shared
    experts' *f* and *g*, the encoder output's cotangent under the
    cross-attention, the plain loss's unembed gather and mean, the norm's
    model-axis sum, and ZeRO-1's All-Gather of each data-sliced
    parameter."""
    cfg = jax_config(arch)
    ndata, m = shape
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    act = ranks.STEP_BATCH // ndata * ranks.STEP_SEQ
    own = collections.Counter()
    if m > 1:
        own[("tp/embed", "AllReduce", act * D * 4.0, m)] += 1
        own[("grads/norm", "AllReduce", 4.0, m)] += 1
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
            own[("tp/ssm-out", "AllReduce", act * D * 4.0, m)] += 2 * L
            own[("tp/ssm-param-grad", "AllReduce", 3 * nh * 4.0, m)] += L
        if cfg.attn_type == "mla":
            lat = cfg.q_lora_rank + cfg.kv_lora_rank + cfg.rope_head_dim
            own[("tp/mla-latent", "AllReduce", act * lat * 4.0, m)] += L
        if cfg.n_shared_experts:
            own[("moe/shared-out", "AllReduce", act * D * 4.0, m)] += \
                2 * (L - cfg.first_dense_layers)
        if cfg.is_encdec:
            frames = act // ranks.STEP_SEQ * max(
                1, ranks.STEP_SEQ // cfg.enc_ratio)
            own[("tp/cross-kv", "AllReduce", frames * D * 4.0, m)] += 1
        if not planner:
            own[("tp/unembed-gather", "AllGather",
                 D * cfg.padded_vocab * 4.0, m)] += 1
    if ndata > 1:
        if not planner:
            own[("loss/mean", "AllReduce", 4.0, ndata)] += 2
        specs, zspecs = jax_specs(arch, shape), jax_specs(arch, shape, True)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                JModel(cfg).abstract_params())[0]:
            name = jax.tree_util.keystr(path)
            if "data" in zspecs[name]:
                n = np.prod(leaf.shape) / m ** len(_model_shards(specs[name]))
                own[("zero1/params", "AllGather", n * 4.0, ndata)] += 1
    return own


def declaration_corrections(arch, shape):
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
    - C.14: the shared experts' gradients are All-Reduced over ``data``
      (``grads/...moe.shared_*``), which the declaration leaves out with
      the routed experts' (the keys under ``moe``)."""
    cfg = jax_config(arch)
    ndata, m = shape
    if m == 1:
        return {}
    L = cfg.n_layers
    act = ranks.STEP_BATCH // ndata * ranks.STEP_SEQ * cfg.d_model * 4.0
    out = {}

    def fix(item, label, count, dv=act, col_type="AllReduce", P=m):
        if count:
            out.setdefault(item, collections.Counter())[
                (label, col_type, dv, P)] += count
    n_moe = L - cfg.first_dense_layers if cfg.is_moe else 0
    if cfg.has_ssm:
        fix("C.11", "tp/attn-out", -2 * L * (not cfg.has_attention))
        fix("C.11", "tp/ffn-out", -2 * (L - n_moe) * (cfg.d_ff == 0))
    if cfg.is_encdec:
        enc = act // ranks.STEP_SEQ * max(1, ranks.STEP_SEQ // cfg.enc_ratio)
        fix("C.12", "tp/attn-out", 2 * cfg.n_enc_layers, enc)
        fix("C.12", "tp/ffn-out", 2 * cfg.n_enc_layers, enc)
        fix("C.12", "tp/attn-out", 2 * L)
    if cfg.attn_type == "mla":
        fix("C.13", "tp/attn-out", -L)
    if cfg.n_shared_experts and n_moe and ndata > 1:
        specs = jax_specs(arch, shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                JModel(cfg).abstract_params())[0]:
            keys = [k.key for k in path]
            if "moe" in keys and keys[-1].startswith("shared_"):
                name = jax.tree_util.keystr(path)
                n = np.prod(leaf.shape) / m ** len(_model_shards(specs[name]))
                fix("C.14", "grads/" + ".".join(keys), 1, n * 4.0,
                    P=ndata)
    return out


def check_collectives(res, arch, shape, variant):
    """Every rank's collectives of each step outside the recompute against
    the declared schedule (participants > 1; a ``grads/...`` entry sized
    by the declaration as the whole leaf, which the port all-reduces in
    its ``model`` shards: the declared bytes divided by the leaf's shards)
    with :func:`declaration_corrections` applied, plus
    :func:`port_own_schedule`; the recompute's only forward ones."""
    cfg = jax_config(arch)
    planner = variant != "plain" and not cfg.tie_embeddings \
        and not cfg.is_encdec
    jcfg = cfg.with_(softmax_strategy=variant if planner else "auto")
    specs = jax_specs(arch, shape)
    m = shape[1]
    want = collections.Counter()
    for d in jcp.train_collective_schedule(
            jcfg, AbstractMesh(shape, AXES), ranks.STEP_BATCH,
            ranks.STEP_SEQ, planner_loss=planner,
            params=JModel(jcfg).abstract_params()):
        if d.participants <= 1:
            continue
        dv = d.dv_bytes
        if d.label.startswith("grads/"):
            name = "".join(f"['{k}']" for k in d.label[6:].split("."))
            dv /= m ** len(_model_shards(specs[name]))
        want[(d.label, d.col_type, dv, d.participants)] += d.count
    for fixes in declaration_corrections(arch, shape).values():
        for key, n in fixes.items():
            want[key] += n
    want.update(port_own_schedule(arch, shape, planner))
    assert min(want.values()) >= 0
    want = {k: n for k, n in want.items() if n}
    assert any(k[0].startswith("tp/") for k in want) == (m > 1)
    for _, meta in res:
        for rec, again in zip(meta["records"], meta["recompute"]):
            got = collections.Counter(tuple(r) for r in rec if r[3] > 1)
            assert dict(got) == want, {
                k: (got.get(k, 0), want.get(k, 0))
                for k in set(got) | set(want) if got.get(k) != want.get(k)}
            assert {r[0] for r in again} <= RECOMPUTED
