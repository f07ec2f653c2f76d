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
  replicas agree bit for bit.
- :func:`check_collectives`: the collectives each rank issues outside the
  remat recompute are ``train_collective_schedule``'s entries with
  ``participants > 1`` and the port's own (:func:`port_own_schedule`),
  nothing else.
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
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import Model

import torch_mesh_ranks as ranks

# f32 sums over the ranks in another order than one device's, and AdamW's
# update of a few 1e-4 a step
STEP_TOL = 1e-5
AXES = ("data", "model")
# the port's own collectives beside the declared schedule: GSPMD's in the
# JAX package, where the declaration leaves them out
PORT_OWN = {"grads/norm", "loss/mean", "tp/embed", "tp/kv-gather",
            "tp/unembed-gather", "tp/qk-norm-grad", "zero1/params"}
# the forward collectives a remat recompute may repeat
RECOMPUTED = {"tp/attn-out", "tp/ffn-out", "tp/kv-gather", "moe/combine"}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def jax_steps(arch):
    """[(loss, params by name, first moments by name)] after each step."""
    from repro.train.data import SyntheticLM as JSyntheticLM
    cfg = get_smoke_config(arch).with_(**ranks.overrides(arch))
    p0 = Model(cfg).init(0, device="cpu")

    def to_jax(t):
        return {k: to_jax(v) for k, v in t.items()} if isinstance(t, dict) \
            else jnp.asarray(t.numpy())
    params = to_jax(p0)
    jcfg = jget_smoke(arch).with_(**ranks.overrides(arch))
    step = jax.jit(jmake_train_step(
        JModel(jcfg), JOptConfig(warmup_steps=1, total_steps=ranks.STEPS)))
    state = JTrainState(params, jinit_opt_state(params))
    data = JSyntheticLM(cfg.vocab_size, ranks.STEP_SEQ, ranks.STEP_BATCH,
                        seed=0)
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
    jm = JModel(jget_smoke(arch))
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


def check_train_matches_jax(res, arch, shape):
    steps, _ = jax_steps(arch)
    for _, meta in res:
        assert not any(meta["drops"])       # nothing drops: see overrides
    specs, zspecs = jax_specs(arch, shape), jax_specs(arch, shape, True)
    for i, (want_loss, want, want_m) in enumerate(steps):
        for _, meta in res:
            assert abs(meta["losses"][i] / want_loss - 1) <= STEP_TOL
        for name, w in want.items():
            got = assemble(res, f"step{i}{name}", specs[name], shape,
                           w.shape)
            assert np.abs(got - w).max() <= STEP_TOL, (i, name)
    for name, w in want_m.items():
        got = assemble(res, f"m{name}", zspecs[name], shape, w.shape)
        assert np.abs(got - w).max() <= STEP_TOL, name


def _model_shards(spec):
    return [e for e in spec if e is not None]


def port_own_schedule(arch, shape, planner):
    """The port's own collectives of one step, {(label, type, dv_bytes,
    participants): count}, participants > 1 only: the embedding's
    All-Reduce, the kv projections' All-Gathers and their Reduce-Scatters
    where a kv head is split, the q/k-norm scales' cotangents, the plain
    loss's unembed gather and mean, the norm's model-axis sum, and ZeRO-1's
    All-Gather of each data-sliced parameter."""
    cfg = jget_smoke(arch)
    ndata, m = shape
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    act = ranks.STEP_BATCH // ndata * ranks.STEP_SEQ
    own = collections.Counter()
    if m > 1:
        own[("tp/embed", "AllReduce", act * D * 4.0, m)] += 1
        own[("grads/norm", "AllReduce", 4.0, m)] += 1
        if cfg.n_kv_heads % m:
            kv = act * cfg.n_kv_heads * hd * 4.0
            own[("tp/kv-gather", "AllGather", kv, m)] += 2 * L
            own[("tp/kv-gather", "ReduceScatter", kv, m)] += 2 * L
        if cfg.qk_norm:
            own[("tp/qk-norm-grad", "AllReduce", hd * 4.0, m)] += 2 * L
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


def check_collectives(res, arch, shape, variant):
    """Every rank's collectives of each step outside the recompute against
    the declared schedule (participants > 1; a ``grads/...`` entry sized
    by the declaration as the whole leaf, which the port all-reduces in
    its ``model`` shards: the declared bytes divided by the leaf's shards)
    plus :func:`port_own_schedule`; the recompute's only forward ones."""
    planner = variant != "plain"
    jcfg = jget_smoke(arch).with_(
        softmax_strategy=variant if planner else "auto",
        **ranks.overrides(arch))
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
    want.update(port_own_schedule(arch, shape, planner))
    assert any(k[0].startswith("tp/") for k in want) == (m > 1)
    for _, meta in res:
        for rec, again in zip(meta["records"], meta["recompute"]):
            got = collections.Counter(tuple(r) for r in rec if r[3] > 1)
            assert dict(got) == dict(want)
            assert {r[0] for r in again} <= RECOMPUTED
