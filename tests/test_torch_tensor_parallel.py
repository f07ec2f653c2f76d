"""The port's tensor- and expert-parallel mesh train step with ZeRO-1
moments against the JAX package on the CPU.

Two steps of ``make_train_step`` on gloo meshes (the ranks run in
``tests/torch_mesh_ranks.py``'s ``tp`` suite, by spawn, world 2 and world
4 side by side in two subprocesses with a timeout; nothing here forks or
starts a pool), f32 smoke configs, the batches of ``SyntheticLM`` seed 0,
under the planner loss's two strategies and the plain loss:

- glm4-9b (GQA, 4 q heads over 2 kv heads of 16) on (1, 2) and (1, 4):
  on (1, 4) a rank's kv columns are half a kv head, so the k and v
  projections are gathered (``tp/kv-gather``);
- qwen3-moe-30b-a3b (q/k-norm, 8 experts top-2) on (2, 2) and (1, 4):
  tensor-parallel attention, expert-parallel MoE layers.  Its config runs
  at capacity factor E / k (``torch_mesh_ranks.case_overrides``): the mesh
  step's capacity is each data rank's (32 tokens), the JAX mesh-free
  step's that of the whole batch (64 tokens, where the smoke capacity of
  32 drops 3 to 7 assignments a layer), and the two steps agree only
  where nothing drops; the ranks count the drops and the check asserts
  none.
- one qwen3-moe layer on (2, 2) at the smoke capacity factor, whose
  capacity binds: each data rank's 64 tokens (x in one direction, so
  that the router sends most to the same experts) get 32 slots an expert
  where the whole batch's 128 would get 40.  Forward and backward, each
  data rank's output and x cotangent are the JAX package's mesh-free
  ``moe_apply`` on its rows (whose capacity is then that of the rank's
  tokens, as ``shard_map``'s ``_cap(t_local)``), and the router and
  expert gradients the sums of the JAX ones over the data ranks, within
  1e-5 of the largest; tokens drop, and the whole batch's capacity would
  give another output.

``torch_mesh_checks`` holds the checks: losses and the gathered parameters
and moments within 1e-5 of the JAX package's mesh-free step (f32 sums in
another order over the ranks), every shard placed as the JAX
``PartitionSpec`` says and the replicas bit-equal, and every collective
outside the remat recompute either one of ``train_collective_schedule``'s
``participants > 1`` entries (``tp/`` and ``moe/`` included) or one of
the port's own, which the test names and counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks
from repro.configs import get_smoke_config as jget_smoke
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention, transformer
from repro_torch.parallel import collective_planner as cp

CASES = [(world, arch, shape, variant)
         for world, cases in ranks.TP_CASES.items()
         for arch, shape in cases for variant, _, _ in ranks.VARIANTS]
IDS = [f"{arch}-{ranks.tag_of(shape)}-{v}" for _, arch, shape, v in CASES]


@pytest.fixture(scope="module")
def tp_out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, tuple(ranks.TP_CASES), "tp")


def _results(tp_out, world, arch, shape, variant):
    return ranks.load(tp_out[world],
                      f"tp_{arch}_{ranks.tag_of(shape)}_{variant}", world)


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_tp_train_step_matches_jax(tp_out, world, arch, shape, variant):
    checks.check_train_matches_jax(
        _results(tp_out, world, arch, shape, variant), arch, shape)


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_tp_collectives_equal_the_declared(tp_out, world, arch, shape,
                                           variant):
    res = _results(tp_out, world, arch, shape, variant)
    checks.check_collectives(res, arch, shape, variant)
    labels = {r[0] for _, meta in res for rec in meta["records"]
              for r in rec}
    # the split kv head's gather, only where a rank holds part of one
    assert ("tp/kv-gather" in labels) == (
        get_smoke_config(arch).n_kv_heads % shape[1] != 0)
    if get_smoke_config(arch).is_moe:
        assert {"moe/combine", "moe/router-grad"} <= labels
    # the remat recompute repeats the attention's forward reduction
    assert all("tp/attn-out" in {r[0] for r in again}
               for _, meta in res for again in meta["recompute"])


def test_moe_capacity_is_each_data_ranks(tp_out):
    res = ranks.load(tp_out[4], "moe_capacity", 4)
    _, p, x, cot = ranks.moe_layer_inputs()
    jcfg = jget_smoke(ranks.MOE_ARCH).with_(dtype="float32")
    jp = {k: jnp.asarray(v[0]) for k, v in p.items()}
    ndata, m = 2, 2
    rows = ranks.MOE_B // ndata
    outs, gxs, gps = [], [], []
    for d in range(ndata):
        xs = jnp.asarray(x[d * rows:(d + 1) * rows])
        out, vjp = jax.vjp(lambda q, v: jmoe.moe_apply(jcfg, q, v), jp, xs)
        gp, gx = vjp(jnp.asarray(cot[d * rows:(d + 1) * rows]))
        outs.append(np.asarray(out))
        gxs.append(np.asarray(gx))
        gps.append({k: np.asarray(v) for k, v in gp.items()})
    gp_sum = {k: sum(g[k] for g in gps) for k in gps[0]}

    def close(got, want, what):
        tol = checks.STEP_TOL * max(1.0, np.abs(want).max())
        assert np.abs(got - want).max() <= tol, what

    e_local = jcfg.n_experts // m
    for arr, meta in res:
        d, r = meta["coord"]
        assert meta["capacity"] == 32 and sum(meta["drops"]) > 0
        close(arr["out"], outs[d], "out")
        close(arr["gx"], gxs[d], "gx")
        close(arr["g_router"], gp_sum["router"], "router")
        for k in ("wi", "wg", "wo"):
            close(arr[f"g_{k}"], gp_sum[k][r * e_local:(r + 1) * e_local], k)
        labels = {rec[0] for rec in meta["records"]}
        assert {"moe/combine", "moe/router-grad", "moe/expert-grad"} <= labels
    # the whole batch's capacity (40) gives another output
    whole = np.asarray(jmoe.moe_apply(jcfg, jp, jnp.asarray(x)))
    assert np.abs(whole - np.concatenate(outs)).max() > 1e-3


@pytest.mark.parametrize("H,Hkv,h0,n,want", [
    (4, 2, 0, 2, slice(0, 1)), (4, 2, 2, 2, slice(1, 2)),
    (8, 2, 0, 8, slice(0, 2)), (4, 2, 3, 1, slice(1, 2)),
    (32, 2, 16, 8, slice(1, 2)), (32, 4, 8, 16, slice(1, 3))])
def test_kv_heads_of_a_ranks_q_heads(H, Hkv, h0, n, want):
    assert attention._kv_heads(H, Hkv, h0, n) == want


def test_kv_heads_of_an_uneven_group():
    # 12 q heads over 4 kv heads on 3 ranks: rank 1's q heads 4..7 read
    # kv heads 1, 1, 2, 2
    got = attention._kv_heads(12, 4, 4, 4)
    assert got.tolist() == [1, 1, 2, 2]


class _Mesh:
    """The mesh attributes the model layers read, of rank 0 on a (1, m)
    ``(data, model)`` mesh; no process group."""

    def __init__(self, m):
        self.mesh_dim_names, self.shape = ("data", "model"), (1, m)

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("knob", [{"seq_shard": True},
                                  {"tensor_parallel": False}])
def test_check_mesh_refuses_the_knobs_not_ported(knob):
    """No knob is refused on a model axis any more (the 2- and 4-rank
    cases: tests/test_torch_seq_shard.py, test_torch_tp_off.py).  On the
    one-rank gloo mesh each knob's step gives the loss and the parameters
    of the step without it, ``seq_shard`` through the rows' gathers and
    scatters; on a (2, 2) mesh the state is placed as the JAX package
    places it with the knob; and the sequence splits where the JAX
    residual spec splits it."""
    from repro_torch.models.model import Model
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.checkpoint import flatten_with_names
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              state_placements)
    base = get_smoke_config("glm4-9b").with_(dtype="float32")
    cfg = base.with_(**knob)
    batch = ranks._batches(base)[0]
    mesh = tmesh.make_host_mesh(device="cpu")
    try:
        out = {}
        for c in (base, cfg):
            model = Model(c)
            state = init_train_state(model, model.init(0, device="cpu"),
                                     mesh)
            step = make_train_step(model, OptConfig(), mesh,
                                   use_planner_loss=True)
            with cp.record_collectives() as rec:
                state, metrics = step(state, batch)
            out[c.seq_shard, c.tensor_parallel] = (
                float(metrics["loss"]), dict(flatten_with_names(
                    state.params)), {(r[0], r[1]) for r in rec})
    finally:
        tmesh.destroy()
    (loss0, p0, rec0), (loss1, p1, rec1) = out.values()
    assert loss1 == loss0
    for name, t in p0.items():
        torch.testing.assert_close(p1[name], t, rtol=0, atol=1e-7,
                                   msg=name)
    seq_labels = {("tp/seq-gather", "AllGather"),
                  ("tp/seq-gather", "ReduceScatter"),
                  ("tp/attn-out", "ReduceScatter"),
                  ("tp/embed", "ReduceScatter")}
    assert (seq_labels <= rec1) == cfg.seq_shard
    assert not seq_labels & rec0
    arch = "glm4-9b" + ("+seq" if cfg.seq_shard else "+tpoff")
    mesh22 = sh.MeshShape((2, 2), checks.AXES)
    placed = state_placements(Model(cfg), mesh22)
    for tree, zero1 in ((placed.params, False), (placed.opt.m, True)):
        got = {k: sh.partition_spec(v, mesh22)
               for k, v in flatten_with_names(tree)}
        assert got == checks.jax_specs(arch, (2, 2), zero1)
    split = {(shape, S): transformer.splits_sequence(cfg, sh.MeshShape(
        shape, ranks.mesh_axes_of(shape)), S)
        for shape in ((1, 2), (2, 2, 4)) for S in (16, 1)}
    assert split == {(s, S): cfg.seq_shard and S == 16 for s, S in split}
    assert not transformer.splits_sequence(
        get_smoke_config("seamless-m4t-medium").with_(**knob),
        sh.MeshShape((1, 2), checks.AXES), 16)


def test_recompute_is_recorded_apart():
    """On a one-rank gloo mesh: a checkpointed layer's recompute issues its
    forward collectives again, into ``.recompute``; without remat there is
    none."""
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.long),
             "labels": torch.ones(2, 8, dtype=torch.long)}
    mesh = tmesh.make_host_mesh(device="cpu")
    try:
        for remat in (True, False):
            cfg = get_smoke_config("glm4-9b").with_(dtype="float32",
                                                    remat=remat)
            model = Model(cfg)
            state = init_train_state(model, model.init(0, device="cpu"),
                                     mesh)
            step = make_train_step(model, OptConfig(), mesh)
            with cp.record_collectives() as rec:
                step(state, batch)
            assert {r[0] for r in rec} >= {"tp/attn-out", "tp/ffn-out",
                                           "tp/embed", "tp/unembed-gather",
                                           "grads/norm", "loss/mean"}
            again = [r[0] for r in rec.recompute]
            assert again == (["tp/attn-out"] * cfg.n_layers if remat
                             else [])
    finally:
        tmesh.destroy()


def test_production_mesh_needs_its_world():
    try:
        for multi, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks"):
                tmesh.make_production_mesh(multi_pod=multi, device="cpu")
    finally:
        tmesh.destroy()
