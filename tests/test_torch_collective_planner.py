"""The port's collective planner, int8 all-reduce and mesh train step
against the JAX package on the CPU.

- ``softmax_collective_schedule``, ``plan_softmax_strategy``,
  ``price_collective_schedule`` and ``train_collective_schedule``: equal to
  the JAX package's, entry for entry (bit for bit: the same f64 cost
  model on the same presets).
- ``sharded_softmax_xent`` on gloo meshes of (1, 2), (2, 2) and (1, 4)
  ranks, both strategies, a real vocab of 500 in a padded 512 (no shard
  width divides it): the loss and the gradients of h and the unembed
  against JAX's unsharded ``cross_entropy_loss`` and ``jax.grad``, in f32
  within 1e-5 (relative for the loss; of the largest |gradient| for the
  gradients): the same f32 math, the logsumexp summed in shards.  The
  collectives it emits: in the forward pass exactly
  ``softmax_collective_schedule``'s, forward and backward together
  exactly the loss's entries of ``train_collective_schedule``.
- ``compressed_psum``: within 2.5 x absmax / 127 of the exact sum, the bar
  of tests/test_distributed.py (int8 rounding: half a step a replica).
- Two steps of the tensor-parallel, ZeRO-1 mesh train step on a (2, 2)
  gloo mesh (glm4's smoke config, f32), the planner loss under both
  strategies and the plain loss: ``torch_mesh_checks``' checks, the
  losses and the gathered parameters and moments within 1e-5 of the JAX
  package's mesh-free ``make_train_step``, each rank's shards placed as
  the JAX ``PartitionSpec``s say, and its collectives outside the remat
  recompute ``train_collective_schedule``'s, ``tp/`` entries included,
  beside the port's own (tests/test_torch_tensor_parallel.py runs the
  other meshes and qwen3-moe).

The ranks run in ``tests/torch_mesh_ranks.py``, started with ``spawn`` in
two subprocesses with a timeout; nothing here forks or starts a pool.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro.models.layers import cross_entropy_loss as jcross_entropy_loss
from repro.parallel import collective_planner as jcp
from repro_torch.configs.registry import get_smoke_config
from repro_torch.parallel import collective_planner as cp
from repro_torch.parallel.sharding import MeshShape

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks

XENT_TOL = 1e-5


# ------------------------------------------------------------ the schedules

GRID = [(rows, cols, P, dp) for rows in (1, 128, 4096, 65536)
        for cols in (4096, 129280, 151552) for P in (1, 2, 4, 16)
        for dp in (1, 2, 16)]


@pytest.mark.parametrize("strategy", ["dist", "gather"])
def test_softmax_schedule_matches_jax(strategy):
    for rows, cols, P, dp in GRID:
        assert cp.softmax_collective_schedule(
            strategy, rows, cols, P, dp_participants=dp) == \
            jcp.softmax_collective_schedule(strategy, rows, cols, P,
                                            dp_participants=dp)


def test_plan_softmax_strategy_matches_jax():
    picks = collections.Counter()
    for rows, cols, P, _ in GRID:
        got = cp.plan_softmax_strategy(rows, cols, P)
        assert got == jcp.plan_softmax_strategy(rows, cols, P), (rows, cols,
                                                                 P)
        picks[got] += 1
    assert set(picks) == {"dist", "gather"}      # the grid reaches both


@pytest.mark.parametrize("strategy", ["dist", "gather"])
def test_price_matches_jax(strategy):
    for rows, cols, P, dp in GRID:
        sched = [cp.DeclaredCollective(f"c{i}", t, dv, p, n)
                 for i, (t, dv, p, n) in enumerate(
                     cp.softmax_collective_schedule(strategy, rows, cols, P,
                                                    dp_participants=dp))]
        jsched = [jcp.DeclaredCollective(d.label, d.col_type, d.dv_bytes,
                                         d.participants, d.count)
                  for d in sched]
        assert cp.price_collective_schedule(sched) == \
            jcp.price_collective_schedule(jsched)


def _dicts(schedule):
    return [d.to_dict() for d in schedule]


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen3-moe-30b-a3b",
                                  "mamba2-130m"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("strategy", ["auto", "dist", "gather"])
def test_train_collective_schedule_matches_jax(arch, shape, strategy):
    cfg = get_smoke_config(arch).with_(softmax_strategy=strategy)
    jcfg = jget_smoke(arch).with_(softmax_strategy=strategy)
    mesh = MeshShape(shape, ("data", "model"))
    jmesh = AbstractMesh(shape, ("data", "model"))
    for mb, planner in ((1, True), (2, True), (1, False)):
        got = cp.train_collective_schedule(cfg, mesh, 8, 64, microbatches=mb,
                                           planner_loss=planner)
        want = jcp.train_collective_schedule(
            jcfg, jmesh, 8, 64, microbatches=mb, planner_loss=planner,
            params=JModel(jcfg).abstract_params())
        assert _dicts(got) == _dicts(want)
        assert cp.price_collective_schedule(got) == \
            jcp.price_collective_schedule(want)


# ------------------------------------------------------------- the ranks


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Run the gloo ranks of torch_mesh_ranks.py (2 and 4 of them, side by
    side); the directory of each world's output."""
    return ranks.run_worlds(tmp_path_factory, (2, 4), "planner")


_load = ranks.load


XENT_CASES = [((1, 2), "dist"), ((1, 2), "gather"), ((2, 2), "dist"),
              ((2, 2), "gather"), ((1, 4), "dist"), ((1, 4), "gather")]


def _jax_xent(Vp):
    h, w, y = ranks.xent_inputs(Vp)

    def f(h, w):
        return jcross_entropy_loss(h @ w, jnp.asarray(y), ranks.VOCAB)
    loss, (gh, gw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(h),
                                                          jnp.asarray(w))
    return float(loss), np.asarray(gh), np.asarray(gw)


def _xent_results(ranks_out, shape, strategy):
    world = shape[0] * shape[1]
    tag = f"{shape[0]}x{shape[1]}"
    return _load(ranks_out[world], f"xent_{tag}_{strategy}", world)


@pytest.mark.parametrize("shape,strategy", XENT_CASES)
def test_sharded_softmax_xent_matches_jax(ranks_out, shape, strategy):
    res = _xent_results(ranks_out, shape, strategy)
    Vp = res[0][1]["Vp"]
    want_loss, want_gh, want_gw = _jax_xent(Vp)
    ndata, nmodel = shape
    by = {tuple(meta["coord"]): arr for arr, meta in res}
    for arr in by.values():
        assert abs(float(arr["loss"]) / want_loss - 1) <= XENT_TOL
    gh = np.concatenate([by[(d, 0)]["gh"] for d in range(ndata)], axis=0)
    gw = np.concatenate([by[(0, m)]["gw"] for m in range(nmodel)], axis=1)
    assert np.abs(gh - want_gh).max() <= XENT_TOL * np.abs(want_gh).max()
    assert np.abs(gw - want_gw).max() <= XENT_TOL * np.abs(want_gw).max()
    # replicas agree: h over model, the unembed over data
    for (d, m), arr in by.items():
        np.testing.assert_array_equal(arr["gh"], by[(d, 0)]["gh"])
        np.testing.assert_array_equal(arr["gw"], by[(0, m)]["gw"])
    # the padded columns take no probability: their gradient is 0
    assert np.abs(gw[:, ranks.VOCAB:]).max() == 0.0


def _count(records, min_participants=2):
    return collections.Counter(
        (tuple(r[1:]) for r in records if r[3] >= min_participants))


@pytest.mark.parametrize("shape,strategy", XENT_CASES)
def test_emitted_collectives_equal_the_declared_schedule(ranks_out, shape,
                                                        strategy):
    res = _xent_results(ranks_out, shape, strategy)
    ndata, nmodel = shape
    Vp = res[0][1]["Vp"]
    rows = ranks.B // ndata * ranks.S
    declared = collections.Counter()
    for t, dv, p, n in jcp.softmax_collective_schedule(
            strategy, rows, Vp, nmodel, dp_participants=ndata):
        declared[(t, dv, p)] += n
    cfg = jget_smoke("glm4-9b").with_(vocab_size=ranks.VOCAB,
                                      dtype="float32",
                                      softmax_strategy=strategy)
    train = {(d.label, d.col_type, d.dv_bytes, d.participants): d.count
             for d in jcp.train_collective_schedule(
                 cfg, AbstractMesh(shape, ("data", "model")), ranks.B,
                 ranks.S, params={})
             if d.label.startswith("xent/") and d.participants > 1}
    for arr, meta in res:
        assert _count(meta["fwd"]) == declared
        both = collections.Counter(
            tuple(r) for r in meta["fwd"] + meta["bwd"] if r[3] > 1)
        assert dict(both) == train
        # every collective of the loss ran, participants-1 ones included
        assert {r[0] for r in meta["fwd"] + meta["bwd"]} >= (
            {"xent/stats"} if strategy == "dist"
            else {"xent/logit-gather", "xent/logit-gather-grad"})


@pytest.mark.parametrize("shape,strategy", XENT_CASES)
def test_timed_collectives_keep_their_records(ranks_out, shape, strategy):
    # the loss's backward ran under record_collectives(timed=True): the
    # records above, each with its host-clock time on the CPU
    for _, meta in _xent_results(ranks_out, shape, strategy):
        assert [r for r, _ in meta["bwd_times"]] == meta["bwd"]
        assert meta["bwd"] and all(ms >= 0 for _, ms in meta["bwd_times"])


@pytest.mark.parametrize("tag,axes", [("2x2", {"data": 2, "model": 2}),
                                      ("1x4", {"data": 1, "model": 4})])
def test_compressed_psum(ranks_out, tag, axes):
    res = _load(ranks_out[4], f"compressed_{tag}", 4)
    for axis, n in axes.items():
        i = list(axes).index(axis)
        for arr, meta in res:
            g = arr["g"]
            tol = 2.5 * np.abs(g).max() / 127.0
            np.testing.assert_allclose(arr[f"same_{axis}"], g * n, atol=tol)
            group = [a for a, m in res
                     if all(m["coord"][j] == meta["coord"][j]
                            for j in range(2) if j != i)]
            exact = sum(a["x"] for a in group)
            amax = max(np.abs(a["x"]).max() for a in group)
            assert np.abs(arr[f"mine_{axis}"] - exact).max() \
                <= 0.5 * n * amax / 127.0 * (1 + 1e-6)


@pytest.mark.parametrize("variant", ["dist", "gather", "plain"])
def test_mesh_train_step_matches_jax(ranks_out, variant):
    checks.check_train_matches_jax(_load(ranks_out[4], f"train_{variant}", 4),
                                   "glm4-9b", (2, 2))


@pytest.mark.parametrize("variant", ["dist", "gather", "plain"])
def test_mesh_train_step_collectives_equal_the_declared(ranks_out, variant):
    # tp/ and moe/ included: the step is tensor-parallel on (2, 2)
    checks.check_collectives(_load(ranks_out[4], f"train_{variant}", 4),
                             "glm4-9b", (2, 2), variant)


def test_one_rank_group_issues_no_call_and_records(monkeypatch):
    """On a one-rank gloo group every collective is the identity: a copy,
    no call to the backend (each call raises here), and its record all the
    same, so that the audits count what they counted."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as tmesh

    def refuse(*_, **__):
        raise AssertionError("a one-rank group called the backend")
    mesh = tmesh.make_host_mesh(device="cpu")
    try:
        for fn in ("all_reduce", "all_gather", "reduce_scatter"):
            monkeypatch.setattr(dist, fn, refuse)
        group = mesh.get_group("model")
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
        with cp.record_collectives() as rec:
            outs = [cp.collective(t, t.lower(), x, group, dim=0)
                    for t in ("AllReduce", "AllGather", "ReduceScatter")]
        for out in outs:
            assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
        assert list(rec) == [(t.lower(), t, 24.0, 1)
                             for t in ("AllReduce", "AllGather",
                                       "ReduceScatter")]
    finally:
        tmesh.destroy()
