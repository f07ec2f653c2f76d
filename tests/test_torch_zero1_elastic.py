"""ZeRO-1 placements, checkpoints on a mesh, elastic restore, ``remesh``,
``shrink_mesh`` and the int8-compressed mesh step against the JAX package
on the CPU.

The ranks run ``tests/torch_mesh_ranks.py``'s ``elastic`` suite (world
4, spawned in one subprocess with a timeout; nothing here forks or starts
a pool): two glm4 steps on (2, 2) (the plain loss, f32 smoke config),
their state checkpointed on the mesh and restored onto (1, 4), (4, 1) and
no mesh, written again by the async writer, resharded by ``remesh`` onto
(1, 4) and onto the mesh ``shrink_mesh`` leaves after losing one of four
ranks, and two int8-compressed steps on (2, 2).

- A checkpoint is bit for bit the gathered state, restores bit for bit on
  every mesh and with none, each rank holding exactly its block under the
  new mesh's JAX ``PartitionSpec``s (params by ``param_shardings``,
  moments by ``zero1_shardings``), and the JAX package's
  ``restore_checkpoint`` reads it bit for bit.
- ``shrink_mesh`` keeps the ``model`` width and the first whole
  replicas, as the JAX package's does.
- A checkpoint on a mesh gathers one leaf at a time: the whole leaves
  that its gathers hold at once are never more than the largest leaf.
- The compressed step: the error feedback placed by ``zero1_shardings``,
  the replicas bit-equal, each leaf's int8 scale from one MAX All-Reduce
  over the whole mesh (``grads/compress-scale``), both steps' losses the
  JAX step's within 1e-5, and the parameters and the error feedback the
  JAX compressed step's within 1e-5 but at rounding flips: an element
  whose int8 rounding flips between the two (the ranks' sums in another
  order move the value across a rounding boundary) moves Adam's update by
  up to lr and the error feedback by a quantum.  At most 0.1% of a leaf
  may flip (a few elements of 16384 do), each parameter outlier within lr
  and each error-feedback outlier within two quanta (four times the JAX
  step's largest residual, which is half a quantum).
"""
import jax
import numpy as np
import pytest

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks
from repro.train import checkpoint as jck
from repro.train import elastic as jelastic
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.parallel import sharding as sh
from repro_torch.train.checkpoint import flatten_with_names
from repro_torch.train.train_step import state_placements

ARCH = "glm4-9b"
WORLD = 4


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, (WORLD,), "elastic")[WORLD]


def _spec(name, shape):
    return checks.state_spec(ARCH, name, shape)


def test_checkpoint_is_the_gathered_state(out):
    saved = ranks.load(out, "ckpt_saved", WORLD)
    for arr, _ in saved[1:]:
        for name, a in arr.items():
            np.testing.assert_array_equal(a, saved[0][0][name])
    # what was written is the two JAX steps' state
    steps, _ = checks.jax_steps(ARCH)
    for name, w in steps[-1][1].items():
        assert np.abs(saved[0][0][".params" + name] - w).max() \
            <= checks.STEP_TOL


@pytest.mark.parametrize("shape", ranks.RESTORE_SHAPES,
                         ids=[ranks.tag_of(s) for s in ranks.RESTORE_SHAPES])
def test_checkpoint_restores_on_another_mesh_bit_for_bit(out, shape):
    saved = ranks.load(out, "ckpt_saved", WORLD)[0][0]
    res = ranks.load(out, f"ckpt_restored_{ranks.tag_of(shape)}", WORLD)
    for arr, meta in res:
        assert meta["step"] == ranks.STEPS and meta["extra"] == \
            {"mesh": [2, 2]}
        for name, whole in saved.items():
            np.testing.assert_array_equal(arr[name], whole, err_msg=name)
            block = whole[checks.block_index(_spec(name, shape),
                                             meta["coord"], shape,
                                             whole.shape)]
            np.testing.assert_array_equal(arr["local" + name], block,
                                          err_msg=name)


def test_checkpoint_restores_with_no_mesh_and_in_jax(out):
    saved = ranks.load(out, "ckpt_saved", WORLD)[0][0]
    for arr, meta in ranks.load(out, "ckpt_restored_none", WORLD):
        assert meta["step"] == ranks.STEPS
        assert arr.keys() == saved.keys()
        for name, whole in saved.items():
            np.testing.assert_array_equal(arr[name], whole, err_msg=name)
    _, like = checks.jax_steps(ARCH)
    for d in ("ckpt", "ckpt_async"):
        jstate, step, _ = jck.restore_checkpoint(str(out / d), like)
        assert step == ranks.STEPS
        flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert [jax.tree_util.keystr(p) for p, _ in flat] == list(saved)
        for path, leaf in flat:
            np.testing.assert_array_equal(
                np.asarray(leaf), saved[jax.tree_util.keystr(path)])
    assert all(not meta["errors"]
               for _, meta in ranks.load(out, "ckpt_async", WORLD))


def test_moments_are_placed_by_zero1_spec():
    """The state's placements on each mesh of the suite, as
    ``PartitionSpec``s, are the JAX package's ``param_shardings`` and
    ``zero1_shardings``."""
    model = Model(get_smoke_config(ARCH))
    for shape in ((2, 2),) + ranks.RESTORE_SHAPES:
        mesh = sh.MeshShape(shape, checks.AXES)
        placed = state_placements(model, mesh, compression=True)
        for tree, zero1 in ((placed.params, False), (placed.opt.m, True),
                            (placed.opt.err, True)):
            got = {k: sh.partition_spec(v, mesh)
                   for k, v in flatten_with_names(tree)}
            assert got == checks.jax_specs(ARCH, shape, zero1)


@pytest.mark.parametrize("case", ["ckpt_saved", "ckpt_async"])
def test_checkpoint_gathers_one_leaf_at_a_time(out, case):
    for _, meta in ranks.load(out, case, WORLD):
        g = meta["gathered"]
        assert 0 < g["peak"] <= g["largest"] < g["total"]


def test_remesh_reshards_onto_another_mesh(out):
    saved = ranks.load(out, "ckpt_saved", WORLD)[0][0]
    for arr, meta in ranks.load(out, "remesh_1x4", WORLD):
        for name, a in arr.items():
            whole = saved[".params" + name]
            np.testing.assert_array_equal(a, whole[checks.block_index(
                checks.jax_specs(ARCH, (1, 4))[name], meta["coord"], (1, 4),
                whole.shape)], err_msg=name)


def test_shrink_mesh_keeps_model_and_the_first_replicas(out):
    want = jelastic.shrink_mesh(1, model_parallel=2,
                                devices=list(range(WORLD)))
    saved = ranks.load(out, "ckpt_saved", WORLD)[0][0]
    res = ranks.load(out, "shrink", WORLD)
    for rank, (arr, meta) in enumerate(res):
        assert meta["ranks"] == want.devices.tolist()
        assert meta["names"] == list(want.axis_names)
        assert tuple(meta["shape"]) == tuple(want.devices.shape)
        kept = rank in want.devices.flatten().tolist()
        assert (meta["coord"] is not None) == kept and bool(arr) == kept
        shape = tuple(meta["shape"])
        for name, a in arr.items():
            whole = saved[".params" + name]
            np.testing.assert_array_equal(a, whole[checks.block_index(
                checks.jax_specs(ARCH, shape)[name], meta["coord"], shape,
                whole.shape)], err_msg=name)


def test_int8_compressed_mesh_step(out):
    checks.check_int8_step(ranks.load(out, "train_int8", WORLD), ARCH,
                           (2, 2))
