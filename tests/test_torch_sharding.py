"""The port's sharding rules against the JAX package's, on the CPU with no
process group: every parameter's placements (as a ``PartitionSpec``), its
ZeRO-1 placements, the batch's and every cache leaf's, for each smoke
config, on a (2, 4) ``(data, model)`` mesh shape and on a (2, 2, 2)
``(pod, data, model)`` one.  Exact equality: the same integer rules.
``local_shard`` is checked against numpy's blocks.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro.parallel import sharding as jsh
from repro_torch.configs.registry import _MODULES, get_smoke_config
from repro_torch.models.model import Model
from repro_torch.parallel import sharding as sh

ARCHS = sorted(_MODULES)
SHAPES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


def _meshes(shape, names):
    return sh.MeshShape(shape, names), AbstractMesh(shape, names)


def _spec(p) -> tuple:
    """A JAX PartitionSpec as a tuple, trailing Nones dropped."""
    t = list(p)
    while t and t[-1] is None:
        t.pop()
    return tuple(t)


def _by_path(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _by_path(tree[key], path + (key,)).items()}
    return {"".join(f"['{k}']" for k in path): tree}


def _jax_by_path(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))[0]}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape,names", SHAPES)
def test_param_placements_match_jax(arch, shape, names):
    mesh, jmesh = _meshes(shape, names)
    specs = Model(get_smoke_config(arch)).specs
    jm = JModel(jget_smoke(arch))
    got = {k: sh.partition_spec(v, mesh)
           for k, v in _by_path(sh.param_shardings(specs, mesh)).items()}
    want = {k: _spec(v.spec) for k, v in _jax_by_path(jsh.param_shardings(
        jm.param_axes(), jm.abstract_params(), jmesh)).items()}
    assert got == want
    z_got = {k: sh.partition_spec(v, mesh)
             for k, v in _by_path(sh.zero1_shardings(specs, mesh)).items()}
    z_want = {k: _spec(v.spec) for k, v in _jax_by_path(jsh.zero1_shardings(
        jm.param_axes(), jm.abstract_params(), jmesh)).items()}
    assert z_got == z_want
    # the rules shard something on these meshes
    assert any(v for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placements_match_jax(arch):
    mesh, jmesh = _meshes((2, 4), ("data", "model"))
    for batch in (2, 8):
        cache = Model(get_smoke_config(arch)).init_cache(batch, 32, "cpu")
        jcache = jax.eval_shape(
            lambda: JModel(jget_smoke(arch)).init_cache(batch, 32))
        got = {k: sh.partition_spec(v, mesh) for k, v in
               _by_path(sh.cache_shardings(cache, mesh, batch)).items()}
        want = {k: _spec(v.spec) for k, v in _jax_by_path(
            jsh.cache_shardings(jcache, jmesh, batch)).items()}
        assert got == want


@pytest.mark.parametrize("shape,names", SHAPES)
def test_batch_and_dp_match_jax(shape, names):
    mesh, jmesh = _meshes(shape, names)
    assert sh.dp_axes(mesh) == jsh.dp_axes(jmesh)
    assert sh.dp_size(mesh) == jsh.dp_size(jmesh)
    for batch in (1, 2, 3, 4, 8):
        assert sh.partition_spec(sh.batch_spec(mesh, batch), mesh) == \
            _spec(jsh.batch_spec(jmesh, batch))


def test_placements_form():
    mesh = sh.MeshShape((2, 4), ("data", "model"))
    assert sh.spec_for(("embed", "vocab"), (64, 512), mesh) == \
        (Replicate(), Shard(1))
    assert sh.spec_for(("embed", "vocab"), (64, 510), mesh) == \
        (Replicate(), Replicate())
    assert sh.partition_spec((Replicate(), Replicate()), mesh) == ()
    assert sh.LOGICAL_RULES == jsh.LOGICAL_RULES
    pod = sh.MeshShape((2, 2, 2), ("pod", "data", "model"))
    assert sh.batch_spec(pod, 8) == (Shard(0), Shard(0), Replicate())
    assert sh.partition_spec(sh.batch_spec(pod, 8), pod) == \
        _spec(P(("pod", "data")))


class _Coord(sh.MeshShape):
    """A mesh shape at one rank's coordinate."""
    coord = ()

    def get_coordinate(self):
        return self.coord


@pytest.mark.parametrize("coord", [(0, 0, 1), (1, 0, 0), (1, 1, 1)])
def test_local_shard_is_the_ranks_block(coord):
    mesh = _Coord((2, 2, 2), ("pod", "data", "model"))
    mesh.coord = coord
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    pl = (Shard(0), Shard(0), Shard(2))
    got = sh.local_shard(t, pl, mesh)
    i = coord[0] * 2 + coord[1]
    want = t.numpy()[i * 2:(i + 1) * 2, :, coord[2] * 2:(coord[2] + 1) * 2]
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="split"):
        sh.local_shard(torch.zeros(3, 4), (Shard(0), Replicate(),
                                           Replicate()), mesh)
