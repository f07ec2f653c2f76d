"""The port's ``tensor_parallel=False`` knob on a model axis against the
JAX package on the CPU.

With the knob off the JAX package replicates every parameter over
``model`` and splits the moments over the data axes only
(``repro/launch/specs.py::state_specs``); its ``shard_map``s still cut
the MoE expert stack and the planner loss's unembed over ``model``, and
the declaration keeps their ``moe/*`` and ``xent/*`` collectives.  The
port runs attention, the MLP and the embedding on whole weights with no
``tp/`` collective, and each rank cuts its experts and its vocabulary
columns from the whole leaves (their gradients' blocks All-Gathered
back, ROADMAP C.16).

The ranks run ``tests/torch_mesh_ranks.py``'s ``tp_off`` suite (gloo, by
spawn, world 2 and world 4 side by side in two subprocesses with a
timeout), f32 smoke configs, ``torch_mesh_ranks.TP_OFF_CASES``: glm4-9b
and qwen3-moe-30b-a3b (capacity factor E / k) on (1, 2) and (2, 2).  Each
is held against the JAX package's mesh-free step by ``torch_mesh_checks``
(losses and parameters within 1e-5, every shard exactly its JAX block:
every parameter whole on every rank; the collectives equal to the
declaration with C.16 and the port's own).
"""
import numpy as np
import pytest

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks

CASES = [(world, arch, shape, variant)
         for world, cases in ranks.TP_OFF_CASES.items()
         for arch, shape, variants in cases for variant in variants]
IDS = [f"{arch}-{ranks.tag_of(shape)}-{v}" for _, arch, shape, v in CASES]


@pytest.fixture(scope="module")
def tp_off_out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, tuple(ranks.TP_OFF_CASES),
                            "tp_off")


def _results(out, world, arch, shape, variant):
    return ranks.load(out[world],
                      f"tp_off_{arch}_{ranks.tag_of(shape)}_{variant}", world)


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_tp_off_train_step_matches_jax(tp_off_out, world, arch, shape,
                                       variant):
    checks.check_train_matches_jax(
        _results(tp_off_out, world, arch, shape, variant), arch, shape,
        adam=True)


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_every_parameter_is_whole_on_each_rank(tp_off_out, world, arch,
                                               shape, variant):
    res = _results(tp_off_out, world, arch, shape, variant)
    specs = checks.jax_specs(arch, shape)
    assert not any(specs.values())
    last = f"step{ranks.STEPS - 1}"
    for name in specs:
        whole = res[0][0][last + name]
        for arr, _ in res[1:]:
            np.testing.assert_array_equal(arr[last + name], whole,
                                          err_msg=name)
    # the moments split over the data axes only
    for name, spec in checks.jax_specs(arch, shape, True).items():
        assert "model" not in spec, name


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_tp_off_collectives_equal_the_declared(tp_off_out, world, arch,
                                               shape, variant):
    res = _results(tp_off_out, world, arch, shape, variant)
    checks.check_collectives(res, arch, shape, variant)
    labels = {r[0] for _, meta in res for rec in meta["records"]
              for r in rec if r[3] > 1}
    assert not {x for x in labels if x.startswith("tp/")}
    assert "grads/norm" not in labels
    cfg = ranks.case_config(arch)
    assert ("moe/expert-block" in labels) == cfg.is_moe
    assert ("xent/unembed-block" in labels) == (variant != "plain")


def test_c16_names_the_whole_leaves_blocks():
    fix = checks.declaration_corrections("qwen3-moe-30b-a3b+tpoff", (2, 2))
    cfg = ranks.case_config("qwen3-moe-30b-a3b")
    assert set(fix) == {"C.14", "C.16"} or set(fix) == {"C.16"}
    c16 = fix["C.16"]
    stack = cfg.n_experts * cfg.d_model * cfg.moe_d_ff * 4.0
    assert c16[("moe/expert-block", "AllGather", stack, 2)] == \
        3 * cfg.n_layers
    unembed = cfg.d_model * cfg.padded_vocab * 4.0
    assert c16[("xent/unembed-block", "AllGather", unembed, 2)] == 1
    assert "xent/unembed-block" not in {
        k[0] for k in checks.declaration_corrections(
            "glm4-9b+tpoff", (1, 2), planner=False).get("C.16", {})}
