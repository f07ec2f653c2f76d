"""The port's ``seq_shard`` knob on a model axis against the JAX package
on the CPU.

With ``seq_shard`` the JAX package constrains the residual to ``P(dp,
"model", None)`` after every mixer and FFN (``repro/models/
transformer.py::_residual_spec``), so that GSPMD turns each block's
All-Reduces into Reduce-Scatter/All-Gather pairs.  The port keeps each
rank's ``S / m`` rows of the residual: a block gathers the rows in
(``tp/seq-gather``, its transpose a Reduce-Scatter) and Reduce-Scatters
its output's rows out (its transpose an All-Gather), the norms run on the
local rows, and their gradients are All-Reduced over every axis.

The ranks run ``tests/torch_mesh_ranks.py``'s ``seq`` suite (gloo, by
spawn, world 2 and world 4 side by side in two subprocesses with a
timeout; nothing here forks or starts a pool), f32 smoke configs, the
batches of ``SyntheticLM`` seed 0, ``torch_mesh_ranks.SEQ_CASES``:
glm4-9b on (1, 2) (the planner loss's 'dist' and the plain loss), (1, 4)
('gather') and (2, 2, 1); mamba2-130m, hymba-1.5b (both mixers on one
gather), deepseek-v3-671b (MLA, the dense stack, the shared experts'
own gather and scatter) and qwen3-moe-30b-a3b (capacity factor E /
k) on (1, 2); seamless-m4t-medium on (1, 2), which the knob leaves as it
is, as in the JAX package.  Each is held against the JAX package's
mesh-free step by ``torch_mesh_checks`` (losses and parameters within
1e-5 and ``adam_bar``, the SSD families' moments at ``SSD_TOL``, every
shard exactly its JAX block, the collectives equal to the declaration
with ROADMAP C.15's correction and the port's own).  glm4-9b also runs
on (1, 2) with both knobs (``+seq+tpoff``): whole weights on a split
residual.  One prefill a case
of ``SEQ_PREFILL`` on (1, 2): its logits within 1e-5 of the JAX
package's, every cache shard the JAX cache's block.
"""
import collections

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks
from repro.parallel import sharding as jsh
from test_torch_serve_mesh import SSD_JAX_TOL, jax_reference

CASES = [(world, arch, shape, variant)
         for world, cases in ranks.SEQ_CASES.items()
         for arch, shape, variants in cases for variant in variants]
IDS = [f"{arch}-{ranks.tag_of(shape)}-{v}" for _, arch, shape, v in CASES]
TOL = 1e-5


@pytest.fixture(scope="module")
def seq_out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, tuple(ranks.SEQ_CASES), "seq")


def _results(out, world, arch, shape, variant):
    return ranks.load(out[world],
                      f"seq_{arch}_{ranks.tag_of(shape)}_{variant}", world)


def _records(res, key="records"):
    return [tuple(r[:2]) for _, meta in res for rec in meta[key]
            for r in rec if r[3] > 1]


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_seq_shard_train_step_matches_jax(seq_out, world, arch, shape,
                                          variant):
    checks.check_train_matches_jax(
        _results(seq_out, world, arch, shape, variant), arch, shape,
        adam=True)


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_seq_shard_collectives_equal_the_declared(seq_out, world, arch,
                                                  shape, variant):
    res = _results(seq_out, world, arch, shape, variant)
    checks.check_collectives(res, arch, shape, variant)
    cfg = ranks.case_config(arch)
    issued = set(_records(res))
    split = cfg.seq_shard and not cfg.is_encdec and shape[-1] > 1
    assert ((checks.SEQ, "AllGather") in issued) == split
    if split:
        # no block All-Reduces its output: each scatters its rows
        blocks = {"tp/attn-out", "tp/ffn-out", "tp/ssm-out", "moe/combine",
                  "moe/shared-out"}
        assert not {k for k in issued if k[0] in blocks
                    and k[1] == "AllReduce"}
        # where the weights are split; whole weights take their block
        # out, whose transpose gathers
        out_type = "ReduceScatter" if cfg.tensor_parallel else "AllGather"
        assert any(k[0] in blocks and k[1] == out_type for k in issued)
        # the remat recompute gathers the rows again
        assert all((checks.SEQ, "AllGather") in
                   {tuple(r[:2]) for r in again}
                   for _, meta in res for again in meta["recompute"])


def test_declared_all_reduces_become_scatter_gather_pairs():
    """C.15 on glm4's (1, 2) case: each of the 2 layers' attention and MLP
    swaps its 2 All-Reduces for a Reduce-Scatter, an All-Gather and the
    rows' gather and scatter; the norms' gradients go over every axis."""
    fix = checks.declaration_corrections("glm4-9b+seq", (1, 2))["C.15"]
    act = 4 * 16 * 64 * 4.0
    for label in ("tp/attn-out", "tp/ffn-out"):
        assert fix[(label, "AllReduce", act, 2)] == -4
        assert fix[(label, "ReduceScatter", act, 2)] == 2
        assert fix[(label, "AllGather", act, 2)] == 2
    assert fix[(checks.SEQ, "AllGather", act, 2)] == 4
    assert fix[(checks.SEQ, "ReduceScatter", act, 2)] == 4
    assert fix[("grads/final_norm.scale", "AllReduce", 64 * 4.0, 2)] == 1
    assert fix[("grads/layers.norm1.scale", "AllReduce", 2 * 64 * 4.0,
                2)] == 1
    # on a pod mesh the norms' gradients leave the data axes' group
    pod = checks.declaration_corrections("glm4-9b+seq", (2, 1, 2))["C.15"]
    assert pod[("grads/final_norm.scale", "AllReduce", 256.0, 2)] == -1
    assert pod[("grads/final_norm.scale", "AllReduce", 256.0, 4)] == 1


def test_seamless_is_the_run_without_the_knob(seq_out):
    """An enc-dec model never splits its residual (the JAX package's
    ``encdec.py`` keeps ``P(dp, None, None)``): with and without the knob
    the ranks compute the same bits and issue the same collectives."""
    on = _results(seq_out, 2, "seamless-m4t-medium+seq", (1, 2), "plain")
    off = _results(seq_out, 2, "seamless-m4t-medium", (1, 2), "plain")
    for (a, ma), (b, mb) in zip(on, off):
        assert ma["losses"] == mb["losses"]
        assert ma["records"] == mb["records"]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    checks.check_train_matches_jax(off, "seamless-m4t-medium", (1, 2),
                                   adam=True)


def _close(got, want, what, rel=TOL):
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("arch", ranks.SEQ_PREFILL)
def test_seq_shard_prefill_matches_jax(seq_out, arch):
    ref = jax_reference(ranks.reference_arch(arch))
    cfg = ranks.case_config(arch)
    shape = (1, 2)
    cols = cfg.padded_vocab // 2
    cache, flat = ref["prefill"]
    placed = jsh.cache_shardings(cache, AbstractMesh(shape, checks.AXES),
                                 ranks.serve_sizes(arch)[0])
    specs = {jax.tree_util.keystr(p): checks._trimmed(v.spec)
             for p, v in jax.tree_util.tree_flatten_with_path(
                 placed, is_leaf=lambda x: isinstance(
                     x, jax.sharding.NamedSharding))[0]}
    cache_tol = SSD_JAX_TOL if cfg.has_ssm else TOL
    for arr, meta in ranks.load(seq_out[2], f"prefill_{arch}", 2):
        r0, r1 = meta["rows"]
        c0 = meta["coord"][-1] * cols
        _close(arr["prefill_logits"],
               ref["prefill_logits"][r0:r1, :, c0:c0 + cols], arch)
        for name, want in flat.items():
            block = checks.block_index(specs[name], meta["coord"], shape,
                                       want.shape)
            got = arr["prefill" + name]
            if want.dtype.kind == "i":
                np.testing.assert_array_equal(got, want[block], err_msg=name)
            else:
                _close(got, want[block], name, cache_tol)
        issued = collections.Counter(tuple(r[:2]) for r in meta["records"])
        # the embedding's scatter and each layer's gathers and scatters;
        # the final hidden state gathered before the logits
        assert issued[("tp/embed", "ReduceScatter")] == 1
        assert issued[(checks.SEQ, "AllGather")] >= 2 * cfg.n_layers + 1
        assert not {k for k in issued if k[1] == "AllReduce"
                    and k[0] in ("tp/attn-out", "tp/ffn-out", "tp/embed")}
