"""ZeRO-3 (``fsdp``) in the port against the JAX package on the CPU.

The JAX package's ZeRO-3 step is the one GSPMD compiles from
``launch/specs.py::state_specs``: each parameter at its
``zero1_shardings`` block.  The port places them there
(``train_step.state_placements``), gathers each layer's slices over the
data axes inside the remat body (``params/...``), Reduce-Scatters their
gradients (``grads/...``) and updates the slices in place.

The ranks run ``tests/torch_mesh_ranks.py``'s ``fsdp`` suite (world 4,
gloo, by spawn in one subprocess with a timeout), f32 smoke configs, the
batches of ``SyntheticLM`` seed 0: ``torch_mesh_ranks.FSDP_CASES``
(glm4-9b on (2, 2) under the planner loss and the plain loss and on (4,
1), mamba2-130m on (2, 2), whose smoke conv_b and norm_scale split on
their layer dim, qwen3-moe-30b-a3b on (2, 2) at capacity factor E / k,
whose router and experts the step reduces itself; glm4 with
``tensor_parallel=False``, deepseek-v3, hymba and seamless on (2, 2)).
Each is held against the JAX mesh-free step after two steps (losses,
parameters and moments within 1e-5, mamba2's at ``SSD_TOL``), every
shard exactly its block under the JAX ``zero1_shardings``
``PartitionSpec``, the collectives equal to the declaration with C.6,
C.11-C.16, C.20 and C.21 applied, and each stacked leaf's gathers inside
the recompute once a layer. The int8-compressed step holds to the JAX
compressed step; a checkpoint written on (2, 2) restores bit for bit
onto (2, 2) and with no mesh; the prefill, decode and engine of glm4-9b,
mamba2-130m and seamless-m4t-medium on (2, 2) give the JAX engine's
tokens without a mesh.
"""
import collections

import numpy as np
import pytest

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks
from test_torch_serve_mesh import jax_reference

WORLD = 4
CASES = [(arch, shape, variant) for arch, shape, variants in ranks.FSDP_CASES
         for variant in variants]
IDS = [f"{arch}-{ranks.tag_of(shape)}-{v}" for arch, shape, v in CASES]


@pytest.fixture(scope="module")
def fsdp_out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, (WORLD,), "fsdp")[WORLD]


def _results(out, arch, shape, variant):
    return ranks.load(out, f"fsdp_{arch}_{ranks.tag_of(shape)}_{variant}",
                      WORLD)


@pytest.mark.parametrize("arch,shape,variant", CASES, ids=IDS)
def test_fsdp_train_step_matches_jax(fsdp_out, arch, shape, variant):
    checks.check_train_matches_jax(_results(fsdp_out, arch, shape, variant),
                                   arch, shape, adam=True)


SEQ_CASES = [(arch, shape, variant)
             for arch, shape, variants in ranks.FSDP_SEQ_CASES
             for variant in variants]


@pytest.mark.parametrize("arch,shape,variant", SEQ_CASES,
                         ids=[f"{a}-{ranks.tag_of(s)}-{v}"
                              for a, s, v in SEQ_CASES])
def test_fsdp_beside_seq_shard_matches_jax(fsdp_out, arch, shape, variant):
    """Under ``seq_shard`` the norms' gradients, Reduce-Scattered over the
    data axes, are summed over ``model`` as well: the step is still the
    JAX mesh-free step's."""
    res = _results(fsdp_out, arch, shape, variant)
    checks.check_train_matches_jax(res, arch, shape, adam=True)
    L = ranks.case_config(arch).n_layers
    for _, meta in res:
        for rec in meta["records"]:
            rows = collections.Counter(
                (r[1], r[3]) for r in rec
                if r[0] == "grads/layers.norm1.scale")
            assert rows == {("ReduceScatter", shape[0]): L,
                            ("AllReduce", shape[1]): 1}, rows


@pytest.mark.parametrize("arch,shape,variant", CASES, ids=IDS)
def test_fsdp_params_are_their_zero1_blocks(fsdp_out, arch, shape, variant):
    """Each rank holds exactly its block of every parameter under the JAX
    ``zero1_shardings`` spec, and its parameter bytes are the sum of those
    blocks: never a whole leaf that the data axes split."""
    res = _results(fsdp_out, arch, shape, variant)
    zspecs = checks.jax_specs(arch, shape, True)
    assert checks.param_specs(arch, shape) == zspecs
    steps, _ = checks.jax_steps(ranks.reference_arch(arch))
    want = steps[-1][1]
    for arr, meta in res:
        held = sum(arr[f"step1{name}"].nbytes for name in want)
        block = 0
        for name, w in want.items():
            idx = checks.block_index(zspecs[name], meta["coord"], shape,
                                     w.shape)
            assert arr[f"step1{name}"].shape == w[idx].shape, name
            block += w[idx].size * 4
        assert held == block
        assert held < sum(w.nbytes for w in want.values())


@pytest.mark.parametrize("arch,shape,variant", CASES, ids=IDS)
def test_fsdp_collectives_equal_the_declared(fsdp_out, arch, shape, variant):
    res = _results(fsdp_out, arch, shape, variant)
    checks.check_collectives(res, arch, shape, variant)
    labels = {r[0] for _, meta in res for rec in meta["records"]
              for r in rec}
    assert "zero1/params" not in labels
    if ranks.case_config(arch).is_moe:
        assert {"moe/combine", "moe/expert-grad", "moe/router-grad"} \
            <= labels


@pytest.mark.parametrize("arch,shape,variant", CASES, ids=IDS)
def test_fsdp_recompute_regathers_each_layer(fsdp_out, arch, shape,
                                             variant):
    """With remat on, the backward's recompute gathers each stacked leaf's
    layer slice once a layer, and nothing that it gathered whole before
    the layer loop; the forward's gathers of the same leaves equal them."""
    assert ranks.case_config(arch).remat
    want = collections.Counter()
    for keys, kind, n, dv in checks.zero3_leaves(arch, shape).values():
        if kind == "layer":
            want[("params/" + ".".join(keys), "AllGather", dv,
                  shape[0] * (shape[1] if len(shape) == 3 else 1))] += n
    assert want
    for _, meta in _results(fsdp_out, arch, shape, variant):
        for rec, again in zip(meta["records"], meta["recompute"]):
            got = collections.Counter(tuple(r) for r in again
                                      if r[0].startswith("params/"))
            assert got == want
            fwd = collections.Counter(tuple(r) for r in rec
                                      if tuple(r) in want)
            assert fwd == want


def test_fsdp_int8_compressed_step(fsdp_out):
    """ZeRO-3 with ``grad_compression``: the error feedback and the int8
    scales on the params' own slices, the scale of each whole leaf from
    one MAX All-Reduce, held to the JAX compressed step as the ``elastic``
    suite holds ZeRO-1's."""
    checks.check_int8_step(ranks.load(fsdp_out, "fsdp_int8", WORLD),
                           ranks.FSDP_CKPT, ranks.FSDP_SHAPE)


def test_fsdp_checkpoint_restores_bit_for_bit(fsdp_out):
    """Written on (2, 2) through ``state_placements``: the gathered state
    is the same on every rank and the JAX step's; restored onto (2, 2)
    each rank holds exactly its ZeRO-3 block, and with no mesh the whole
    state."""
    arch, shape = ranks.FSDP_CKPT, ranks.FSDP_SHAPE
    saved = ranks.load(fsdp_out, "fsdp_ckpt_saved", WORLD)
    for arr, _ in saved[1:]:
        for name, a in arr.items():
            np.testing.assert_array_equal(a, saved[0][0][name])
    saved = saved[0][0]
    steps, _ = checks.jax_steps(ranks.reference_arch(arch))
    for name, w in steps[-1][1].items():
        assert np.abs(saved[".params" + name] - w).max() <= checks.STEP_TOL
    for arr, meta in ranks.load(fsdp_out, "fsdp_ckpt_restored", WORLD):
        assert meta["step"] == ranks.STEPS
        for name, whole in saved.items():
            np.testing.assert_array_equal(arr[name], whole, err_msg=name)
            block = whole[checks.block_index(
                checks.state_spec(arch, name, shape), meta["coord"], shape,
                whole.shape)]
            np.testing.assert_array_equal(arr["local" + name], block,
                                          err_msg=name)
    for arr, meta in ranks.load(fsdp_out, "fsdp_ckpt_restored_none", WORLD):
        assert meta["step"] == ranks.STEPS
        assert set(arr) == set(saved)
        for name, whole in saved.items():
            np.testing.assert_array_equal(arr[name], whole, err_msg=name)


@pytest.mark.parametrize("arch", ranks.FSDP_SERVE)
def test_fsdp_serving_tokens_equal_the_jax_engine(fsdp_out, arch):
    """The prefill's and the decode step's logits (this rank's rows and
    vocab block) within 1e-5 of the JAX package's, the SSD family's at
    2e-3 (bf16 scan inputs), and the engine's tokens through its refills
    equal to the JAX engine's without a mesh."""
    ref = jax_reference(arch)
    tol = 2e-3 if ranks.case_config(arch).has_ssm else 1e-5
    res = ranks.load(fsdp_out, f"serve_{arch}_"
                     f"{ranks.tag_of(ranks.FSDP_SHAPE)}", WORLD)
    Vp = ranks.case_config(arch).padded_vocab
    for arr, meta in res:
        r0, r1 = meta["rows"]
        assert meta["outputs"] == ref["outputs"]
        labels = {r[0] for r in meta["prefill"] + meta["decode"]}
        assert any(lb.startswith("params/") for lb in labels)
        for key in ("prefill_logits", "decode_logits"):
            got = arr[key]
            v = got.shape[-1]
            c0 = 0 if v == Vp else meta["coord"][-1] * v
            want = ref[key][r0:r1, ..., c0:c0 + v]
            scale = np.abs(ref[key]).max()
            assert np.abs(got - want).max() <= tol * scale, key


def test_reconcile_sizes_zero3_entries_by_model_shard():
    """A ZeRO-3 leaf of L = 4 layers on a model axis of 2: its declared
    ``grads/`` Reduce-Scatter and two ``params/`` All-Gathers of the whole
    leaf are sized as the rank's ``model`` shard (C.6), the issued layer
    slices add up to it, and the recompute's regathers are the second
    gather (C.20): both ops reconcile, named; without the shards, the
    Reduce-Scatter, issued a layer's slice at a time, is left as a
    mismatch."""
    from repro_torch.analysis.counts import TraceCounts, counts_of_records
    from repro_torch.analysis.reconcile import (reconcile_cell,
                                                size_grads_as_issued)
    from repro_torch.parallel.collective_planner import DeclaredCollective
    whole, L, P = 8192.0, 4, 2
    slice_ = whole / 2 / L
    recs = [("params/layers.w", "AllGather", slice_, P)] * L \
        + [("grads/layers.w", "ReduceScatter", slice_, P)] * L
    t = counts_of_records(recs, TraceCounts())
    t.recompute = [("params/layers.w", "AllGather", slice_, P)] * L
    sched = [DeclaredCollective("grads/layers.w", "ReduceScatter", whole, P,
                                1, "gspmd"),
             DeclaredCollective("params/layers.w", "AllGather", whole, P,
                                2, "gspmd")]
    shards = {"layers.w": whole / 2}
    sized, labels = size_grads_as_issued(sched, t, shards)
    assert [d.dv_bytes for d in sized] == [whole / 2, whole / 2]
    assert labels == ["grads/layers.w", "params/layers.w"]
    rep = reconcile_cell(t, schedule=sched, shards=shards)
    notes = {f["hlo_op"]: f["note"] for f in rep.findings}
    assert all(f["explained"] for f in rep.findings)
    assert "C.20" in notes["all-gather"]
    assert "C.6: 1 grads/* entries" in notes["reduce-scatter"]
    bare = reconcile_cell(t, schedule=sched)
    assert not all(f["explained"] for f in bare.findings)
