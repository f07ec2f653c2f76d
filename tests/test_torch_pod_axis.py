"""The port's train step, ZeRO-1, checkpoints and serving engine on a
``(pod, data, model)`` mesh against the JAX package on the CPU.

The JAX package reduces over ``dp = ("pod", "data")`` wherever it
reduces over data; the port does so in one process group of ``pod x
data`` ranks in row-major order (``collective_planner.data_group``): the
batch rows, the ``grads/...`` All-Reduces (``P_dp`` participants, as
``train_collective_schedule`` prices them), the loss's mean and the
unembed's gradient, the MoE experts' gradients, ZeRO-1's moments and
their ``zero1/params`` All-Gather, and the engine's ``serve/tokens``.

The ranks run ``tests/torch_mesh_ranks.py``'s ``pod`` suite (world 4,
gloo, by spawn in one subprocess with a timeout), f32 smoke configs, the
batches of ``SyntheticLM`` seed 0: ``torch_mesh_ranks.POD_CASES`` (glm4-9b
on (2, 2, 1) and on (2, 1, 2) under the planner loss's two strategies and
the plain loss, qwen3-moe-30b-a3b on (2, 1, 2) at capacity factor E / k,
mamba2-130m on (2, 2, 1)), each held by ``torch_mesh_checks`` against the
JAX mesh-free step (losses, parameters and moments within 1e-5, the SSD
family's at ``SSD_TOL``, every shard exactly its block under the JAX
``PartitionSpec`` of a ``(pod, data, model)`` ``AbstractMesh``, the
collectives equal to the declaration and the port's own); one
int8-compressed step on (2, 2, 1) at the ``elastic`` suite's bars; a
checkpoint written on (2, 2, 1) and restored onto (2, 2, 1) and (1, 4)
bit for bit; and the engine on (2, 1, 2) and (2, 2, 1), whose tokens are
the JAX engine's without a mesh.
"""
import collections

import numpy as np
import pytest

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks
from test_torch_serve_mesh import jax_reference

WORLD = 4
CASES = [(arch, shape, variant) for arch, shape, variants in ranks.POD_CASES
         for variant in variants]
IDS = [f"{arch}-{ranks.tag_of(shape)}-{v}" for arch, shape, v in CASES]


@pytest.fixture(scope="module")
def pod_out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory, (WORLD,), "pod")[WORLD]


def _results(out, arch, shape, variant):
    return ranks.load(out, f"pod_{arch}_{ranks.tag_of(shape)}_{variant}",
                      WORLD)


@pytest.mark.parametrize("arch,shape,variant", CASES, ids=IDS)
def test_pod_train_step_matches_jax(pod_out, arch, shape, variant):
    checks.check_train_matches_jax(_results(pod_out, arch, shape, variant),
                                   arch, shape, adam=True)


@pytest.mark.parametrize("arch,shape,variant", CASES, ids=IDS)
def test_pod_collectives_equal_the_declared(pod_out, arch, shape, variant):
    res = _results(pod_out, arch, shape, variant)
    checks.check_collectives(res, arch, shape, variant)
    P_dp = shape[0] * shape[1]
    for _, meta in res:
        for rec in meta["records"]:
            # one group over (pod, data): each leaf's gradient reduced once
            grads = collections.Counter(r[0] for r in rec
                                        if r[0].startswith("grads/")
                                        and r[0] != "grads/norm")
            assert grads and set(grads.values()) == {1}
            assert {r[3] for r in rec if r[0] in grads
                    or r[0] in ("zero1/params", "loss/mean",
                                "xent/unembed-grad",
                                "moe/expert-grad")} == {P_dp}
    if ranks.case_config(arch).is_moe:
        labels = {r[0] for _, meta in res for rec in meta["records"]
                  for r in rec}
        assert {"moe/combine", "moe/expert-grad", "moe/router-grad"} \
            <= labels


def test_pod_int8_compressed_step(pod_out):
    checks.check_int8_step(ranks.load(pod_out, "pod_int8", WORLD),
                           "glm4-9b", ranks.POD_CKPT_SHAPE)


def test_pod_checkpoint_is_the_gathered_state(pod_out):
    saved = ranks.load(pod_out, "pod_ckpt_saved", WORLD)
    for arr, _ in saved[1:]:
        for name, a in arr.items():
            np.testing.assert_array_equal(a, saved[0][0][name])
    steps, _ = checks.jax_steps("glm4-9b")
    for name, w in steps[-1][1].items():
        assert np.abs(saved[0][0][".params" + name] - w).max() \
            <= checks.STEP_TOL


@pytest.mark.parametrize("shape", ranks.POD_RESTORE_SHAPES,
                         ids=[ranks.tag_of(s)
                              for s in ranks.POD_RESTORE_SHAPES])
def test_pod_checkpoint_restores_bit_for_bit(pod_out, shape):
    """The ZeRO-1 moments split over (pod, data) are gathered in order:
    the whole state restores bit for bit on a pod mesh and on (1, 4), each
    rank holding exactly its block under the new mesh's JAX specs."""
    saved = ranks.load(pod_out, "pod_ckpt_saved", WORLD)[0][0]
    res = ranks.load(pod_out, f"pod_ckpt_restored_{ranks.tag_of(shape)}",
                     WORLD)
    zspecs = checks.jax_specs("glm4-9b", ranks.POD_CKPT_SHAPE, True)
    assert any(isinstance(e, tuple) for s in zspecs.values() for e in s)
    for arr, meta in res:
        assert meta["step"] == ranks.STEPS
        assert meta["extra"] == {"mesh": list(ranks.POD_CKPT_SHAPE)}
        for name, whole in saved.items():
            np.testing.assert_array_equal(arr[name], whole, err_msg=name)
            block = whole[checks.block_index(
                checks.state_spec("glm4-9b", name, shape), meta["coord"],
                shape, whole.shape)]
            np.testing.assert_array_equal(arr["local" + name], block,
                                          err_msg=name)


@pytest.mark.parametrize("arch,shape", ranks.POD_SERVE,
                         ids=[ranks.tag_of(s) for _, s in ranks.POD_SERVE])
def test_pod_engine_tokens_equal_the_jax_engine(pod_out, arch, shape):
    ref = jax_reference(arch)
    cfg = ranks.case_config(arch)
    cols = cfg.padded_vocab // shape[-1]
    res = ranks.load(pod_out, f"serve_{arch}_{ranks.tag_of(shape)}", WORLD)
    B = ranks.serve_sizes(arch)[0]
    for arr, meta in res:
        assert meta["outputs"] == ref["outputs"]
        for key in ("prefill_calls", "decode_steps", "tokens_out"):
            assert meta["stats"][key] == ref["stats"][key]
        # the slots split over (pod, data), pod outer
        p, d, _ = meta["coord"]
        n = B // (shape[0] * shape[1])
        assert meta["rows"] == [(p * shape[1] + d) * n,
                                (p * shape[1] + d + 1) * n]
        r0, r1 = meta["rows"]
        c0 = meta["coord"][-1] * cols
        for step in ("prefill_logits", "decode_logits"):
            want = ref[step][r0:r1, :, c0:c0 + cols]
            tol = checks.STEP_TOL * max(1.0, float(np.abs(want).max()))
            assert np.abs(arr[step] - want).max() <= tol, step
        # each call's tokens gathered over the data axes at once
        calls = meta["stats"]["prefill_calls"] + meta["stats"]["decode_steps"]
        tokens = [r for r in meta["engine"] if r[0] == "serve/tokens"]
        assert len(tokens) == calls
        assert {(r[1], r[3]) for r in tokens} == \
            {("AllGather", shape[0] * shape[1])}


def test_mesh_bench_runs_the_pod_and_seq_shard_meshes_on_gloo(tmp_path):
    """``launch/mesh_bench.py`` (the 4-card run of these meshes) on four
    gloo ranks at the smoke size, in a subprocess: every case's losses
    equal on every rank and within its bar of the (1, 4) step, the
    gradients over (pod, data) in one group, the pod meshes' and
    ``seq_shard``'s collectives each timed, least and most over the
    ranks; the (4, 1) ZeRO-1 and ZeRO-3 (``fsdp``) cases beside them, the
    latter's gradients Reduce-Scattered and no ``zero1/params`` gather,
    no device memory on the CPU."""
    import json
    import os
    import subprocess
    import sys
    out = tmp_path / "bench.json"
    env = dict(os.environ, PYTHONPATH=str(ranks.ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mesh_bench", "--device",
         "cpu", "--smoke", "--json", str(out)], cwd=tmp_path, env=env,
        capture_output=True, text=True,
        timeout=ranks.RANKS_TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["ranks"] == 4
    by = {(c["case"], tuple(c["mesh"].values())): c for c in rec["cases"]}
    assert set(by) == {("pod", (2, 2, 1)), ("pod", (2, 1, 2)),
                       ("tp", (1, 4)), ("seq_shard", (1, 4)),
                       ("zero1", (4, 1)), ("fsdp", (4, 1))}
    for (name, shape), c in by.items():
        keys = c["collectives"]
        grads = [k for k in keys if k.startswith("grads/layers.attn.wq ")]
        if name == "pod":
            P_dp = shape[0] * shape[1]
            assert grads and all(k.endswith(f" x{P_dp}") for k in grads)
        seq = any(k.startswith("tp/seq-gather ") for k in keys)
        assert seq == (name == "seq_shard")
        assert all(0 <= v["ms_least"] <= v["ms_most"]
                   for v in keys.values())
        assert 0 <= c["collective_ms_least"] <= c["collective_ms_most"]
        assert c["peak_bytes_least"] is None
        if name in ("zero1", "fsdp"):
            zero3 = any(k.startswith("grads/layers.attn.wq ReduceScatter")
                        for k in keys)
            assert zero3 == (name == "fsdp")
            assert any(k.startswith("zero1/params ") for k in keys) \
                == (name == "zero1")
