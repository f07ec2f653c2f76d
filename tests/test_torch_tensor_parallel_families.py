"""The port's tensor-parallel mesh train step for the families beyond GQA
and the routed MoE FFN, against the JAX package on the CPU.

Two steps of ``make_train_step`` on gloo meshes (the ranks run in
``tests/torch_mesh_ranks.py``'s ``tp_families`` suite, by spawn, world 2
and world 4 side by side in two subprocesses with a timeout; nothing here
forks or starts a pool), f32 smoke configs, the batches of ``SyntheticLM``
seed 0 (with an enc-dec model's frames), ``torch_mesh_ranks.FAMILY_CASES``:

- mamba2-130m on (1, 2) and (1, 4): the SSM mixer's *f*/*g* and the
  transposes of its gathers, norm and output reductions (tied
  embeddings: the plain loss);
- hymba-1.5b on (1, 2) under the planner loss's two strategies and the
  plain loss: both mixers on the rank's heads; its 5-head variant
  (``hymba-1.5b-h5``, 5 q and 5 kv heads of 12), whose q and k columns a
  2-rank axis cuts mid-head: the q gather under autograd;
- seamless-m4t-medium on (1, 2): encoder, decoder and cross-attention
  tensor-parallel (enc-dec: the plain loss);
- deepseek-v3-671b on (2, 2), planner loss ('dist') and plain: MLA on the
  rank's heads, the dense stack, the shared experts, and the sigmoid
  router's bias, whose zero cotangent is All-Reduced over every axis
  (``moe/router-bias-grad``).

``torch_mesh_checks`` holds the checks: the losses and the gathered
parameters and moments against the JAX package's mesh-free step within
1e-5 (f32 sums in another order over the ranks), each parameter element
also within what the gradients' own bar moves it through AdamW
(``adam_bar``: an element of gradient near zero is decided by the noise),
and for mamba2 and hymba the moments and the later losses within 1e-2 of
each leaf's largest |JAX| (``SSD_TOL``: bf16 rounding of the scan's
inputs in both packages); every shard placed as the JAX
``PartitionSpec`` says and the replicas bit-equal; and every collective
outside the remat recompute either one of ``train_collective_schedule``'s
``participants > 1`` entries, corrected where the declaration miscounts
(``declaration_corrections``, ROADMAP Queue C), or one of the port's own
(``port_own_schedule``).
"""
import pytest

import torch_mesh_checks as checks
import torch_mesh_ranks as ranks

CASES = [(world, arch, shape, variant)
         for world, cases in ranks.FAMILY_CASES.items()
         for arch, shape, variants in cases for variant in variants]
IDS = [f"{arch}-{ranks.tag_of(shape)}-{v}" for _, arch, shape, v in CASES]


@pytest.fixture(scope="module")
def families_out(tmp_path_factory):
    return ranks.run_worlds(tmp_path_factory,
                            tuple(ranks.FAMILY_CASES), "tp_families")


def _results(out, world, arch, shape, variant):
    return ranks.load(out[world],
                      f"tp_{arch}_{ranks.tag_of(shape)}_{variant}", world)


def _labels(res, key="records"):
    return {r[0] for _, meta in res for rec in meta[key] for r in rec}


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_family_train_step_matches_jax(families_out, world, arch, shape,
                                       variant):
    checks.check_train_matches_jax(
        _results(families_out, world, arch, shape, variant), arch, shape,
        adam=True)


@pytest.mark.parametrize("world,arch,shape,variant", CASES, ids=IDS)
def test_family_collectives_equal_the_declared(families_out, world, arch,
                                               shape, variant):
    res = _results(families_out, world, arch, shape, variant)
    checks.check_collectives(res, arch, shape, variant)
    cfg = ranks.case_config(arch)
    labels, again = _labels(res), _labels(res, "recompute")
    # each family's own collectives are issued, and the recompute repeats
    # its mixers' forward ones (up to the last one the backward needs:
    # torch.utils.checkpoint stops there)
    if cfg.has_ssm:
        assert {"tp/ssm-gather", "tp/ssm-norm", "tp/ssm-out",
                "tp/ssm-param-grad"} <= labels
        assert {"tp/ssm-gather", "tp/ssm-norm"} <= again
    assert ("tp/q-gather" in labels) == arch.endswith("-h5")
    if cfg.attn_type == "mla":
        assert "tp/mla-latent" in labels and "tp/attn-out" in again
    if cfg.is_encdec:
        assert "tp/cross-kv" in labels
    if cfg.n_shared_experts:
        assert {"moe/shared-out", "moe/router-bias-grad"} <= labels


def test_declaration_corrections_are_named_and_counted():
    """The corrections of the declared schedule, by Queue C item: what
    each case's audit adds to or takes from the declaration."""
    got = {(arch, shape): {item: dict(fix) for item, fix in
                           checks.declaration_corrections(arch,
                                                          shape).items()}
           for cases in ranks.FAMILY_CASES.values()
           for arch, shape, _ in cases}
    act = 4 * 16 * 64 * 4.0            # (B, S, d) f32 a rank on (1, m)
    assert got[("mamba2-130m", (1, 2))] == {"C.11": {
        ("tp/attn-out", "AllReduce", act, 2): -4,
        ("tp/ffn-out", "AllReduce", act, 2): -4}}
    assert got[("hymba-1.5b", (1, 2))] == {}
    frames = act / 8                    # (B, S / enc_ratio, d)
    assert got[("seamless-m4t-medium", (1, 2))] == {"C.12": {
        ("tp/attn-out", "AllReduce", frames, 2): 4,
        ("tp/ffn-out", "AllReduce", frames, 2): 4,
        ("tp/attn-out", "AllReduce", act, 2): 4}}
    c14 = got[("deepseek-v3-671b", (2, 2))].pop("C.14")
    assert got[("deepseek-v3-671b", (2, 2))] == {"C.13": {
        ("tp/attn-out", "AllReduce", act / 2, 2): -3}}
    # the shared experts' three leaves, each rank's ff half of (2, 64, 32)
    assert c14 == {(f"grads/layers.moe.shared_{w}", "AllReduce",
                    2 * 64 * 16 * 4.0, 2): 1 for w in ("wi", "wg", "wo")}


def test_adam_bar_is_needed_without_a_mesh():
    """Why the parameters carry ``adam_bar``: the port's mesh-free step
    against the JAX step moves a deepseek-v3 parameter element past
    ``STEP_TOL`` (Adam amplifies the f32 noise of a gradient near zero),
    and every element stays within the bar."""
    import numpy as np
    from repro_torch.models.model import Model
    from repro_torch.train.checkpoint import flatten_with_names
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    arch = "deepseek-v3-671b"
    steps, _ = checks.jax_steps(arch)
    cfg = ranks.case_config(arch)
    model = Model(cfg)
    state = init_train_state(model, model.init(0, device="cpu"))
    step = make_train_step(model, OptConfig(warmup_steps=1,
                                            total_steps=ranks.STEPS))
    state, _ = step(state, ranks._batches(cfg)[0])
    _, want, want_m = steps[0]
    worst = 0.0
    for name, t in flatten_with_names(state.params):
        err = np.abs(t.detach().numpy() - want[name])
        g = np.abs(want_m[name]) / (1 - checks.JOptConfig().betas[0])
        assert (err <= checks.STEP_TOL
                + checks.adam_bar(g, g.max(), 0, False)).all(), name
        worst = max(worst, err.max())
    assert worst > checks.STEP_TOL
