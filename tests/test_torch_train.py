"""Port training path against the JAX package on the CPU: the LM loss, one
train step's loss and gradients on the glm4 and mamba2 smoke configs in
f32 (the port on both kernel settings: on CPU tensors ``use_kernels=True``
goes through ``_FlashAttention``/``_SSDScan`` and their recompute
backward), ``adamw_update`` and ``cosine_lr`` on identical inputs, the
synthetic data, checkpoints written by either package and restored by the
other, the remat policies, microbatching, and the train CLI with its
restart; plus ports of tests/test_train_infra.py.

Inputs are made with numpy from a seed and handed to both packages; JAX
parameters reach the port through ``params_from_jax``.

Tolerances, each with its reason:
- 1e-6 relative for the loss of given logits: the same f32 reductions.
- 1e-5 relative for one step's loss: f32 matmuls summed in another order.
- Gradient leaves, max |port - JAX| <= 1e-4 x max |JAX|: glm4 (f32
  throughout).  mamba2: 1e-2 x max |JAX|, the repo's bf16 SSD bar.  Both
  packages round the scan's inputs, and so the cotangents of its output
  and inputs, to bf16 even in an f32 config
  (``repro/models/ssm.py:106-107``); an f32 difference in the order of a
  sum flips a few of those roundings, and the causal scan spreads each
  flip over every earlier position.  Within the port alone, a chunk of 32
  against 64 moves them past 1e-4
  (``test_mamba2_gradients_move_past_1e_4_with_the_chunk``).
- 1e-6 absolute for ``adamw_update``: the same f32 math, one fused
  multiply-add here and there.
- 1e-6 absolute between the remat policies: the same arithmetic, recomputed.
- Microbatches 4 against 1, and the loss curves: the bars of
  tests/test_train_infra.py.
- Checkpoints, data and host slices: bit for bit.
"""
import functools
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro.models.layers import cross_entropy_loss as jcross_entropy_loss
from repro.train import checkpoint as jck
from repro.train.data import SyntheticLM as JSyntheticLM
from repro.train.data import host_slice as jhost_slice
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.optimizer import cosine_lr as jcosine_lr
from repro.train.optimizer import init_opt_state as jinit_opt_state
from repro.train.train_step import TrainState as JTrainState
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ssd as tssd
from repro_torch.launch import train as train_cli
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.model import Model
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                          flatten_with_names, latest_step,
                                          restore_checkpoint, save_checkpoint)
from repro_torch.train.data import SyntheticLM, host_slice
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.optimizer import (OptConfig, OptState, adamw_update,
                                         cosine_lr, init_opt_state)
from repro_torch.train.train_step import (TrainState, make_loss_fn,
                                          make_train_step, value_and_grad)

LOSS_RTOL = 1e-5
GRAD_TOL = {"glm4-9b": 1e-4, "mamba2-130m": 1e-2}
ADAMW_ATOL = 1e-6


@pytest.fixture(autouse=True)
def no_thread_outlives_a_test():
    """Every AsyncCheckpointer is waited for: no writer thread is left to
    be inherited by a forked process later in the worker."""
    before = threading.active_count()
    yield
    assert threading.active_count() == before


def _np(t) -> np.ndarray:
    """A tensor or JAX array as numpy; bf16 as its 16-bit words."""
    if torch.is_tensor(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _batch(vocab, S, B, seed=0, step=0):
    return JSyntheticLM(vocab, S, B, seed=seed).batch(step)


def _tbatch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


# ------------------------------------------------------------------- loss


def test_cross_entropy_loss_matches_jax_with_padded_vocab():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 7, 24)) * 3).astype(np.float32)
    labels = rng.integers(0, 20, size=(2, 7)).astype(np.int32)
    want = float(jcross_entropy_loss(jnp.asarray(logits),
                                     jnp.asarray(labels), 20))
    got = float(cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 20))
    assert got == pytest.approx(want, rel=1e-6)
    # the padded columns are masked: making them huge changes nothing
    logits[..., 20:] = 1e4
    assert float(cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels), 20)) \
        == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------- one train step


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """The JAX package's loss and gradients on the f32 smoke config at
    batch 4, seq 64, with its params as numpy (computed once an arch)."""
    cfg = jget_smoke(arch).with_(dtype="float32")
    model = JModel(cfg)
    params = model.init(jax.random.PRNGKey(0))
    b = _batch(cfg.vocab_size, 64, 4)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    return (float(loss), jax.tree_util.tree_flatten_with_path(grads)[0],
            jax.tree.map(np.asarray, params), b)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m"])
def test_one_step_loss_and_grads_match_jax(arch, use_kernels, monkeypatch):
    jloss, jgrads, jparams, b = _jax_step(arch)
    model = Model(get_smoke_config(arch).with_(dtype="float32",
                                               use_kernels=use_kernels))
    params = params_from_jax(jparams, device="cpu")
    # on the kernel path every layer's mixer goes through its autograd
    # wrapper (on CPU tensors: the plain forward, the recompute backward)
    applied = []
    for fn in (tfa._FlashAttention, tssd._SSDScan):
        monkeypatch.setattr(fn, "apply", functools.partial(
            lambda orig, *a: applied.append(1) or orig(*a), fn.apply))
    loss, tgrads = value_and_grad(make_loss_fn(model), params, _tbatch(b))
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL)
    # forward and remat recompute: two applications a layer
    assert len(applied) == (2 * model.cfg.n_layers if use_kernels else 0)
    for path, jg in jgrads:
        tg = _get(tgrads, path).numpy()
        jg = np.asarray(jg)
        err = np.abs(tg - jg).max()
        assert err <= GRAD_TOL[arch] * np.abs(jg).max(), \
            (jax.tree_util.keystr(path), err, np.abs(jg).max())


def test_mamba2_gradients_move_past_1e_4_with_the_chunk(monkeypatch):
    """Why mamba2's gradient bar is 1e-2: the port against itself with the
    SSD at chunk 32 instead of 64 (the same math summed in another order)
    moves a gradient leaf by more than 1e-4 of its largest magnitude, and
    none by more than the bar."""
    cfg = get_smoke_config("mamba2-130m").with_(dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    b = _tbatch(_batch(cfg.vocab_size, 64, 4))
    grads = {}
    for chunk in (64, 32):
        monkeypatch.setattr(tssm, "plan_chunk", lambda *_, c=chunk: c)
        grads[chunk] = tree_leaves(
            value_and_grad(make_loss_fn(model), params, b)[1])
    worst = max(float((a - g).abs().max() / g.abs().max())
                for a, g in zip(grads[32], grads[64]))
    assert 1e-4 < worst < GRAD_TOL["mamba2-130m"]


# -------------------------------------------------------------- AdamW


def _opt_inputs(seed):
    """Params (an f32 and a bf16 leaf, nested), grads and a mid-run
    optimizer state (step 3, nonzero moments and error feedback)."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    params = {"w": f32(16, 24), "b": {"s": f32(24, scale=0.5)},
              "e": f32(8, 16).astype(jnp.bfloat16)}
    grads = {"w": f32(16, 24, scale=0.3), "b": {"s": f32(24, scale=0.3)},
             "e": f32(8, 16, scale=0.3).astype(jnp.bfloat16)}
    shapes = {"w": (16, 24), "b": {"s": (24,)}, "e": (8, 16)}
    m = jax.tree.map(lambda s: f32(*s, scale=0.1), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    v = jax.tree.map(lambda s: np.abs(f32(*s, scale=0.01)), shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    err = jax.tree.map(lambda s: f32(*s, scale=1e-3), shapes,
                       is_leaf=lambda x: isinstance(x, tuple))
    return params, grads, m, v, err


def _to_torch(tree):
    return tree_map(
        lambda a: tensor_from_numpy(np.asarray(a)).clone(), tree)


@pytest.mark.parametrize("compression", [False, True])
def test_adamw_update_matches_jax(compression):
    params, grads, m, v, err = _opt_inputs(1)
    jcfg = JOptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                      grad_compression=compression)
    cfg = OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                    grad_compression=compression)
    jstate = jinit_opt_state(params, compression=compression)._replace(
        step=jnp.int32(3), m=m, v=v, err=err if compression else None)
    jp, js, jmet = jadamw_update(jcfg, jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, grads), jstate)
    tparams, tgrads = _to_torch(params), _to_torch(grads)
    tstate = OptState(torch.tensor(3, dtype=torch.int32), _to_torch(m),
                      _to_torch(v), _to_torch(err) if compression else None)
    g_before = [g.clone() for g in tree_leaves(tgrads)]
    tp, ts, tmet = adamw_update(cfg, tparams, tgrads, tstate)
    assert tp is tparams                     # updated in place
    assert all(torch.equal(a, b) for a, b in zip(g_before,
                                                 tree_leaves(tgrads)))
    assert int(ts.step) == int(js.step) == 4
    for key in ("grad_norm", "lr"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-6)
    pairs = [(jp, tp), (js.m, ts.m), (js.v, ts.v)]
    if compression:
        pairs.append((js.err, ts.err))
    for jt, tt in pairs:
        for path, ja in jax.tree_util.tree_flatten_with_path(jt)[0]:
            ta = _get(tt, path)
            assert str(ta.dtype)[6:] == str(ja.dtype)
            np.testing.assert_allclose(ta.float().numpy(),
                                       np.asarray(ja, np.float32),
                                       atol=ADAMW_ATOL, rtol=0)


def test_cosine_lr_matches_jax():
    cfg = OptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    jcfg = JOptConfig(lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 10, 100):
        assert float(cosine_lr(cfg, step)) == pytest.approx(
            float(jcosine_lr(jcfg, jnp.int32(step))), rel=1e-6)


def test_cosine_lr_schedule():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(cosine_lr(cfg, 0)) < 0.2
    assert float(cosine_lr(cfg, 10)) == pytest.approx(1.0, abs=0.1)
    assert float(cosine_lr(cfg, 99)) == pytest.approx(0.1, abs=0.05)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("encdec", [False, True])
def test_synthetic_lm_and_host_slice_match_jax(encdec):
    kw = dict(vocab_size=300, seq_len=16, global_batch=8, seed=5,
              encdec=encdec, d_model=12)
    mine, theirs = SyntheticLM(**kw), JSyntheticLM(**kw)
    for step in (0, 1, 17):
        a, b = mine.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        for h in range(4):
            pa, pb = host_slice(a, h, 4), jhost_slice(b, h, 4)
            for k in pa:
                np.testing.assert_array_equal(pa[k], pb[k])


def test_host_slice():
    ds = SyntheticLM(100, 8, 8, seed=0)
    b = ds.batch(0)
    parts = [host_slice(b, h, 4) for h in range(4)]
    recon = np.concatenate([p["tokens"] for p in parts], axis=0)
    np.testing.assert_array_equal(recon, b["tokens"])


# ------------------------------------------------------ remat, microbatch


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m"])
def test_remat_policies_give_equal_grads(arch, monkeypatch):
    base = get_smoke_config(arch).with_(dtype="float32", use_kernels=True)
    params = Model(base).init(0, device="cpu")
    b = _tbatch(_batch(base.vocab_size, 32, 2, seed=2))
    calls = []
    layer_train = transformer._layer_train
    monkeypatch.setattr(transformer, "_layer_train",
                        lambda *a: calls.append(1) or layer_train(*a))
    out = {}
    for name, kw in (("full", dict(remat_policy="full")),
                     ("dots", dict(remat_policy="dots")),
                     ("none", dict(remat_policy="none")),
                     ("off", dict(remat=False))):
        model = Model(base.with_(**kw))
        calls.clear()
        loss, grads = value_and_grad(make_loss_fn(model), params, b)
        # full and dots run each layer again in the backward pass
        assert len(calls) == base.n_layers * (2 if name in ("full", "dots")
                                              else 1), name
        out[name] = (loss, tree_leaves(grads))
    for name in ("dots", "none", "off"):
        assert float(out[name][0]) == pytest.approx(float(out["full"][0]),
                                                    abs=1e-6)
        for a, g in zip(out[name][1], out["full"][1]):
            torch.testing.assert_close(a, g, atol=1e-6, rtol=0)
    # without grad (prefill, decode) nothing is checkpointed
    calls.clear()
    with torch.no_grad():
        Model(base).logits(params, b)
    assert len(calls) == base.n_layers


def test_microbatch_accumulation_equivalence():
    """µbatch-accumulated grads equal full-batch grads (same loss path)."""
    cfg = get_smoke_config("glm4-9b")
    model = Model(cfg)
    opt_cfg = OptConfig(lr=1e-3, total_steps=5)
    b = _tbatch(SyntheticLM(cfg.vocab_size, 32, 8, seed=3).batch(0))
    p = model.init(0, device="cpu")
    s1 = TrainState(p, init_opt_state(p))
    p2 = tree_map(torch.clone, p)
    s2 = TrainState(p2, init_opt_state(p2))
    _, m1 = make_train_step(model, opt_cfg, microbatches=1)(s1, b)
    _, m2 = make_train_step(model, opt_cfg, microbatches=4)(s2, b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) < 0.2


# ------------------------------------------------ ports of train-infra tests


def _train(arch="glm4-9b", steps=40, compression=False, seed=0):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(seed, device="cpu")
    opt_cfg = OptConfig(lr=5e-3, total_steps=steps, warmup_steps=2,
                        grad_compression=compression)
    state = TrainState(params, init_opt_state(params,
                                              compression=compression))
    step = make_train_step(model, opt_cfg)
    data = SyntheticLM(cfg.vocab_size, 64, 8, seed=seed)
    losses = []
    for i in range(steps):
        state, m = step(state, _tbatch(data.batch(i)))
        losses.append(float(m["loss"]))
    return losses, state


def test_loss_decreases():
    losses, _ = _train(steps=40)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_grad_compression_converges_similarly():
    base, _ = _train(steps=25, compression=False)
    comp, _ = _train(steps=25, compression=True)
    # int8 + error feedback must track the uncompressed run closely
    assert abs(np.mean(comp[-5:]) - np.mean(base[-5:])) < 0.35


def _assert_trees_equal(a, b):
    fa, fb = flatten_with_names(a), flatten_with_names(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=name)


def test_checkpoint_roundtrip(tmp_path):
    _, state = _train(steps=3)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, state, extra={"note": "t"})
    assert latest_step(d) == 3
    fresh = Model(get_smoke_config("glm4-9b")).init(1, device="cpu")
    restored, step, extra = restore_checkpoint(
        d, TrainState(fresh, init_opt_state(fresh)))
    assert step == 3 and extra["note"] == "t"
    _assert_trees_equal(restored, state)


def test_checkpoint_keep_k(tmp_path):
    _, state = _train(steps=2)
    d = str(tmp_path / "ck")
    for s in range(1, 6):
        save_checkpoint(d, s, state, keep=2)
    dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert dirs == ["step_000000004", "step_000000005"]


def test_async_checkpointer(tmp_path):
    _, state = _train(steps=2)
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(d, keep=2)
    ck.save(1, state)
    ck.save(2, state)
    ck.wait()
    assert not ck.errors
    assert not ck._worker.is_alive()
    assert latest_step(d) == 2


def test_async_checkpointer_snapshots_before_the_step_moves_on(tmp_path):
    """The train step updates its tensors in place: ``save`` must copy."""
    _, state = _train(steps=2)
    want = [t.clone() for t in tree_leaves(state.params)]
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(2, state)
    for t in tree_leaves(state.params):
        t.add_(1.0)
    ck.wait()
    restored, _, _ = restore_checkpoint(str(tmp_path / "ck"), state)
    for a, b in zip(tree_leaves(restored.params), want):
        assert torch.equal(a, b)


def test_restart_determinism(tmp_path):
    """Training 10 straight == training 5, checkpointing, restoring, +5."""
    cfg = get_smoke_config("phi4-mini-3.8b")
    model = Model(cfg)
    opt_cfg = OptConfig(lr=1e-3, total_steps=10, warmup_steps=1)
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=7)
    step = make_train_step(model, opt_cfg)

    def run(state, lo, hi):
        out = []
        for i in range(lo, hi):
            state, m = step(state, _tbatch(data.batch(i)))
            out.append(float(m["loss"]))
        return state, out

    def fresh():
        p = model.init(1, device="cpu")
        return TrainState(p, init_opt_state(p))

    _, straight = run(fresh(), 0, 10)
    s1, first = run(fresh(), 0, 5)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 5, s1)
    s2, _, _ = restore_checkpoint(d, fresh())
    _, second = run(s2, 5, 10)
    np.testing.assert_allclose(straight, first + second, rtol=1e-5)


def test_straggler_monitor():
    import time
    mon = StragglerMonitor(threshold=3.0, decay=0.5)
    for _ in range(4):
        mon.start()
        time.sleep(0.01)
        assert not mon.stop(0)
    mon.start()
    time.sleep(0.12)
    assert mon.stop(5)            # 12x the EMA -> flagged
    assert len(mon.events) == 1


# ------------------------------------------- checkpoints across packages


def _jax_state(seed=0):
    """A bf16 glm4 smoke TrainState of the JAX package after one AdamW
    step: bf16 params, f32 moments, an int32 step."""
    cfg = jget_smoke("glm4-9b").with_(dtype="bfloat16")
    params = JModel(cfg).init(jax.random.PRNGKey(seed))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype)
                         * jnp.sign(p + 0.5), params)
    p, opt, _ = jadamw_update(JOptConfig(), params, grads,
                              jinit_opt_state(params))
    return JTrainState(p, opt)


def _port_like():
    params = Model(get_smoke_config("glm4-9b").with_(dtype="bfloat16")) \
        .init(3, device="cpu")
    return TrainState(params, init_opt_state(params))


def test_jax_checkpoint_restores_bit_exact_in_the_port(tmp_path):
    jstate = _jax_state()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, 1, jstate, extra={"from": "jax"})
    state, step, extra = restore_checkpoint(jdir, _port_like())
    assert step == 1 and extra == {"from": "jax"}
    assert state.params["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    assert state.opt.step.dtype == torch.int32 and state.opt.err is None
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    tflat = flatten_with_names(state)
    assert [n for n, _ in tflat] == [jax.tree_util.keystr(p)
                                     for p, _ in jflat]
    for (_, t), (_, j) in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_np(t), _np(j))
    # written back by the port: the same manifest and the same bytes
    save_checkpoint(tdir, 1, state, extra={"from": "jax"})
    jpath, tpath = (os.path.join(d, "step_000000001") for d in (jdir, tdir))
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath))
    for name in os.listdir(jpath):
        with open(os.path.join(jpath, name), "rb") as f, \
                open(os.path.join(tpath, name), "rb") as g:
            a, b = f.read(), g.read()
        if name == "manifest.json":
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name


def test_port_checkpoint_restores_bit_exact_in_jax(tmp_path):
    model = Model(get_smoke_config("glm4-9b").with_(dtype="bfloat16"))
    p = model.init(4, device="cpu")
    state = TrainState(p, init_opt_state(p))
    grads = tree_map(lambda t: torch.full_like(t, 0.01), p)
    p, opt, _ = adamw_update(OptConfig(), p, grads, state.opt)
    state = TrainState(p, opt)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, state)
    jstate, step, _ = jck.restore_checkpoint(d, _jax_state(seed=1))
    assert step == 1
    tflat = flatten_with_names(state)
    jflat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert len(tflat) == len(jflat)
    for (name, t), (path, j) in zip(tflat, jflat):
        assert name == jax.tree_util.keystr(path)
        assert str(t.dtype)[6:] == str(j.dtype)
        np.testing.assert_array_equal(_np(t), _np(j), err_msg=name)


def test_mesh_and_shardings_wait_for_a_mesh(tmp_path, capsys):
    """The host mesh trains (a one-rank gloo mesh here; its step-0 loss is
    the plain step's within 1e-5); restoring onto shardings, the
    production mesh and checkpoints on a mesh still raise, naming A.5."""
    state = _port_like()
    save_checkpoint(str(tmp_path), 0, state)
    with pytest.raises(NotImplementedError, match="A.5"):
        restore_checkpoint(str(tmp_path), state, shardings=object())
    argv = ["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16"]
    for mesh in ("production", "production-multi"):
        with pytest.raises(NotImplementedError, match="A.5"):
            train_cli.main(argv + ["--mesh", mesh])
    with pytest.raises(NotImplementedError, match="A.5"):
        train_cli.main(argv + ["--mesh", "host", "--ckpt-dir",
                               str(tmp_path / "m")])
    plain = train_cli.main(argv)
    for planner in ([], ["--planner-loss"]):
        out = train_cli.main(argv + ["--mesh", "host"] + planner)
        assert abs(out["losses"][0] / plain["losses"][0] - 1) <= LOSS_RTOL
    assert not torch.distributed.is_initialized()     # the CLI's group ended
    capsys.readouterr()


# ---------------------------------------------------------------- the CLI


def test_train_cli_restart_matches_an_uninterrupted_run(tmp_path, capsys,
                                                        monkeypatch):
    """A 5-step run stopped by a fault in step 4, after its checkpoint at
    step 3, and rerun to 5 steps: the rerun restores step 3 and gives the
    losses of an uninterrupted 5-step run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "glm4-9b", "--smoke", "--batch", "4", "--seq", "32",
            "--steps", "5"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(argv)
    argv += ["--device", "cpu"]
    make = train_cli.make_train_step
    losses = []

    def failing_at_step_4(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, batch):
            if len(losses) == 3:
                raise RuntimeError("lost the host")
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    d = str(tmp_path / "ck")
    monkeypatch.setattr(train_cli, "make_train_step", failing_at_step_4)
    with pytest.raises(RuntimeError, match="lost the host"):
        train_cli.main(argv + ["--ckpt-every", "3", "--ckpt-dir", d])
    assert latest_step(d) == 3 and len(losses) == 3
    monkeypatch.setattr(train_cli, "make_train_step", make)
    resumed = train_cli.main(argv + ["--ckpt-dir", d])
    assert resumed["steps_done"] == 2 and latest_step(d) == 5
    straight = train_cli.main(argv)
    np.testing.assert_allclose(losses + resumed["losses"],
                               straight["losses"], rtol=1e-6)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"final_loss", "wall_s", "steps", "tokens_per_s",
                         "launches"}
    assert last["steps"] == 5 and last["final_loss"] == straight["losses"][-1]
    assert last["launches"] == {"flash_attention": 0, "ssd_scan": 0}
