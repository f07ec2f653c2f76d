"""Port serving engine on the CPU: continuous-batching stats, refill equal
to serial decoding, greedy outputs token-identical to the JAX engine on
the same f32 parameters, and the serve entry point's refusal to run on the
CPU unless asked, for every arch of the registry."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS as T_ARCH_IDS
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine


def _engine(batch, **cfg_kw):
    cfg = get_smoke_config("glm4-9b").with_(**cfg_kw)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    return model, params, lambda b=batch: ServeEngine(
        model, params, batch_size=b, cache_len=48, prompt_len=16)


def test_serve_engine_continuous_batching_stats():
    model, _, make = _engine(3)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, model.cfg.vocab_size, size=12).astype(np.int32), max_new_tokens=5)
        for i in range(7)]                      # 7 requests through 3 slots
    eng = make()
    done = eng.run(reqs)
    assert all(len(r.output) == 5 and r.done for r in done)
    assert eng.stats["tokens_out"] == 35
    # refilled slots are re-prefilled, batched per step: 3 waves
    assert eng.stats["prefill_calls"] == 3


def test_serve_engine_refill_matches_serial_decoding():
    model, _, make = _engine(3, dtype="float32", use_kernels=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab_size, size=12).astype(np.int32)
               for _ in range(7)]
    new_tokens = [5, 3, 4, 6, 2, 5, 3]      # slots free at different steps
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    make().run(reqs)
    one = make(1)
    for i, (p, n) in enumerate(zip(prompts, new_tokens)):
        ref = Request(rid=100 + i, prompt=p.copy(), max_new_tokens=n)
        one.run([ref])
        assert reqs[i].output == ref.output, f"request {i} diverged"


def test_serve_engine_guards():
    model, _, make = _engine(2)
    rng = np.random.default_rng(2)
    mk = lambda i, **kw: Request(rid=i, prompt=rng.integers(  # noqa: E731
        0, model.cfg.vocab_size, size=8).astype(np.int32), **kw)
    eng = ServeEngine(model, make().params, batch_size=2, cache_len=48,
                      prompt_len=16, max_new_cap=3)
    capped = [mk(0, max_new_tokens=9), mk(1, max_new_tokens=2),
              mk(2, max_new_tokens=9, deadline_s=0.0)]
    eng.run(capped)
    assert [len(r.output) for r in capped] == [3, 2, 1]
    assert capped[2].timed_out and eng.stats["timeouts"] == 1


def test_greedy_outputs_token_identical_to_jax_engine():
    jcfg = jget_smoke("glm4-9b").with_(dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_smoke_config("glm4-9b").with_(dtype="float32"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=12).astype(np.int32)
               for _ in range(5)]
    new_tokens = [4, 2, 5, 3, 4]
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, new_tokens))]
    jeng = JServeEngine(jm, jp, batch_size=2, cache_len=32, prompt_len=16,
                        plan_warmup=False)
    teng = ServeEngine(tm, tp, batch_size=2, cache_len=32, prompt_len=16)
    jeng.run(jreqs)
    teng.run(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    for key in ("prefill_calls", "decode_steps", "tokens_out"):
        assert teng.stats[key] == jeng.stats[key]


def test_serve_cli_refuses_cpu_unless_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "glm4-9b", "--smoke", "--requests", "2", "--batch",
            "2", "--prompt-len", "8", "--cache-len", "16", "--max-new", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(argv)
    out = serve_cli.main(argv + ["--device", "cpu"])
    assert out["tokens"] == 4 and out["prefill_calls"] == 1
    assert '"tokens": 4' in capsys.readouterr().out


def test_resolve_device_refuses_a_card_that_is_not_hopper(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (8, 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "A100")
    with pytest.raises(RuntimeError, match="sm_90a"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("arch", T_ARCH_IDS)
def test_serve_cli_takes_every_arch(arch, monkeypatch):
    """Every arch of the registry serves its smoke config on the CPU when
    asked, and refuses to run there unless asked."""
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--batch", "2",
            "--prompt-len", "8", "--cache-len", "16", "--max-new", "2"]
    out = serve_cli.main(argv + ["--device", "cpu"])
    assert out["tokens"] == 6 and out["prefill_calls"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(argv)
