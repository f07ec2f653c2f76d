"""The port's front ends against the JAX package's on the CPU.

- ``examples.quickstart``: its output, line for line, is the original's.
- ``launch.moe_dispatch.run_all``: the original's dict on every preset the
  JAX package has (bit for bit: the same f64 cost model); the port's extra
  preset, ``h100``, is a single node and costs nothing.
- ``launch.paper_tables``: every table function at a reduced budget and
  shape list (the same lists on both sides, serial search): return values
  and printed rows equal, bit for bit; ``export_plans`` exports the same
  plan jobs as the original, on the port's card.
- ``examples.comet_attention``: its UA / PFA / FA lines and its planner
  lines are the original's.
- ``examples.serve_lm``: greedy tokens equal the JAX engine's on the same
  parameters (f32 smoke config); the prompts' logits within 1e-5 of the
  largest |logit| (f32 matmuls summed in another order).
- ``examples.train_lm``: the first two losses equal the JAX
  ``train_loop``'s within 1e-5 relative, at a cut depth (2 of 12 layers)
  and in f32, from the same parameters.

The JAX front ends outside the package (``examples/``, ``benchmarks/``)
are loaded from their files.  Nothing here starts a process pool: the
paper tables' sweeps run on the serial executor.
"""
import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import search as jsearch
from repro.launch.train import train_loop as jtrain_loop
from repro.models import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import search as tsearch
from repro_torch.examples import comet_attention, quickstart, serve_lm, \
    train_lm
from repro_torch.launch import moe_dispatch, paper_tables
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-5
LOSS_RTOL = 1e-5


def _load(rel):
    """A front end of the JAX package's repository, from its file."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "jax_front_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jpaper():
    return _load("benchmarks/paper_tables.py")


def test_quickstart_prints_the_originals_lines(capsys):
    _load("examples/quickstart.py").main()
    want = capsys.readouterr().out
    quickstart.main()
    assert capsys.readouterr().out == want
    assert "mapping tree" in want


def test_moe_dispatch_matches_jax(capsys):
    jmoe = _load("benchmarks/moe_dispatch.py")
    from repro.core.hardware import PRESETS as JPRESETS
    for overlap in (1.0, 0.5):
        want = jmoe.run_all(overlap=overlap)
        jout = capsys.readouterr().out
        got = moe_dispatch.run_all(overlap=overlap)
        tout = capsys.readouterr().out
        assert got == want
        assert sorted(JPRESETS) == sorted(set(moe_dispatch.PRESETS)
                                          - {"h100"})
        assert [ln for ln in tout.splitlines() if "[h100]" not in ln] \
            == jout.splitlines()
        assert "moe_dispatch[h100]: single-node cluster" in tout
    assert moe_dispatch.run_all(["tpu_v5e"]) == jmoe.run_all(["tpu_v5e"])


# the reduced tables: two GEMMs and two attention shapes an arch, a budget
# of 20, one provisioning shape
REDUCED = {
    "GEMMS_EDGE": [(1, 1024, 64), (256, 1024, 128)],
    "GEMMS_CLOUD": [(4, 8192, 128), (512, 2048, 64)],
    "ATTN_EDGE": [(1, 128, 1024, 128), (256, 128, 256, 128)],
    "ATTN_CLOUD": [(1, 128, 8192, 128), (256, 512, 256, 512)],
    "PROVISIONING_GEMMS": [(384, 768, 96)],
    "BUDGET": 20,
}


@pytest.fixture
def reduced(monkeypatch, jpaper):
    for mod, sm in ((jpaper, jsearch.search_many),
                    (paper_tables, tsearch.search_many)):
        for name, value in REDUCED.items():
            monkeypatch.setattr(mod, name, value)
        monkeypatch.setattr(mod, "search_many",
                            functools.partial(sm, executor="serial"))


def _plain(x):
    """Results with dataclasses and tuples as plain comparable values."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


TABLES = [("fusion_comparison_sm", "fusion_comparison",
           ("gemm_softmax", "gemm_sm", 1.42)),
          ("fusion_comparison_ln", "fusion_comparison",
           ("gemm_layernorm", "gemm_ln", 3.46)),
          ("attention_variants", "attention_variants", ()),
          ("breakdowns", "breakdowns", ()),
          ("pareto_fronts", "pareto_fronts", ()),
          ("provisioning_fronts", "provisioning_fronts", ()),
          ("mapping_variation", "mapping_variation", ()),
          ("beyond_paper", "beyond_paper_stats_collectives", ())]


def _args(mod, args):
    if args and isinstance(args[0], str) and args[0].startswith("gemm_"):
        from repro.core import workload as jwl
        from repro_torch.core import workload as twl
        wl = jwl if mod.__name__.startswith("jax_front") else twl
        return (getattr(wl, args[0]),) + args[1:]
    return args


@pytest.mark.parametrize("case,fn,args", TABLES, ids=[t[0] for t in TABLES])
def test_paper_tables_match_jax(reduced, jpaper, capsys, case, fn, args):
    want = getattr(jpaper, fn)(*_args(jpaper, args))
    jrows = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith(("gemm_sm_geomean", "gemm_ln_geomean"))]
    got = getattr(paper_tables, fn)(*_args(paper_tables, args))
    trows = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith(("gemm_sm_geomean", "gemm_ln_geomean"))]
    assert _plain(got) == _plain(want)
    assert trows == jrows           # the geomean rows carry a wall time
    assert trows


def test_export_plans_exports_the_same_jobs(tmp_path, monkeypatch, jpaper,
                                            capsys):
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, mod in (("jax", jpaper), ("port", paper_tables)):
        monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / name))
        rec = mod.export_plans(str(tmp_path / f"{name}.json"))
        bundle = json.loads((tmp_path / f"{name}.json").read_text())
        out[name] = (rec, bundle)
    capsys.readouterr()
    (jrec, jb), (trec, tb) = out["jax"], out["port"]
    assert trec["plans"] == jrec["plans"] == len(tb["plans"]) > 0
    assert trec["solved"] == jrec["solved"]
    # the same jobs: one a shape of the same kernel-shape table, the same
    # compound op kinds in the same order; solved on another card (and the
    # SSD chunks and tiles the card's kernels take)
    from repro.kernels import autotune as jat
    from repro_torch.kernels import autotune as tat
    assert tat.PAPER_KERNEL_SHAPES == jat.PAPER_KERNEL_SHAPES
    assert [co.name for co, _, _ in tat.plan_jobs()] == \
        [co.name for co, _, _ in jat.plan_jobs()]
    assert {e["key"][0] for e in tb["plans"]}.isdisjoint(
        {e["key"][0] for e in jb["plans"]})


def test_comet_attention_lines_match_jax(capsys):
    _load("examples/comet_attention.py").main()
    jout = capsys.readouterr().out.splitlines()
    variants = jout[1:1 + 4]
    planner = jout[-3:]
    assert variants == comet_attention.variant_lines()
    assert planner == comet_attention.planner_lines()
    comet_attention.main()
    tout = capsys.readouterr().out.splitlines()
    assert tout[:5] == jout[:5] and tout[-4:] == jout[-4:]
    assert any("block_n=" in ln for ln in tout)


def test_serve_lm_tokens_match_the_jax_engine(capsys):
    jcfg = jget_smoke("glm4-9b").with_(dtype="float32")
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jreqs = [JRequest(rid=i, prompt=rng.integers(0, jcfg.vocab_size, 24)
                      .astype(np.int32), max_new_tokens=6)
             for i in range(4)]
    jdone = JServeEngine(jm, jparams, batch_size=2, cache_len=96,
                         prompt_len=32).run(jreqs)
    model = Model(get_smoke_config("glm4-9b").with_(dtype="float32"))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    out = serve_lm.run(model, params, requests=4, batch=2, max_new=6)
    assert [r.output for r in out["done"]] == [r.output for r in jdone]
    assert sum(len(r.output) for r in jdone) == 24
    assert "sample output:" in capsys.readouterr().out
    tokens = np.stack([r.prompt for r in jreqs])
    want = np.asarray(jm.logits(jparams, {"tokens": jnp.asarray(tokens)}))
    got = model.logits(params, {"tokens": torch.from_numpy(
        tokens).long()}).numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_serve_lm_cli_on_the_cpu(capsys):
    out = serve_lm.main(["--device", "cpu", "--requests", "3", "--batch",
                         "2", "--max-new", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["requests"] == 3 and line["tokens"] == 9
    assert line["use_kernels"] is False and line["device"] == "cpu"
    assert out["launches"] == {"flash_attention": 0, "ssd_scan": 0}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--requests", "1"])


def test_train_lm_losses_match_jax_train_loop(monkeypatch, capsys):
    cut = train_lm.lm100m().with_(n_layers=2, dtype="float32")
    from repro.models import ModelConfig as JModelConfig
    jcut = JModelConfig(name="lm-100m", family="dense", n_layers=2,
                        d_model=512, n_heads=8, n_kv_heads=4, d_ff=2048,
                        vocab_size=32000, dtype="float32")
    jm = JModel(jcut)
    jparams = jm.init(jax.random.PRNGKey(0))
    want = jtrain_loop(jm, steps=2, batch=2, seq=32,
                       opt_cfg=JOptConfig(lr=3e-4, total_steps=2,
                                          warmup_steps=1), log_every=10)
    monkeypatch.setattr(train_lm, "lm100m", lambda: cut)
    monkeypatch.setattr(Model, "init", lambda self, seed=0, device=None:
                        params_from_jax(jax.tree.map(np.asarray, jparams),
                                        "cpu"))
    got = train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                         "--seq", "32"])
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 2 and len(line["losses"]) == 2
