"""The port's tracer (``repro_torch.tracing``) on the CPU: spans at the
engine's and the train step's layer boundaries, their nesting and clock,
the engine's prefill counters, and the collectives' timer.

- Off (the default), a tiny ``ServeEngine.run`` and train step keep no
  span, and a profiler over them sees no range of the port's.
- On, each span's host stamps lie within 1 ms of its own
  ``record_function`` range in a CPU profile: one clock with the trace.
- Nesting (the innermost span whose host stamps hold a span's):
  ``serve/queue`` under ``serve/run``; ``train/remat``,
  ``attention/backward`` and ``ssd/backward`` under ``train/backward``.
- The first wave's queue waits end before any work starts; the second
  wave's hold at least the first wave's prefill and decode spans.
- ``ServeEngine.stats``' prefill counters give the useful share of a
  submission with known prompt lengths.
- A train step with remat, ``use_kernels`` and float32 records one
  ``train/remat`` and one kernel backward a layer and one
  ``train/optimizer`` a step.
- ``record_collectives(timed=True)`` on a one-rank gloo mesh keeps the
  records an untimed block keeps, each with its time; a mesh step's
  gradient collectives run inside its ``train/reduce``.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.model import Model
from repro_torch.parallel import collective_planner as cp
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step

# hymba's smoke attention takes FlashAttention up to 2 windows (64)
TRAIN_SEQ = 48
PROMPT_LEN = 16
PROMPTS = [5, 16, 20, 9]        # two waves through 2 slots
NESTED = ("serve/run", "serve/prefill", "serve/splice", "serve/decode",
          "serve/sync", "train/step", "train/forward", "train/backward",
          "train/remat", "attention/backward", "ssd/backward",
          "train/optimizer")


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with tracing off and nothing kept."""
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def _engine(arch="glm4-9b"):
    cfg = get_smoke_config(arch).with_(dtype="float32")
    model = Model(cfg)
    eng = ServeEngine(model, model.init(0, device="cpu"), batch_size=2,
                      cache_len=48, prompt_len=PROMPT_LEN,
                      plan_warmup=False)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=10 + i, max_new_tokens=3,
                    prompt=rng.integers(1, cfg.vocab_size, size=n)
                    .astype(np.int32)) for i, n in enumerate(PROMPTS)]
    return eng, reqs


def _train(arch):
    cfg = get_smoke_config(arch).with_(dtype="float32", use_kernels=True,
                                       remat=True, remat_policy="full")
    model = Model(cfg)
    state = init_train_state(model, model.init(0, device="cpu"))
    step = make_train_step(model, OptConfig())
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, TRAIN_SEQ), generator=g)
             for k in ("tokens", "labels")}
    return cfg, lambda: step(state, batch)


def _parent(s, spans):
    """The innermost other span over a block (not a queue's wait) whose
    host stamps hold ``s``'s, or None."""
    around = [p for p in spans if p is not s and p.name != "serve/queue"
              and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns]
    return max(around, key=lambda p: p.start_ns, default=None)


def _annotations(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def test_off_keeps_nothing_and_opens_no_range():
    eng, reqs = _engine()
    _, step = _train("hymba-1.5b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(reqs)
        step()
    assert tracing.collect() == []
    assert not [n for n, _, _ in _annotations(prof)
                if n.startswith(("serve/", "train/", "attention/", "ssd/"))]
    # every site shares one object that does nothing
    assert tracing.span("a") is tracing.span("b", device=True)
    assert tracing.start("serve/queue") is None


def test_span_stamps_share_the_profilers_clock():
    eng, reqs = _engine()
    _, step = _train("hymba-1.5b")
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(reqs)
        step()
    spans = tracing.collect()
    ranges = collections.defaultdict(list)
    for name, a, b in _annotations(prof):
        ranges[name].append((a, b))
    mine = collections.defaultdict(list)
    for s in spans:
        if s.name in NESTED:
            mine[s.name].append((s.start_ns, s.end_ns))
    assert set(mine) == set(NESTED)
    for name, stamps in mine.items():
        got = sorted(ranges[name])
        assert len(got) == len(stamps), name
        for (a, b), (ra, rb) in zip(sorted(stamps), got):
            assert abs(a - ra) <= 1_000_000 and abs(b - rb) <= 1_000_000, \
                (name, a - ra, b - rb)


def test_serve_spans_nest_and_time_the_queue():
    eng, reqs = _engine()
    tracing.enable()
    eng.run(reqs)
    spans = tracing.collect()
    (run,) = [s for s in spans if s.name == "serve/run"]
    # closed in the order the requests were admitted: the queue's
    queue = [s for s in spans if s.name == "serve/queue"]
    assert len(queue) == len(reqs)
    assert all(_parent(s, spans) is run for s in queue)
    for s in spans:
        if s.name in ("serve/prefill", "serve/decode", "serve/sync"):
            assert _parent(s, spans) is run
        if s.name == "serve/splice":
            assert _parent(s, spans).name == "serve/prefill"
    work = sorted((s for s in spans
                   if s.name in ("serve/prefill", "serve/decode")),
                  key=lambda s: s.start_ns)
    first, second = queue[:2], queue[2:]
    # the first wave is admitted before any work starts
    assert all(s.end_ns <= work[0].start_ns for s in first)
    # the second waits out the first wave's prefill and decode steps
    for s in second:
        before = [w for w in work if w.end_ns <= s.end_ns]
        assert [w.name for w in before] == ["serve/prefill"] + \
            ["serve/decode"] * 3
        assert s.host_ms >= sum(w.host_ms for w in before)
    assert all(s.device_ms is None for s in spans)      # no card here


def test_prefill_counters_give_the_useful_share():
    eng, reqs = _engine()
    eng.run(reqs)
    st = eng.stats
    sent = sum(min(n, PROMPT_LEN) for n in PROMPTS)          # 46
    assert st["prefill_calls"] == 2
    assert st["prefill_prompt_tokens"] == sent
    assert st["prefill_tokens"] == 2 * 2 * PROMPT_LEN
    assert st["prefill_prompt_tokens"] / st["prefill_tokens"] == 46 / 64


@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-130m", "hymba-1.5b"])
def test_train_step_spans_a_layer(arch):
    cfg, step = _train(arch)
    tracing.enable()
    step()
    step()
    spans = tracing.collect()
    count = collections.Counter(s.name for s in spans)
    L, steps = cfg.n_layers, 2
    want = {"train/step": steps, "train/forward": steps,
            "train/backward": steps, "train/optimizer": steps,
            "train/remat": L * steps}
    if cfg.has_attention:
        want["attention/backward"] = L * steps
    if cfg.has_ssm:
        want["ssd/backward"] = L * steps
    assert dict(count) == want
    for s in spans:
        p = _parent(s, spans)
        assert (p and p.name) == {
            "train/step": None, "train/forward": "train/step",
            "train/backward": "train/step",
            "train/optimizer": "train/step"}.get(s.name, "train/backward"), \
            s


def test_timed_collectives_keep_the_untimed_records():
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_host_mesh(device="cpu")
    try:
        group = mesh.get_group("model")
        x = torch.arange(6, dtype=torch.float32).reshape(2, 3)

        def issue():
            out = [cp.collective(t, t.lower(), x, group, dim=0)
                   for t in ("AllReduce", "AllGather")]
            with cp.recompute_region():
                out.append(cp.collective("ReduceScatter", "rs", x, group,
                                         dim=0))
            return out
        with cp.record_collectives() as plain:
            want = issue()
        with cp.record_collectives(timed=True) as timed:
            got = issue()
        assert list(timed) == list(plain) and \
            timed.recompute == plain.recompute
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        times = timed.times()
        assert [r for r, _ in times] == list(plain) + plain.recompute
        assert all(ms >= 0 for _, ms in times)
        assert tracing.collect() == []     # timing alone keeps no span
        tracing.enable()
        with cp.record_collectives() as untimed:
            issue()
        assert untimed.spans == []
        spans = tracing.collect()
        assert [s.name for s in spans] == ["collective/allreduce",
                                           "collective/allgather",
                                           "collective/rs"]
    finally:
        tmesh.destroy()


def test_mesh_step_spans_its_reduction():
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_host_mesh(device="cpu")
    try:
        cfg = get_smoke_config("glm4-9b").with_(dtype="float32")
        model = Model(cfg)
        state = init_train_state(model, model.init(0, device="cpu"), mesh)
        step = make_train_step(model, OptConfig(), mesh)
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
                 for k in ("tokens", "labels")}
        tracing.enable()
        step(state, batch)
        spans = tracing.collect()
    finally:
        tmesh.destroy()
    (reduce,) = [s for s in spans if s.name == "train/reduce"]
    assert _parent(reduce, spans).name == "train/step"
    # every gradient's All-Reduce and the norm's run inside it
    grads = [s for s in spans if s.name.startswith("collective/grads/")]
    assert grads and all(_parent(s, spans) is reduce for s in grads)
