"""Serving: a closed loop of submissions into ``ServeEngine.run``.

Set-up makes the weights from the seed, builds the engine (which warms
its plans) and serves one short warm-up submission, so that every shape
the window uses is built.  The window hands the engine one submission of
``submission`` requests at a time and the next when ``run`` returns,
until ``--seconds`` have passed; the window closes when the last
submission returns.  A request's time to first token runs from when its
submission was handed to the engine to the first token appended to its
output (a list that stamps its first append).

Correctness: once the window has closed, a sample of the finished
requests drawn from the seed (the one with the longest prompt among
them) is run through the float32 reference, over the prompt as the
engine padded it and the tokens the engine produced, and each produced
token's logit is compared with the reference's best at its position: the
widest gap is held to the limit.  The token the prefill produced, which
the engine feeds to the first decode step but does not return, is read
from the decode calls' inputs.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

import counts
import data
import harness
from reference.model import Ref, strict_f32
from reference.params import dims, make_weights

STAMP = time.perf_counter


class StampedOutput(list):
    """A request's output list that notes when and at which decode step
    its first token was appended."""

    def __init__(self, clock):
        super().__init__()
        self.clock, self.first_t, self.first_step = clock, None, None

    def append(self, tok):
        if self.first_t is None:
            self.first_t, self.first_step = STAMP(), self.clock[0]
        super().append(tok)


def _requests(ctx, stream: int, index: int, n: int, new: int, clock):
    from repro_torch.serve.engine import Request
    t = ctx.traffic
    prompts = data.submission(ctx.seed, stream, index, n, t["prompt_min"],
                              t["prompt_max"], ctx.config["vocab_size"])
    return [Request(rid=index * n + i, prompt=p, max_new_tokens=new,
                    output=StampedOutput(clock))
            for i, p in enumerate(prompts)]


def _served(req, padded: np.ndarray, inputs, prefills):
    """The token the prefill produced for a finished request: the decode
    input, at the request's first decode step, of the slot that the last
    prefill before that step filled with the request's prompt."""
    k = req.output.first_step
    if k is None or k > len(inputs):
        return None
    for at, toks in reversed(prefills):
        if at >= k:
            continue
        rows = np.nonzero((toks == padded).all(1))[0]
        if len(rows) != 1:
            return None
        return int(inputs[k - 1][rows[0]])
    return None


def run(ctx: harness.Context) -> Dict:
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine

    t, cfg_d = ctx.traffic, ctx.config
    dev = ctx.device
    cuda = dev.type == "cuda"
    weights = make_weights(cfg_d, ctx.seed, dev)
    model = Model(harness.program_config(cfg_d))
    engine = ServeEngine(model, weights, batch_size=t["slots"],
                         cache_len=t["cache_len"], prompt_len=t["prompt_len"])
    spans = harness.Spans(cuda)
    # the decode calls' inputs and the prefill calls' prompts, kept as the
    # engine passed them, to trace a checked request back to its slot
    clock = [0]                   # decode calls so far
    inputs: List[torch.Tensor] = []
    prefills: List = []
    decode, prefill = model.decode, model.prefill

    def logged_decode(params, cache, tokens, *a, **k):
        clock[0] += 1
        inputs.append(tokens[:, 0])
        return decode(params, cache, tokens, *a, **k)

    def logged_prefill(params, batch, *a, **k):
        prefills.append((clock[0], batch["tokens"]))
        return prefill(params, batch, *a, **k)
    model.decode, model.prefill = logged_decode, logged_prefill
    if ctx.trace:
        model.decode = spans.wrap("decode", logged_decode)
        model.prefill = spans.wrap("prefill", logged_prefill)

    engine.run(_requests(ctx, 1, 0, t["warmup_requests"],
                         t["warmup_new_tokens"], clock))
    if cuda:
        torch.cuda.synchronize()
    setup_s = harness.process_age_s()

    window: List = []
    spans.on, steps = True, clock[0]
    t0 = STAMP()
    index = 0
    subs = []
    while STAMP() - t0 < ctx.seconds:
        reqs = _requests(ctx, 0, index, t["submission"], t["new_tokens"],
                         clock)
        handed = STAMP()
        engine.run(reqs)
        subs.append(STAMP() - handed)
        window.extend((handed, r) for r in reqs)
        index += 1
    window_s = STAMP() - t0
    spans.on, steps = False, clock[0] - steps

    trace = None
    z = dims(cfg_d)
    fa_calls = None
    if ctx.trace and cuda:
        extra = iter(range(2, 4))
        stretches = []

        def one_submission():
            before = len(prefills)
            engine.run(_requests(ctx, next(extra), 0, t["submission"],
                                 t["new_tokens"], clock))
            stretches.append(prefills[before:])
        trace = harness.traced(one_submission)
        # each prefill of the device-traced stretch at the prompts its rows
        # held: prompt tokens are drawn from [1, vocab), so a row's nonzero
        # tokens are its prompt and the zeros its padding (or an idle slot)
        fa_calls = [{"Hq": z["H"], "Hkv": z["Hkv"], "D": z["hd"],
                     "window": cfg_d.get("window"),
                     "lengths": (toks != 0).sum(1).tolist()}
                    for _, toks in stretches[0]]
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    done = [(h, r) for h, r in window
            if r.done and len(r.output) == t["new_tokens"]]
    ttft = [r.output.first_t - h for h, r in done]
    sent = sum(min(len(r.prompt), t["prompt_len"]) for _, r in done)
    generated = sum(len(r.output) for _, r in done)
    flops = sum(counts.serve_request_flops(
        cfg_d, min(len(r.prompt), t["prompt_len"]), len(r.output))
        for _, r in done)
    record = harness.Record(
        cell=ctx.cell, config=cfg_d, traffic=t, chips=1, window_s=window_s,
        spans={k: spans.seconds(k) for k in ("prefill", "decode")},
        counters={"window_decode_steps": steps,
                  "plan_warmup_s": engine.stats["plan_warmup_s"],
                  "model_flops": flops, "fa_calls": fa_calls},
        trace=trace)

    # ------------------------------------------------ the check
    t_check = STAMP()
    del engine
    sample, unmatched = _sample(ctx, done, inputs, prefills)
    gaps = _gaps(ctx, weights, sample)
    checks = [("logit_gap", gaps["program"], ctx.limits["logit_gap"]),
              ("unmatched", float(unmatched), ctx.limits["unmatched"]),
              ("unfinished", float(len(window) - len(done)),
               ctx.limits["unfinished"])]
    e2e = {"setup_s": setup_s,
           "serve_tok_s": (sent + generated) / window_s,
           "ttft_p95_ms": 1e3 * harness.percentile(ttft, 0.95)
           if ttft else float("nan")}
    return {"e2e": e2e, "record": record, "attempted": len(window),
            "failed": len(window) - len(done), "checks": checks,
            "memory_peak_bytes": peak, "readings": gaps,
            "timing": {"setup_s": setup_s, "window_s": window_s,
                       "check_s": STAMP() - t_check,
                       "submissions_s": subs}}


def _sample(ctx, done, inputs, prefills):
    """The checked requests' token rows (prompt as padded, the prefill's
    token, the produced tokens but the last) and the produced tokens, and
    how many sampled requests could not be traced back to their slot."""
    t = ctx.traffic
    n = min(t["check_requests"], len(done))
    if n == 0:
        return [], t["check_requests"]
    rng = np.random.default_rng(np.random.SeedSequence([ctx.seed, 9]))
    longest = max(range(len(done)), key=lambda i: len(done[i][1].prompt))
    rest = [i for i in range(len(done)) if i != longest]
    pick = [longest] + list(rng.choice(rest, size=n - 1, replace=False)) \
        if n > 1 else [longest]
    host = [x.cpu().numpy() for x in inputs]
    pre = [(at, x.cpu().numpy()) for at, x in prefills]
    rows, unmatched = [], 0
    for i in pick:
        r = done[i][1]
        prompt = np.zeros(t["prompt_len"], np.int64)
        p = r.prompt[-t["prompt_len"]:]
        prompt[-len(p):] = p
        first = _served(r, prompt, host, pre)
        if first is None:
            unmatched += 1
            continue
        rows.append((np.concatenate([prompt, [first], list(r.output[:-1])]),
                     [first] + list(r.output)))
    return rows, unmatched


def _gaps(ctx, weights, sample) -> Dict:
    """The widest gap between the reference's best logit and the logit of
    a produced token, over the sample; with ``ctx.control`` also the gap of
    the token that the float8 reference puts first at each position."""
    strict_f32()
    V = ctx.config["vocab_size"]
    ref = Ref(ctx.config, weights)
    low = Ref(ctx.config, weights, lowp="fp8") if ctx.control else None
    worst, worst_low = 0.0, 0.0
    for row, produced in sample:
        toks = torch.as_tensor(row, device=ctx.device)[None]
        n = len(produced)
        lg = ref.last_logits(toks, n)[0, :, :V]
        best = lg.max(-1).values
        got = lg.gather(-1, torch.as_tensor(produced, device=ctx.device)
                        [:, None])[:, 0]
        worst = max(worst, float((best - got).max()))
        if low is not None:
            pick = low.last_logits(toks, n)[0, :, :V].argmax(-1)
            worst_low = max(worst_low, float(
                (best - lg.gather(-1, pick[:, None])[:, 0]).max()))
    out = {"program": worst}
    if low is not None:
        out["control"] = worst_low
    return out
