"""Batch generation from a backlog: `PagedInferenceEngine.run` over
requests all due at the start, more than the window can serve.

Set-up: the seed's weights, quantized; the engine; its prefill variants
(`warmup` over the traffic's buckets) and one short serve of `warmup`
requests through `run`, which builds and loads every kernel the window's
windows and admissions use. The window: `run` on the backlog, closed at the
end of the first decode window that ends after `--seconds` (the harness
stops `run` there; requests in flight are left). `serve_tokens_per_s` is
every token the engine emitted in the window over the window's wall. The
check judges finished requests and those in flight at the close, on the
tokens they had emitted, so the long answers' later positions are judged
too.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench.bench import serving, traffic
from portbench.bench.trace import Tracer

CONTROL = serving.CONTROL
TRACE_FROM, TRACE_WINDOWS = 2, 2


class WindowClosed(Exception):
    pass


def run(ctx, precision=None):
    from flasht5_tpu_torch.inference.paged_engine import (
        PagedEngineConfig, PagedInferenceEngine)

    cell, dev, tr = ctx.cell, ctx.device, ctx.cell.traffic
    s_weights, s_req, s_sample = traffic.seeds(ctx.seed, 3)
    model_cfg, params = serving.served_params(cell, s_weights, dev)
    e = dict(tr["engine"])
    e["encode_buckets"] = tuple(e["encode_buckets"])
    ecfg = PagedEngineConfig(**e)
    engine = PagedInferenceEngine(model_cfg, params, ecfg, device=dev)
    engine.warmup()
    w = tr["warmup"]
    warm = serving.make_requests(
        cell, dict(tr["requests"],
                   new_tokens={"uniform": [w["new_tokens"]] * 2}),
        int(w["requests"]), s_req + 1)
    engine.run(warm)
    requests = serving.make_requests(cell, tr["requests"],
                                     int(tr["backlog"]), s_req)

    tracer = Tracer(ctx.trace_on and dev == "cuda")
    m = serving.model_args(cell)
    clock = {}

    def on_window(n):
        if time.perf_counter() >= clock["deadline"]:
            clock["end"] = time.perf_counter()
            raise WindowClosed

    stats = serving.install(engine, m, tracer, TRACE_FROM, TRACE_WINDOWS,
                            read_outputs=True, on_window=on_window,
                            fault=ctx.fault)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.perf_counter() - ctx.t_start
    t0 = time.perf_counter()
    clock["deadline"] = t0 + ctx.seconds
    try:
        engine.run(requests)
        clock["end"] = time.perf_counter()     # the backlog ran dry
    except WindowClosed:
        pass
    tracer.stop()
    wall = clock["end"] - t0
    if dev == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    finished = [r for r in requests if r.result is not None]
    in_flight = serving.running(stats, requests)
    pages_held = ecfg.num_pages - len(engine.state.pages.free)
    steps = stats["windows"] * ecfg.steps_per_sync
    # each decode step's weight products: a layer's self Wq, Wk, Wv, o and
    # cross Wq, o; wi_0, wi_1; wo; then the lm_head
    d, inner, dff = m["d_model"], m["num_heads"] * m["d_kv"], m["d_ff"]
    per_layer = [((d, inner), 6), ((d, dff), 2), ((dff, d), 1)]
    traced = stats["traced_steps"]
    n_dec = m.get("num_decoder_layers") or m["num_layers"]
    calls = [(dict(m=ecfg.max_slots, k=k, n=n), count * n_dec * traced)
             for (k, n), count in per_layer]
    calls.append((dict(m=ecfg.max_slots, k=d, n=m["vocab_size"]), traced))
    ctx.window = {
        "wall_s": wall, "tokens": stats["tokens"],
        "model_flops": stats["flops"], "windows": stats["windows"],
        "steps": steps, "window_s": stats["window_s"],
        "admissions": stats["admissions"],
        "deferrals": engine.deferrals, "finished": len(finished),
        "ops": {"decode_matmul": {"calls": calls, "spans": ["window"]}},
    }
    ctx.attempted = stats["admissions"]
    eos = model_cfg.eos_token_id
    ctx.failed = sum(len(r.result) == 0 or r.result[-1] != eos
                     for r in finished)
    ctx.trace = tracer.read()
    del engine, params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    budget_cap = ecfg.max_pages_per_slot * ecfg.page_size - 1
    serving.judge(ctx, finished,
                  lambda r: min(r.max_new_tokens, budget_cap),
                  int(tr["check"]["sample"]), s_sample, s_weights,
                  max(ecfg.encode_buckets), precision,
                  running_at_close=in_flight)
    # how the slots' mix drifts: long answers hold their slots past the
    # close, so the budgets in flight there outgrow the backlog's mean
    ctx.readings.update({
        "served_tokens_per_s": stats["tokens"] / wall,
        "steps": steps, "finished": len(finished),
        "admissions": stats["admissions"], "deferrals": ctx.window["deferrals"],
        "in_flight": len(in_flight),
        "in_flight_budget_mean": (
            float(np.mean([r.max_new_tokens for r, _ in in_flight]))
            if in_flight else 0.0),
        "backlog_budget_mean": float(np.mean(
            [r.max_new_tokens for r in requests])),
        "pages_held": pages_held, "pages": ecfg.num_pages,
        "backlog_ran_dry": "end" in clock and
        len(finished) == len(requests)})


def control(ctx, precision):
    run(ctx, precision)
