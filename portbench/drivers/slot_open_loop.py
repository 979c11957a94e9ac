"""Prompt traffic in an open loop: `InferenceEngine.run` (the slot engine)
over requests due at Poisson arrival times, at the rate the traffic file
fixes.

Set-up: the seed's weights, quantized; the engine; its prefill variants
(`warmup` over the traffic's buckets, with one decode window) and one short
serve of `warmup` requests through `run`. The window: `run` on the
requests due over `--seconds`, to the last one's end. Each request is timed
from the moment it was due: `ttft_p95_ms` over `first_token_at -
arrival_s`, `latency_p95_ms` over `finished_at - arrival_s`, every request
counted (one that never finished counts as infinitely late).
"""

from __future__ import annotations

import gc
import time

import torch

from portbench.bench import serving, traffic
from portbench.bench.trace import Tracer
from portbench.work import t5_model

CONTROL = serving.CONTROL
TRACE_FROM, TRACE_WINDOWS = 10, 2


def setup(ctx):
    """The engine on the seed's quantized weights, warmed: every prefill
    variant, a decode window, and one short serve through `run`."""
    from flasht5_tpu_torch.inference.engine import (EngineConfig,
                                                    InferenceEngine)

    cell, tr = ctx.cell, ctx.cell.traffic
    s_weights, s_req, _ = traffic.seeds(ctx.seed, 3)
    model_cfg, params = serving.served_params(cell, s_weights, ctx.device)
    e = dict(tr["engine"])
    e["encode_buckets"] = tuple(e["encode_buckets"])
    engine = InferenceEngine(model_cfg, params, EngineConfig(**e),
                             device=ctx.device)
    engine.warmup()
    engine.run(serving.make_requests(
        cell, dict(tr["requests"], rate_per_s=None),
        int(tr["warmup"]["requests"]), s_req + 1))
    return engine


def due(ctx, rate: float):
    """The requests due over the window at `rate` a second."""
    tr = ctx.cell.traffic
    n = max(1, int(round(rate * ctx.seconds)))
    return serving.make_requests(ctx.cell, dict(tr["requests"],
                                                rate_per_s=rate), n,
                                 traffic.seeds(ctx.seed, 3)[1])


def run(ctx, precision=None):
    cell, dev, tr = ctx.cell, ctx.device, ctx.cell.traffic
    s_weights, _, s_sample = traffic.seeds(ctx.seed, 3)
    engine = setup(ctx)
    model_cfg, params, ecfg = engine.config, engine.params, engine.ecfg
    requests = due(ctx, tr["requests"]["rate_per_s"])

    tracer = Tracer(ctx.trace_on and dev == "cuda")
    m = serving.model_args(cell)
    stats = serving.install(engine, m, tracer, TRACE_FROM, TRACE_WINDOWS,
                            read_outputs=False, fault=ctx.fault)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.perf_counter() - ctx.t_start
    t0 = time.perf_counter()
    engine.run(requests, now=time.perf_counter)
    wall = time.perf_counter() - t0
    tracer.stop()
    if dev == "cuda":
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated()
    finished = [r for r in requests if r.result is not None]
    d, inner, dff = m["d_model"], m["num_heads"] * m["d_kv"], m["d_ff"]
    n_enc = m["num_layers"]
    n_dec = m.get("num_decoder_layers") or n_enc
    # each prefill row's weight products: an encoder layer's Wq, Wk, Wv, o;
    # wi_0, wi_1; wo; and each decoder layer's cross Wk, Wv
    calls = []
    for rows in stats["prefill_rows"]:
        calls += [(dict(m=rows, k=d, n=inner), 4 * n_enc + 2 * n_dec),
                  (dict(m=rows, k=d, n=dff), 2 * n_enc),
                  (dict(m=rows, k=dff, n=d), n_enc)]
    flops = sum(t5_model.encode_flops(m, len(r.input_ids))
                + t5_model.decode_flops(m, len(r.result), len(r.input_ids))
                for r in finished)
    late = [None if r.first_token_at is None else
            r.first_token_at - r.arrival_s for r in requests]
    ctx.window = {
        "wall_s": wall, "requests": len(requests), "finished": len(finished),
        "tokens": sum(len(r.result) for r in finished),
        "model_flops": flops, "windows": stats["windows"],
        "window_s": stats["window_s"], "admissions": stats["admissions"],
        "ttft_s": late,
        "latency_s": [None if r.finished_at is None else
                      r.finished_at - r.arrival_s for r in requests],
        "queue_s": [None if r.admitted_at is None else
                    r.admitted_at - r.arrival_s for r in requests],
        "ops": {"prefill_matmul": {"calls": calls, "spans": ["prefill"]}},
    }
    ctx.attempted = len(requests)
    ctx.failed = len(requests) - len(finished) + sum(
        len(r.result) == 0 or r.result[-1] != model_cfg.eos_token_id
        for r in finished)
    ctx.trace = tracer.read()
    del engine, params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    serving.judge(ctx, finished,
                  lambda r: min(r.max_new_tokens, ecfg.max_decode_len - 1),
                  int(tr["check"]["sample"]), s_sample, s_weights,
                  max(ecfg.encode_buckets), precision)
    ctx.readings.update({"requests": len(requests),
                         "finished": len(finished),
                         "last_due_s": requests[-1].arrival_s,
                         "wall_s": wall})


def control(ctx, precision):
    run(ctx, precision)
