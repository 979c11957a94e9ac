"""What the serving cells share: the served weights, the requests, the
hooks the harness puts around the engines' layers, and the check of the
served tokens against the reference.

The weights are the seed's float32 tree (`bench/weights.py`), quantized by
the program at set-up (`quantize.quantize_params`, int8 per column). The
check runs once the window has closed and the engine is freed: a sample
drawn from the seed of the served sequences (finished requests, and those
still running at the close with the tokens they had emitted), with the
longest of each kind among them, goes through the reference
(`reference/t5_ref.py`) once each, teacher forced on its served tokens,
with the weights and caches in the precision the configuration states; the
number compared is the widest gap by which a served token's logit lies
below the reference's best at its position.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.bench import compare, traffic, weights
from portbench.bench.trace import span
from portbench.reference import t5_ref
from portbench.work import t5_model

# the control: the configuration states int8 weights and KV, so the
# reference in the program's place quantizes both to int4
CONTROL = t5_ref.Precision(weights="int4", kv="int4")


def model_args(cell) -> Dict:
    cfg = cell.config
    return dict(cfg["model_args"], vocab_size=int(cfg["vocab_size"]))


def reference_precision(cell) -> t5_ref.Precision:
    s = cell.config["serving"]
    return t5_ref.Precision(weights=s["weights"], kv=s["kv_dtype"])


def served_params(cell, seed: int, device):
    """(model config, the served tree): the seed's weights, quantized."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.quantize import quantize_params
    m = model_args(cell)
    cfg = FlashT5Config.from_dict(m).replace(
        dtype=cell.config["serving"]["dtype"])
    tree = weights.make(m, seed, device)
    served = quantize_params(tree, cell.config["serving"]["weights"])
    del tree
    gc.collect()
    return cfg, served


def make_requests(cell, spec: Dict, n: int, seed: int) -> List:
    from flasht5_tpu_torch.inference.engine import Request
    r = traffic.requests(spec, int(cell.config["vocab_size"]), n, seed)
    return [Request(uid=i, input_ids=r["input_ids"][i],
                    max_new_tokens=int(r["new_tokens"][i]),
                    arrival_s=float(r["arrival_s"][i])) for i in range(n)]


def install(engine, m: Dict, tracer, trace_from: int, trace_windows: int,
            read_outputs: bool, on_window=None, fault=None) -> Dict:
    """Spans, clocks and counts around an engine's layers; returns the dict
    they fill: prefill rows in the traced stretch, admissions, windows with
    their walls, and (`read_outputs`, for an engine whose windows return
    their tokens to the host) the tokens each window emitted with their
    analytic operations, and under "slots" each slot's request (its input
    ids, as `input_key` gives them) with the tokens it has emitted so far
    and whether it has finished. The tracer runs over windows trace_from ..
    trace_from + trace_windows - 1; `on_window(n)` runs after the n-th."""
    st = {"windows": 0, "window_s": 0.0, "tokens": 0, "admissions": 0,
          "prefill_rows": [], "flops": 0.0, "traced_steps": 0, "slots": {}}
    pos, enc_len, encoded = {}, {}, {}
    slots = st["slots"]
    encode, insert, window = engine._encode, engine._insert, engine._window

    def _encode(ids):
        with span("prefill"):
            if tracer.active:
                st["prefill_rows"].append(ids.shape[0] * ids.shape[1])
            if read_outputs:
                encoded["ids"] = ids
            return encode(ids)

    def _insert(cross, row, slot, length, *rest):
        st["admissions"] += 1
        pos[slot], enc_len[slot] = 0, length
        if read_outputs:
            st["flops"] += t5_model.encode_flops(m, length)
            slots[slot] = {"key": input_key(encoded["ids"][row]),
                           "tokens": [], "finished": False}
        return insert(cross, row, slot, length, *rest)

    def _window(*args):
        n = st["windows"]
        if n == trace_from:
            tracer.start()
        traced = tracer.active
        t = time.perf_counter()
        with span("window"):
            out = window(*args)
        st["window_s"] += time.perf_counter() - t
        st["windows"] += 1
        if traced:
            st["traced_steps"] += engine.ecfg.steps_per_sync
        if read_outputs:
            toks, fins, act = np.asarray(out)      # each (k, B)
            st["tokens"] += int(act.sum())
            for t, b in zip(*np.nonzero(act)):
                b = int(b)
                st["flops"] += t5_model.decode_token_flops(
                    m, pos.get(b, 0), enc_len.get(b, 0))
                pos[b] = pos.get(b, 0) + 1
                held = slots.get(b)
                # as the engine's scheduler reads a window: a slot's
                # tokens up to the step it finished at
                if held is not None and not held["finished"]:
                    held["tokens"].append(int(toks[t, b]))
                    held["finished"] = bool(fins[t, b])
        if n + 1 == trace_from + trace_windows:
            tracer.stop()
        if on_window is not None:
            on_window(n + 1)
        return out

    engine._encode, engine._insert, engine._window = \
        _encode, _insert, _window
    if fault == "token":
        plant_token_fault(engine)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return st


def input_key(ids) -> bytes:
    """A request's identity from its (zero-padded) input ids: the ids are
    drawn above the pad, so its trailing zeros are padding."""
    return np.trim_zeros(np.asarray(ids).astype(np.int32), "b").tobytes()


def running(stats: Dict, requests: List) -> List:
    """(request, tokens) of each slot still serving at the close, with the
    tokens it had emitted: every one chosen by the model."""
    by_key = {input_key(r.input_ids): r for r in requests}
    return [(by_key[h["key"]], h["tokens"])
            for h in stats["slots"].values()
            if not h["finished"] and h["tokens"]]


def plant_token_fault(engine) -> None:
    """A token altered where it is produced: every fifth decode step, each
    slot's token is moved to the next id, and fed back as such."""
    step = engine._step
    count = [0]

    def _step(*args):
        out = step(*args)
        count[0] += 1
        if count[0] % 5 == 0:
            tok = out[0]
            tok.copy_((tok + 1) % engine.config.vocab_size)
            engine.state.cur_token = torch.where(engine.state.active, tok,
                                                 engine.state.cur_token)
        return out
    engine._step = _step


def served(finished: List, budget, running_at_close=()) -> List:
    """What the check may judge: (request, tokens, how many of them the
    model chose, finished?) of each finished request, and of each one still
    running at the close (`running`)."""
    out = []
    for req in finished:
        res = np.asarray(req.result, np.int64)
        # a result cut at its budget ends in an EOS forced at the
        # boundary: no model chose it
        out.append((req, res, len(res) - 1 if len(res) >= budget(req)
                    else len(res), True))
    for req, toks in running_at_close:
        out.append((req, np.asarray(toks, np.int64), len(toks), False))
    return [o for o in out if o[2] > 0]


def judge(ctx, finished: List, budget, sample: int, sample_seed: int,
          weight_seed: int, pad_to: int, precision=None,
          running_at_close=()) -> None:
    """The served-token check on a seeded sample of what was served
    (`served`), with the longest finished and the longest running sequence
    in it; with `precision`, the control: the tokens judged are those that
    precision puts first at each position of the same sequences, and the
    program's own gap over them is the reading `served_gap_program`."""
    cell, dev = ctx.cell, ctx.device
    seqs = served(finished, budget, running_at_close)
    if not seqs:
        ctx.check("served_gap", float("inf"))
        return
    rng = np.random.default_rng(sample_seed)
    pick = []
    for done in (True, False):
        kind = [i for i, q in enumerate(seqs) if q[3] == done]
        if kind:
            pick.append(max(kind, key=lambda i: seqs[i][2]))
    rest = [i for i in range(len(seqs)) if i not in pick]
    pick += [int(i) for i in rng.choice(
        rest, size=max(0, min(sample - len(pick), len(rest))),
        replace=False)]
    m = dict(model_args(cell), pad_token_id=0)
    t5_ref.no_tf32()
    tree = weights.make(m, weight_seed, dev)
    ref_p = reference_precision(cell)
    prepared = t5_ref.prepare(tree, ref_p)
    control = None if precision is None else t5_ref.prepare(tree, precision)
    del tree
    worst, program_worst, tokens = 0.0, 0.0, 0
    with torch.no_grad():
        for i in pick:
            req, res, judged, _ = seqs[i]
            ids = np.zeros((1, pad_to), np.int64)
            n = min(len(req.input_ids), pad_to)
            ids[0, :n] = req.input_ids[:n]
            ids = torch.from_numpy(ids).to(dev)
            dec = torch.from_numpy(np.concatenate([[0], res[:-1]])[None]).to(
                dev)
            ref_logits = t5_ref.logits(prepared, ids, dec, m, ref_p)[0]
            toks = torch.from_numpy(res).to(dev)
            program_worst = max(program_worst, compare.served_gap(
                ref_logits[:judged], toks[:judged]))
            if control is not None:
                toks = t5_ref.logits(control, ids, dec, m, precision)[0] \
                    .argmax(-1)
            worst = max(worst, compare.served_gap(ref_logits[:judged],
                                                  toks[:judged]))
            tokens += judged
    ctx.check("served_gap", worst)
    ctx.readings.update({
        "sampled_requests": len(pick),
        "sampled_running": sum(1 for i in pick if not seqs[i][3]),
        "tokens_judged": tokens,
        "longest_judged": max(seqs[i][2] for i in pick)})
    if control is not None:
        ctx.readings["served_gap_program"] = program_worst
