#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (`flasht5_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (`nvcc`) and Triton; imports nothing
of JAX. In order:

1. prints the environment and the card's name and power limit;
2. builds the CUDA kernels from `flasht5_tpu_torch/csrc/` (one `nvcc` per
   source, all started together);
3. holds each of the serving path's four kernels against its plain PyTorch
   version on the card, at the shapes the full-width engine gives it, and
   times the kernel, the plain version and, where one exists, the one
   PyTorch call that computes the same function (`library_ms`, a yardstick
   the port never calls);
4. checks on a tiny model that the engine on the card serves the tokens the
   engine on the CPU (the plain versions) serves, and that two planted
   faults move its logits beyond the tolerance;
5. times a full-width FAT5-small decode step (seeded random weights, int8
   weights and KV cache, the decode kernel) by wall clock and by device
   time, and lists the kernels one decode window launches (`torch.profiler`);
6. serves 16 requests of 512 random tokens with that engine, three times,
   with every launch count set to 0 just before each run and read just
   after; every kernel must have launched in each;
7. prints one JSON line of the kernels, the `nvidia-smi` name and power
   limit line, and, last, {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line. Times are device times from CUDA events over back-to-back launches
(queued behind a `torch.cuda._sleep` so the host's launch cost is not
timed), with the inputs rotated over enough copies to exceed the 50 MB L2,
as the engine finds its weights and caches cold.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}
BF16_ULP = 2.0 ** -7           # one bf16 ulp, relative to the value
L2_BYTES = 50 * 2 ** 20


def sh(*cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_CYCLES_PER_MS = None


def _cycles_per_ms() -> float:
    global _CYCLES_PER_MS
    if _CYCLES_PER_MS is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS = 10_000_000 / start.elapsed_time(end)
    return _CYCLES_PER_MS


def device_ms(fn, arg_sets, iters: int) -> float:
    """Device time of one call of `fn`, over `iters` back-to-back calls
    cycling through `arg_sets`."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for args in arg_sets[:4]:
        fn(*args)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / min(4, len(arg_sets))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_cycles_per_ms() * (2.0 * host_ms * iters + 5.0)))
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def copies_for(make, n_bytes: int):
    """Enough independent input sets to exceed twice the L2 cache."""
    n = max(2, min(512, -(-2 * L2_BYTES // max(n_bytes, 1))))
    return [make() for _ in range(n)]


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def check_kernels(dev):
    """Each case's `make()` gives one input set: (kernel args, library
    args); the kernel and its plain version take the first, the library
    call the second (its inputs in the form it wants them, made outside
    the timing)."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.ops import (decode_attention, flash_attention_rpe,
                                       quant, rmsnorm)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    cases = []

    # -- A. rms_norm (Triton): every pre-norm and final norm --------------
    def rms_case(rows, label):
        d = 512

        def make():
            x = randn(rows, d)
            w = (1 + 0.1 * randn(d, dtype=torch.float32)).to(torch.bfloat16)
            return (x, w), (x, w)
        (x, w), _ = make()
        cases.append(dict(
            name="rms_norm", label=label, make=make, in_bytes=nbytes(x, w),
            kernel=lambda x, w: rmsnorm.rms_norm_fwd(x, w, 1e-6),
            plain=lambda x, w: rmsnorm.rms_norm_plain(x, w, 1e-6),
            library=((lambda x, w: F.rms_norm(x, (d,), w, 1e-6))
                     if hasattr(F, "rms_norm") else None),
            atol=1e-6, rtol=BF16_ULP, bytes=nbytes(x, w) + nbytes(x)
            + rows * 4, ops=4 * rows * d, ops_type="f32", main=rows == 8,
            why="bf16 output: one bf16 ulp (rstd by another sqrt)"))

    rms_case(8 * 512, "prefill x (4096, 512) bf16")
    rms_case(8, "decode x (8, 512) bf16")

    # -- B. flash_attention_rpe forward (CUDA): encoder self-attention ----
    b, h, s, d = 8, 8, 512, 64

    def make_attn():
        q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
        table = randn(32, h, dtype=torch.float32, scale=0.5)
        bias = positional.t5_relative_bias(
            {"relative_attention_bias": table}, s, s, bidirectional=True
        ).to(torch.bfloat16)
        return (q, k, v, table), (q, k, v, bias)
    (q, k, v, table), _ = make_attn()
    cases.append(dict(
        name="flash_attention_rpe", label=f"prefill q,k,v ({b},{h},{s},{d}) "
        "bf16, bidirectional", make=make_attn,
        in_bytes=nbytes(q, k, v, table) + h * s * s * 2,
        kernel=lambda q, k, v, t: flash_attention_rpe.flash_attention_rpe_fwd(
            q, k, v, t),
        plain=lambda q, k, v, t: flash_attention_rpe.flash_attention_rpe_plain(
            q, k, v, t),
        library=lambda q, k, v, bias: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=1.0),
        atol=2e-2, rtol=BF16_ULP, bytes=nbytes(q, k, v, table) + nbytes(q)
        + b * h * s * 4 + (2 * s - 1) * 4, ops=4 * b * h * s * s * d,
        ops_type="bf16", main=True,
        why="bf16 output and P rounded to bf16 against per-tile maxima"))

    # -- C. quant_matmul (CUDA): every projection and the lm_head ---------
    def qmm_case(m, k_dim, n, label, main=False):
        def make():
            x = randn(m, k_dim)
            qt = quant.quantize_int8(
                randn(k_dim, n, dtype=torch.float32, scale=k_dim ** -0.5))
            return (x, qt), (x, quant.dequantize(qt, torch.bfloat16))
        (x, qt), _ = make()
        cases.append(dict(
            name="quant_matmul", label=label, make=make,
            in_bytes=nbytes(x, qt.qvalues, qt.scales) + k_dim * n * 2,
            kernel=quant.quant_matmul, plain=quant.quant_matmul_plain,
            library=torch.matmul,
            atol=1e-3, rtol=BF16_ULP,
            bytes=nbytes(x, qt.qvalues, qt.scales) + m * n * 2,
            ops=2 * m * k_dim * n, ops_type="bf16", main=main,
            why="bf16 output: one bf16 ulp, and fp32 sums in another order"))

    qmm_case(8, 512, 32768, "decode lm_head x (8, 512) @ int8 (512, 32768)")
    qmm_case(8, 512, 512, "decode Wq/Wk/Wv/o x (8, 512) @ int8 (512, 512)",
             main=True)
    qmm_case(8, 512, 2048, "decode wi_0/wi_1 x (8, 512) @ int8 (512, 2048)")
    qmm_case(8, 2048, 512, "decode wo x (8, 2048) @ int8 (2048, 512)")
    qmm_case(4096, 512, 2048,
             "prefill wi_0/wi_1 x (4096, 512) @ int8 (512, 2048)")
    qmm_case(4096, 512, 512, "prefill Wq/Wk/Wv/o x (4096, 512) @ int8 "
             "(512, 512)")
    qmm_case(4096, 2048, 512, "prefill wo x (4096, 2048) @ int8 (2048, 512)")

    # -- D. decode_attention (CUDA): decoder self- and cross-attention ----
    def dec_case(L, lengths, with_bias, label, main=False):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        valid = (torch.arange(L, device=dev)[None, :]
                 < lens[:, None])[:, None, None, :]

        def make():
            kq, ks = quant.quantize_kv(randn(8, 8, L, 64, dtype=torch.float32))
            vq, vs = quant.quantize_kv(randn(8, 8, L, 64, dtype=torch.float32))
            bias = (randn(8, 8, L, dtype=torch.float32) if with_bias
                    else None)
            q = randn(8, 8, 64)
            # the library call: SDPA over the same cache in bf16, with the
            # lengths and the bias folded into one additive mask
            mask = torch.where(valid, 0.0, -1e30)
            if bias is not None:
                mask = mask + bias[:, :, None, :]
            lib = (q[:, :, None], quant.dequantize_kv(kq, ks, torch.bfloat16),
                   quant.dequantize_kv(vq, vs, torch.bfloat16),
                   mask.to(torch.bfloat16))
            return (q, kq, vq, ks, vs, lens, bias), lib
        (q, kq, vq, ks, vs, _, bias), lib = make()
        used = sum(min(n, L) for n in lengths)     # positions read
        per_pos = 8 * (2 * 64 + 2 * 4 + (4 if with_bias else 0))
        cases.append(dict(
            name="decode_attention", label=label, make=make,
            in_bytes=nbytes(kq, vq, ks, vs, bias, *lib),
            kernel=lambda q, kq, vq, ks, vs, lens, bias:
                decode_attention.decode_attention(
                    q, kq, vq, ks, vs, lengths=lens, bias=bias),
            plain=lambda q, kq, vq, ks, vs, lens, bias:
                decode_attention.decode_attention_plain(
                    q, kq, vq, ks, vs, lengths=lens, bias=bias),
            library=lambda q, k, v, mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0),
            atol=4e-3, rtol=BF16_ULP,
            bytes=used * per_pos + nbytes(q, lens) + nbytes(q),
            ops=4 * 8 * used * 64, ops_type="bf16", main=main,
            why="bf16 output: one bf16 ulp, and P from another exp"))

    dec_case(512, [512] * 8, False,
             "decode cross-attention q (8, 8, 64) bf16, int8 K/V "
             "(8, 8, 512, 64), lengths 512", main=True)
    dec_case(66, [1, 9, 17, 25, 33, 41, 49, 57], True,
             "decode self-attention q (8, 8, 64) bf16, int8 K/V "
             "(8, 8, 66, 64), bias, lengths 1..57")

    results = []
    for c in cases:
        sets = copies_for(c["make"], c["in_bytes"])
        arg_sets = [a for a, _ in sets]
        got = c["kernel"](*arg_sets[0])
        want = c["plain"](*arg_sets[0])
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{c['name']} ({c['label']}): non-finite")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        over = diff - (c["atol"] + c["rtol"] * want.float().abs())
        if not float(over.max()) <= 0.0:
            raise AssertionError(f"{c['name']} ({c['label']}): max abs err "
                                 f"{err}, beyond atol {c['atol']} + rtol "
                                 f"{c['rtol']} by {float(over.max())}")
        iters = 200 if c["bytes"] < 64 * 2 ** 20 else 50
        ms = device_ms(c["kernel"], arg_sets, iters)
        plain_ms = device_ms(c["plain"], arg_sets, max(10, iters // 4))
        lib_ms = (device_ms(c["library"], [lb for _, lb in sets], iters)
                  if c["library"] is not None else None)
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = c["ops"] / PEAK_OPS_PER_S[c["ops_type"]] * 1e3
        row = dict(name=c["name"], shape=c["label"], main=c["main"],
                   max_abs_err=err, atol=c["atol"], rtol=c["rtol"],
                   tol_reason=c["why"], ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=c["bytes"], ops=c["ops"])
        print("kernel-check " + json.dumps(row), flush=True)
        results.append(row)
        del sets, arg_sets
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


SMALL_LOGIT_TOL = 5e-2


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _planted_faults():
    """Small faults in what the card's kernels are given, each of which a
    check of the engine must catch: (name, context manager)."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.inference import engine
    from flasht5_tpu_torch.ops import decode_attention as da
    from flasht5_tpu_torch.ops import flash_attention_rpe as fa

    def shifted_lut(*args, num_buckets, **kw):
        lut = positional.bucket_lut(*args, num_buckets=num_buckets, **kw)
        return (lut + 1).clamp(max=num_buckets - 1)

    def short_lengths(q, k, v, k_scales=None, v_scales=None, lengths=None,
                      **kw):
        return da.decode_attention(q, k, v, k_scales, v_scales,
                                   (lengths - 1).clamp(min=0), **kw)

    return [
        ("flash_attention_rpe reads the bucket one above",
         _patched(fa, "positional", types.SimpleNamespace(
             bucket_lut=shifted_lut,
             t5_relative_bias=positional.t5_relative_bias))),
        ("decode_attention reads one position too few",
         _patched(engine, "decode_attention", short_lengths)),
    ]


def _forced_logits(eng, reqs, tokens, slots):
    """Teacher-forced logits along `tokens`, `slots` requests at a time:
    {(request, step): fp32 logits}."""
    out = {}
    for first in range(0, len(tokens), slots):
        group = list(range(first, min(first + slots, len(tokens))))
        for slot, i in enumerate(group):
            eng.admit_request(reqs[i], slot)
        token = np.zeros((slots,), np.int32)
        for t in range(max(len(tokens[i]) for i in group)):
            _, logits = eng.probe_step(token_override=token)
            for slot, i in enumerate(group):
                if t < len(tokens[i]):
                    out[i, t] = logits[slot]
                    token[slot] = tokens[i][t]
    return out


def check_small_reference(dev):
    """A tiny f32 model with int8 weights and KV, served by the engine on the
    card (the kernels) and on the CPU (their plain versions).

    Both round activations to bf16 before each dequant matmul, at the same
    points; a value that differs by an f32 ulp (another summation order) can
    round to the other side of a bf16 boundary and move by 2^-8, and such
    flips cascade through the four layers. So logits (up to about 4 here)
    agree to a few bf16 ulps, not exactly. SMALL_LOGIT_TOL sits between
    that agreement and the logit gap of each planted fault (a bucket one
    off, a decode length one short), both read in the same run: a fault
    within the tolerance fails the check. Greedy tokens may part where two
    logits are closer than that. So: (1) teacher-forced along the CPU's
    tokens, every step's logits agree within the tolerance, and the card
    picks the CPU's token wherever the CPU's top-two margin exceeds twice
    it; (2) `run` on the card serves each request the CPU's tokens up to the
    first step, if any, where that margin is within twice the tolerance;
    (3) under each planted fault, the card's logits move by more than the
    tolerance."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import engine
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params

    cfg = FlashT5Config(vocab_size=512, d_model=128, d_kv=32, num_heads=4,
                        d_ff=256, num_layers=2, num_decoder_layers=2,
                        dropout_rate=0.0, attention_scale=1.0,
                        dtype="float32", attention_type="pallas_rpe",
                        use_fused_layernorm=True)
    cpu_params = quantize_params(t5.init_params(cfg, seed=3, device="cpu"))
    gpu_params = _to(cpu_params, dev)
    slots = 3
    ecfg = engine.EngineConfig(max_slots=slots, max_decode_len=10,
                               max_encode_len=32, encode_buckets=(16, 32),
                               kv_dtype="int8", steps_per_sync=4,
                               use_decode_kernel=True)
    rng = np.random.default_rng(0)
    ids = [rng.integers(2, 512, size=(n,)).astype(np.int32)
           for n in (12, 30, 7, 25, 16)]

    def reqs():
        return [engine.Request(uid=i, input_ids=x, max_new_tokens=8)
                for i, x in enumerate(ids)]

    want = engine.InferenceEngine(cfg, cpu_params, ecfg, device="cpu")
    got = engine.InferenceEngine(cfg, gpu_params, ecfg, device=dev)
    cpu_out = [r.result for r in want.run(reqs())]
    card_out = [r.result for r in got.run(reqs())]

    # (1) teacher forcing
    want_l = _forced_logits(want, reqs(), cpu_out, slots)
    got_l = _forced_logits(got, reqs(), cpu_out, slots)
    margins = {key: float(np.diff(np.sort(lw)[-2:])[0])
               for key, lw in want_l.items()}
    for key, lw in want_l.items():
        lg = got_l[key]
        if margins[key] > 2 * SMALL_LOGIT_TOL and lg.argmax() != lw.argmax():
            raise AssertionError(f"request, step {key}: card token "
                                 f"{lg.argmax()} != cpu {lw.argmax()} at "
                                 f"margin {margins[key]}")

    def gap(logits):
        return max(float(np.abs(logits[key] - lw).max())
                   for key, lw in want_l.items())

    worst = gap(got_l)
    if not worst <= SMALL_LOGIT_TOL:
        raise AssertionError(f"tiny engine logits: card vs cpu {worst} > "
                             f"{SMALL_LOGIT_TOL}")

    # (2) the served tokens
    equal = 0
    for i, (a, b) in enumerate(zip(cpu_out, card_out)):
        if b is None or b[-1] != cfg.eos_token_id:
            raise AssertionError(f"request {i}: card result {b}")
        n = min(len(a), len(b))
        parted = next((t for t in range(n) if a[t] != b[t]), None)
        if parted is None and len(a) == len(b):
            equal += 1
        elif parted is None or margins[i, parted] > 2 * SMALL_LOGIT_TOL:
            raise AssertionError(f"request {i}: card {b.tolist()} != cpu "
                                 f"{a.tolist()}")
    print(f"small-reference: teacher-forced logits card vs cpu max abs diff "
          f"{worst} (tol {SMALL_LOGIT_TOL}); {equal} of {len(ids)} requests "
          f"served token-equal, the rest parted at a top-two margin within "
          f"{2 * SMALL_LOGIT_TOL}", flush=True)

    # (3) planted faults
    for name, fault in _planted_faults():
        with fault:
            fault_gap = gap(_forced_logits(got, reqs(), cpu_out, slots))
        print(f"small-reference: planted fault, {name}: logits card vs cpu "
              f"max abs diff {fault_gap} (tol {SMALL_LOGIT_TOL})", flush=True)
        if not fault_gap > SMALL_LOGIT_TOL:
            raise AssertionError(f"planted fault ({name}) moves the logits "
                                 f"by {fault_gap}, within the tolerance")


def run_engine(dev):
    """The main path: the full-width FAT5-small engine serving requests."""
    from flasht5_tpu_torch import flagship_config, ops
    from flasht5_tpu_torch.inference import engine
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params

    cfg = flagship_config()
    t0 = time.perf_counter()
    params = quantize_params(t5.init_params(cfg, seed=0, device=dev), "int8")
    torch.cuda.synchronize()
    n_req, enc_len, max_new, slots = 16, 512, 64, 8
    ecfg = engine.EngineConfig(max_slots=slots, max_decode_len=max_new + 2,
                               max_encode_len=enc_len,
                               encode_buckets=(enc_len,), kv_dtype="int8",
                               steps_per_sync=8, use_decode_kernel=True)
    eng = engine.InferenceEngine(cfg, params, ecfg, device=dev)
    eng.warmup()
    torch.cuda.synchronize()
    print(f"engine: FAT5-small {cfg.num_layers}+{cfg.num_decoder_layers} "
          f"layers d_model {cfg.d_model} vocab {cfg.vocab_size} "
          f"{cfg.dtype}, int8 weights + int8 KV + decode kernel; init, "
          f"quantize and warmup {time.perf_counter() - t0:.3f} s",
          flush=True)

    # launches of one prefill (8 x 512) and one decode step
    ops.reset_launch_counts()
    eng._encode(np.zeros((slots, enc_len), np.int32))
    per_prefill = ops.launch_counts()
    torch.cuda.synchronize()

    def fill_slots():
        # every slot decoding with a full cross length, positions at 0
        st = eng.state
        st.enc_len.fill_(enc_len)
        st.pos = torch.zeros_like(st.pos)
        st.budget = torch.full_like(st.budget, max_new)
        st.active = torch.ones_like(st.active)
        torch.cuda.synchronize()

    k = ecfg.steps_per_sync
    fill_slots()
    ops.reset_launch_counts()
    eng._window()
    torch.cuda.synchronize()
    per_step = {name: n / k for name, n in ops.launch_counts().items()}
    print("launches per prefill (8 x 512): " + json.dumps(per_prefill)
          + "; per decode step: " + json.dumps(per_step), flush=True)

    # a decode window as the engine runs it (host-paced), and one step
    # queued behind a sleep so the device never waits for the host (one
    # step's few hundred launches fit the launch queue; a window's do not)
    walls, busys = [], []
    for _ in range(3):
        fill_slots()
        t1 = time.perf_counter()
        _, event = eng._window()
        event.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3 / k)
        fill_slots()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(_cycles_per_ms() * (2.0 * walls[-1] + 5.0)))
        start.record()
        eng._step(eng.state.cur_token)
        end.record()
        end.synchronize()
        busys.append(start.elapsed_time(end))
    step = dict(wall_ms=sum(walls) / 3, device_ms=sum(busys) / 3)
    step["device_idle_share"] = 1.0 - step["device_ms"] / step["wall_ms"]
    print(f"decode step ({slots} slots, cross length {enc_len}): "
          f"{json.dumps(step)} (wall: mean over 3 windows of {k} steps; "
          f"device: mean of 3 steps)", flush=True)

    # which kernels a decode step launches, and the device time of each by
    # name (the trace slows the host, so no wall time is read here)
    from torch.profiler import ProfilerActivity
    fill_slots()
    with torch.profiler.profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, event = eng._window()
        event.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    print("profile of one decode window: " + json.dumps({
        "kernels_per_step": sum(n for _, n in by_name.values()) / k,
        "top": [{"name": name[:80], "ms_per_step": t / k,
                 "launches_per_step": n / k}
                for name, (t, n) in top]}), flush=True)
    eng.state.active = torch.zeros_like(eng.state.active)

    # the same requests served three times, each a run of the main path
    rng = np.random.default_rng(0)
    inputs = [rng.integers(2, cfg.vocab_size, size=(enc_len,)).astype(
        np.int32) for _ in range(n_req)]
    runs = []
    for attempt in range(3):
        requests = [engine.Request(uid=i, input_ids=x, max_new_tokens=max_new)
                    for i, x in enumerate(inputs)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()

        tokens = 0
        for r in done:
            res = r.result
            if (res is None or not 1 <= len(res) <= max_new
                    or res[-1] != cfg.eos_token_id
                    or not ((res >= 0) & (res < cfg.vocab_size)).all()):
                raise AssertionError(f"request {r.uid}: bad result {res}")
            tokens += len(res)
        ttft = sorted(r.first_token_at for r in done)
        print(f"engine.run {attempt + 1} of 3: {n_req} requests x {enc_len} "
              f"tokens, {slots} slots, max_new {max_new}, steps_per_sync 8: "
              f"{tokens} tokens in {wall:.6f} s = {tokens / wall:.3f} "
              f"tokens/s; first token at {ttft[0]:.6f}..{ttft[-1]:.6f} s; "
              f"launches {json.dumps(launches)}", flush=True)
        missing = [name for name, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{missing}")
        runs.append(dict(tokens=tokens, seconds=wall,
                         tokens_per_s=tokens / wall, launches=launches))
    median = sorted(runs, key=lambda r: r["tokens_per_s"])[1]

    # one more teacher-forced step at full width: finite logits
    eng.admit_request(requests[0], 0)
    _, logits = eng.probe_step()
    if logits.shape != (slots, cfg.vocab_size) or not np.isfinite(
            logits[0]).all():
        raise AssertionError(f"full-width logits {logits.shape} not finite")
    return median["launches"], dict(
        tokens_per_s_median=median["tokens_per_s"],
        tokens_per_s=[r["tokens_per_s"] for r in runs],
        tokens=median["tokens"], seconds=median["seconds"],
        per_prefill=per_prefill, per_step=per_step, step=step)


# ---------------------------------------------------------------------------

KERNELS = {
    "rms_norm": ("triton", "flasht5_tpu_torch/ops/rmsnorm.py",
                 "flasht5_tpu/ops/rmsnorm.py:85"),
    "flash_attention_rpe": ("cuda",
                            "flasht5_tpu_torch/csrc/flash_attention_rpe.cu",
                            "flasht5_tpu/ops/flash_attention_rpe.py:489"),
    "quant_matmul": ("cuda", "flasht5_tpu_torch/csrc/quant_matmul.cu",
                     "flasht5_tpu/ops/quant.py:196"),
    "decode_attention": ("cuda", "flasht5_tpu_torch/csrc/decode_attention.cu",
                         "flasht5_tpu/ops/decode_attention.py:285"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from flasht5_tpu_torch import runtime

    import triton
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader").splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} triton {triton.__version__}")
    print(" / ".join(sh(runtime.nvcc_path(), "--version").splitlines()[-2:]))
    print(f"card: {smi}", flush=True)

    t0 = time.perf_counter()
    built = runtime.build_kernels()
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"built lib{name}.so in {info['seconds']:.3f} s; ptxas: "
              + " | ".join(regs[:12]))
    print(f"kernel build {time.perf_counter() - t0:.3f} s", flush=True)

    checks = check_kernels(dev)
    check_small_reference(dev)
    launches, served = run_engine(dev)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        main_case = next(r for r in checks
                         if r["name"] == name and r["main"])
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=main_case["max_abs_err"],
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], shape=main_case["shape"]))
    print(json.dumps({"engine": served}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
