#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / H100 port (`flasht5_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (`nvcc`) and Triton; imports nothing
of JAX. In order:

1. prints the environment and the card's name and power limit;
2. builds the CUDA kernels from `flasht5_tpu_torch/csrc/` (one `nvcc` per
   source, all started together), and holds wgmma's MN-major operand (the
   descriptor the bf16 attention kernels read V, K, Q and dO through)
   alone against torch.matmul, b's rows rolled by one beyond its limit;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the full-width serving engine, generation, train step,
   pretraining driver and scoring path give it, and times
   the kernel, the plain version and, where one exists, the one PyTorch
   call that computes the same function (`library_ms`, a yardstick the port
   never calls; for the fused lm_head+CE kernels the two calls F.linear
   and F.cross_entropy, with the port's own unfused path beside them);
   each output is held entry by entry to a stated limit, and
   faults planted in the `rms_norm` kernels (the last row of x taken from
   the first; the last row's rstd doubled; dy zeroed on the rows of the
   backward's last CTA), the attention forward (the keys rolled by one
   position), `quant_matmul` (each column's scales taken from its
   neighbour; at decode also the last K split left out of the
   reduction), the attention backward (the bucket one above; the keys
   rolled by one without a table; dq, dk and dv held to limits derived
   from the rounding points, `grad_limits`), the
   cross-entropy forward (the loss in its epilogue; labels one column
   off), the cross-entropy backward (its small entries flushed or
   doubled; in the vocab-split form, a shard of 8192 of the train step's
   logits, forward with the combine and backward, and four shards
   combined against the unsplit loss, `class_start_idx` one too high;
   the combine alone, a shard left out), the
   paged decode attention (two pages swapped, a length one short), the
   bias kernels (the bias rows shifted by one; dbias summed over the heads
   as well as the batch; also on ALiBi's asymmetric and FIRE's biases),
   the T5 bucket table's gradient (every key's bucket one key over),
   `decode_attention` on ALiBi's and FIRE's bias rows (the rows shifted by
   one position) and the fused lm_head+CE kernels (the last vocab
   split dropped from the merge; the z-loss term left out of dlogits; the
   dW columns shifted by one) must fall beyond it; each fused lm_head+CE
   forward row must profile the form its shape dispatches to, and the
   backward's rows also give the scratch it allocates and its measured
   peak memory above its inputs and outputs;
4. checks on tiny models (d_kv 32, and 16, which the card's attention
   wrappers zero-pad) that the slot engine on the card serves the
   tokens the engine on the CPU (the plain versions) serves, and that two
   planted faults move its logits beyond the tolerance; and that the paged
   engine on the card serves exactly the CPU's tokens through each of its
   three routes and its two opt-ins, and other tokens with two pages
   swapped in its table (or in the opt-ins' gather), and with a pool of
   5 pages for 3 slots of 3 defers admissions and serves the same tokens;
5. checks on a tiny model that one training step on the card gives the
   loss and every gradient the CPU gives, on `pallas_rpe` (with and
   without `use_fused_lm_head_ce`) and on `pallas` with `use_masking`, and
   that planted faults in what the backward kernels are given move the
   gradients beyond the tolerance;
6. checks on a tiny f32 model (d_kv 64) that greedy `generate`,
   `beam_generate` and `speculative_generate` on the card give the CPU's
   tokens and the decode steps its logits within a stated limit, that
   sampled `generate` gives one stream from one seed and the greedy one
   at top_k=1, and that two planted faults (the self cache written one
   position late; the decode kernel reading one position too few) move
   the logits beyond the limit;
6b. checks on tiny f32 models (d_kv 64, `pallas`) with ALiBi (symmetric;
   asymmetric with 6 heads), RoPE (plain; fraction 0.5, interleaved and
   xPos) and FIRE that the card gives the CPU's logits, loss, every
   gradient and greedy tokens, and that a planted fault in the bias rows
   (RoPE: the rotation) moves the logits beyond the limit; and runs the ten
   original FAT5 goldens (d_kv 16, zero-padded by the attention wrappers)
   through `pallas` on the card against the reference's logits and loss;
7. times a full-width FAT5-small decode step (seeded random weights, int8
   weights and KV cache, the decode kernel) by wall clock and by device
   time, counts its `quant_matmul` launches by shape, and lists the kernels
   one decode window launches (`torch.profiler`; `quant_matmul`'s decode
   form, the decode attention and the `rms_norm` forward must be among
   them, as in the paged window below);
8. serves 16 requests of 512 random tokens with that engine, three times,
   with every launch count set to 0 just before each run and read just
   after; each serving kernel must have launched in each; then serves them
   with speculative windows of 4 (`spec_window`, plain attention) beside
   the standard engine on the same plain attention, each run counted
   from 0: the tokens must be the standard engine's, request by request,
   with random drafts and with oracle drafts (which must take fewer
   windows); where the plain-attention standard engine's tokens part from
   the decode kernel's, both engines' margins and logits there,
   teacher-forced along the common prefix; one window's launches and
   kernels (the profile held to the wrappers' counts);
9. serves 16 requests of 512 random tokens and up to 128 new ones with the
   paged engine at full width (int8, pages of 64, sync 64): a warm run read
   window by window (wall, launches, one profiled window), then three runs
   interleaved with the slot engine at the same settings, each with the
   launch counts set to 0 just before and read just after; each paged-path
   kernel must have launched in each paged run; then the opt-ins'
   readers (`dense_read_max`, `window_stage_max_bytes`) against the paged
   kernel at the serving shape (a length one short beyond the limit),
   their engines' window walls beside the default's, and an oversubscribed
   pool (24 of the 40 pages the 8 slots would take: admissions deferred,
   the roomy pool's tokens);
9a. serves across ranks (`run_serving_ranks`): one child process a card,
   NCCL; tiny f32 models through `ShardedEngine` and `ShardedPagedEngine`
   against the CPU's single-device engines, then FAT5-small through both
   against the single-device engines on one card (the same tokens at mesh
   (1, 1); logits within a bf16 limit across cards), each path kernel
   launched, one profiled window with its NCCL kernels;
10. generates at full width (FAT5-small, int8 weights, bf16 caches, 8
   inputs of 512 random tokens, max_length 64): greedy `generate` with
   every launch count set to 0 just before it and read just after (each
   generation kernel must have launched), a decode step's wall, device
   time and kernels, then sampled `generate`, `beam_generate` (2 inputs,
   4 beams) and `speculative_generate` (window 4); each with its wall,
   tokens/s and launches a decode step;
10b. trains and generates at FAT5-small widths on `pallas` with ALiBi,
   RoPE (randomized positions up to 2048, gradient accumulation over 2
   micro-batches) and FIRE: each a counted `Trainer.train` run whose
   losses must be finite and falling, a profiled update (the wgmma
   attention bodies, and for ALiBi and FIRE the bias tensor's mma.sync
   ones, must be among its kernels) and its peak memory; then a counted
   greedy `generate` of 8 x
   64 tokens from 512-token inputs with int8 weights and a profiled decode
   step (`decode_attn_kernel` among its kernels);
11. trains FAT5-small at full width through `Trainer.train` (8 x (1024 +
   256) tokens a step, one seeded batch repeated), beside a second trainer
   with `use_fused_lm_head_ce`: 3 warm-up steps each, then three loops of
   10 steps each, the two in turns, each with the launch counts set to 0
   just before and read just after; each kernel of a path must have
   launched in each of its loops, every loss must be finite and the loss
   must fall; then each step's device time (the sum of one profiled
   step's kernel times), its peak memory, its kernels by name (the
   attention's TMA + wgmma bodies and the `rms_norm` kernels must be
   among them, and the fused step's GEMMs and TMA + wgmma forward) and
   the optimizer's launches;
11a. trains across ranks (`parallel/`, `run_parallel`): one child
   process a card, NCCL, the kernels this process built; the
   tensor-parallel step on (1, n) (the vocab-parallel loss on the CE
   kernels' split form), the data-parallel step on (n, 1) and the
   pipeline step on (pipe n, data 1) with 4 micro-batches (with 4 cards
   also (2, 2) and pipe 2 x data 2) at the train step's width and batch:
   step 1's loss and every gradient leaf against the one-card
   `Trainer._step` within per-leaf limits from that leaf's own bf16
   noise (its gap to the same step in f32, or to the step reordered
   into micro-batches, times t + 1), the tensor-parallel step in f32
   against the one-card step in f32 (1e-3, the witness that the layout's
   math is right at full width), `sharded_train_step`'s loss, three
   more steps counted from 0 (every kernel of the path
   launched on some rank), one profiled step (the TP step's held to the
   wrappers' counts: the split CE, wgmma attention and `rms_norm`
   bodies); tiny f32 models' steps against the CPU's one rank; the split
   backward at the train step's logits as four ranks run it, with the
   planted fault (each shard's own lse) beyond its limit, and at t > 1
   the same fault on the tensor-parallel step; then
   `Trainer(tensor_parallel=n)` 5 steps, losses falling; a failed rank,
   or 300 s, ends them all;
11b. checks each task head (token and sequence classification in its
   three problem types, QA) over a tiny f32 trunk on `pallas_rpe`: the
   card's logits, loss and every gradient against the CPU's, and pooling
   the first EOS instead of the last (a planted fault) beyond the limit;
   then fine-tunes the FAT5-small encoder (written to safetensors by the
   port's exporter and read back) with a 2-label head on the toy task,
   32 x 512 a step, 30 steps counted from 0 (the loss must fall; energy at
   the card's power limit), one profiled step (the wgmma attention bodies
   and the `rms_norm` kernels required, each body's launches equal to its
   wrapper's count, else the profile is retaken) timed also by
   `utils.profiling.timed`, and one step each of token classification and
   QA;
12. scores a FAT5-small checkpoint and then a FAT5-flan-base one (d 768,
   12 heads, vocabulary 32128: the fused lm_head+CE kernels in chunks of
   d), seeded weights written as FAT5-named safetensors by the port's
   exporter to a temporary directory, through `quality.main` on the card:
   full precision on the fused lm_head+CE forward, int8 and fp8,
   per-channel and g64, on `quant_matmul`; the full-precision perplexity
   must match the CPU's (the plain versions) within a stated limit, and a
   planted fault must not; one fused eval's profiled kernels must include
   the TMA + wgmma forward;
13. runs the pretraining driver (`train.cli.run`) on
   `configs/fr/fat5-fr-small.yaml` at full width, batch 64 x (1024 + 256),
   `pallas` attention on the three bias kernels: 4 steps with a checkpoint,
   then a second run that resumes from it and takes steps 5-8 (a stub
   tokenizer and ~2,000 synthetic rows stand in for the YAML's tokenizer
   and corpus); every kernel of the path must launch in each run, losses
   be finite and the restored state bit-equal to the saved one; then
   tokens/s as the trainer logs it and between synchronized clock readings,
   the collator's time, a step's wall and device time (its profiled
   kernels' sum), its kernels (the attention's wgmma bodies, the bias
   tensor's mma.sync ones and the `rms_norm` kernels must be among them),
   peak memory;
14. names the kernels SDPA runs for each attention row's `library_ms`
   ("library-kernels" lines, one profile each, in a process of its own
   after every other phase: in one process SDPA's profiles have left later
   profiles short of kernels, and empty after the phases);
15. prints JSON lines of the serving, paged serving, generation, training,
   training across ranks, fine-tuning, scoring, pretraining and encodings results, the smoke's wall, and the
   kernels (each with its launches in each path that runs it, and their
   sum), the `nvidia-smi` name and power limit line, and, last,
   {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero without the last
line. Times are device times from CUDA events over back-to-back launches
(queued behind a `torch.cuda._sleep` so the host's launch cost is not
timed), with the inputs rotated over enough copies to exceed the 50 MB L2,
as the engine finds its weights and caches cold.

Probes, each on its own: `--probe [ROOT]` (host costs and kernel rows the
smoke does not take), `--profile-probe N` (profiles that miss a kernel),
`--library-kernels` (step 14 alone), `--parallel` (step 11a alone, at
every card of the machine), `--attn-probe [ROOT]` (the
attention backward's limit on the inputs that
once went beyond the old one, against f64; the attention kernels' device
ms at the train step's shapes), `--spec-probe` (the speculative window's
attention batched over its Q rows: requests whose tokens change, tokens/s,
kernels a window step), `--bias-grad-probe` (the T5 bucket table's
gradient kernel's rows alone), ROOT a checkout whose package is imported
instead of this one's, so that two commits run in turns in one call.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
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
# the attention backward's dW limit: of each bucket's sum of |dS|
# (`check_training_kernels`); dq, dk and dv take the plain module's
# `grad_limits` (ops/flash_attention_rpe.py)
DW_TOL = 1e-5
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

def _keys_rolled(kernel=None, **kw):
    """A planted fault of an attention kernel (the forward unless `kernel`
    is given): the kernel on its keys rolled by one position (q, k, v
    first in its arguments, `kw` its keywords)."""
    def fault(q, k, v, *rest):
        from flasht5_tpu_torch.ops import flash_attention_rpe
        return (kernel or flash_attention_rpe.flash_attention_rpe_fwd)(
            q, torch.roll(k, 1, dims=2), v, *rest, **kw)
    return ("the keys rolled by one position", fault)


def _decode_rows(lens, length, pe, fire=None):
    """(B, 8, length) f32 bias rows of each slot's position lens - 1
    against every cache position, made by the decode state's own
    `kv_cache._self_bias`: ALiBi's asymmetric rows (clamped at -1e29) or
    FIRE's rows of the parameters `fire`."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import kv_cache
    cfg = FlashT5Config(num_heads=8, d_kv=64, position_encoding_type=pe,
                        alibi_mode="asymetric")
    sa = {"Wq": torch.empty((512, 512)), "pe_encoding": fire}
    return torch.stack([kv_cache._self_bias(cfg, sa, n - 1, 1, length,
                                            lens.device)[0, :, 0]
                        for n in lens.tolist()])


def check_kernels(dev, run=True):
    """Each case's `make()` gives one input set: (kernel args, library
    args); the kernel and its plain version take the first, the library
    call the second (its inputs in the form it wants them, made outside
    the timing). With `run=False` the cases are returned, not run."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.ops import (decode_attention, flash_attention_rpe,
                                       quant, rmsnorm)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    cases = []

    # -- A. rms_norm (CUDA): every pre-norm and final norm, the fp32 weight
    # as the model passes it (`cast_w`: the kernel rounds it to bf16 as it
    # loads it); and the op's own form, the fp32 weight unrounded
    def rms_case(rows, label, main=False, cast_w=True):
        d = 512

        def fwd(x, w):
            return rmsnorm.rms_norm_fwd(x, w, 1e-6, cast_w=cast_w)

        def last_row_from_first(x, w):
            """A planted fault: the last row of x taken from the first."""
            x = x.clone()
            x[-1] = x[0]
            return fwd(x, w)

        def make():
            x = randn(rows, d)
            w = 1 + 0.1 * randn(d, dtype=torch.float32)
            return (x, w), (x, w.to(torch.bfloat16) if cast_w else w)
        (x, w), _ = make()
        cases.append(dict(
            name="rms_norm", label=label, make=make, outputs=2,
            in_bytes=nbytes(x, w), kernel=fwd,
            plain=lambda x, w: rmsnorm.rms_norm_plain(x, w, 1e-6,
                                                      cast_w=cast_w),
            library=((lambda x, w: F.rms_norm(x, (d,), w, 1e-6))
                     if hasattr(F, "rms_norm") else None),
            library_note=("F.rms_norm, the weight cast to bf16 beforehand"
                          if cast_w else "F.rms_norm, the fp32 weight as "
                          "it is (PyTorch's unfused mixed-dtype form)"),
            atol=1e-6, rtol=BF16_ULP, bytes=nbytes(x, w) + nbytes(x)
            + rows * 4, ops=4 * rows * d, ops_type="f32", main=main,
            faults=[("the last row of x taken from the first",
                     last_row_from_first)],
            why="bf16 output: one bf16 ulp (rstd by another sqrt)"))

    rms_case(8, "decode x (8, 512) bf16, w f32", main=True)
    rms_case(8 * 512, "prefill x (4096, 512) bf16, w f32")
    rms_case(PRETRAIN_B * TRAIN_DEC, "pretraining decoder x (16384, 512) "
             "bf16, w f32")
    rms_case(PRETRAIN_B * TRAIN_ENC, "pretraining encoder x (65536, 512) "
             "bf16, w f32")
    rms_case(8 * 512, "op form: x (4096, 512) bf16, w f32 unrounded",
             cast_w=False)

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
        ops_type="bf16", main=True, faults=[_keys_rolled()],
        why="bf16 output and P rounded to bf16 against per-tile maxima"))

    # -- C. quant_matmul (CUDA): every projection and the lm_head ---------
    def scales_rolled(x, qt):
        """A planted fault: each column's scales taken from its neighbour."""
        return quant.quant_matmul(x, quant.QuantizedTensor(
            qt.qvalues, torch.roll(qt.scales, 1, dims=-1)))

    def split_left_out(x, qt):
        """A planted fault of the decode form: its last K piece (split) left
        out of the reduction, as the kernel would compute it had it
        dropped that piece's partials: the piece's weight rows zeroed."""
        a, b = [p for p in quant.decode_pieces(*qt.qvalues.shape)
                if p[1] > p[0]][-1]
        qvalues = qt.qvalues.clone()
        qvalues[a:b] = 0
        return quant.quant_matmul(x, quant.QuantizedTensor(qvalues,
                                                           qt.scales))

    def qmm_case(m, k_dim, n, label, main=False, group_size=None):
        def make():
            x = randn(m, k_dim)
            qt = quant.quantize_int8(
                randn(k_dim, n, dtype=torch.float32, scale=k_dim ** -0.5),
                group_size)
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
            faults=[("the scales of each column taken from its neighbour",
                     scales_rolled)] + ([
                ("the last K split left out of the reduction",
                 split_left_out)] if m <= 32 else []),
            why="bf16 output: one bf16 ulp, and fp32 sums in another order"))

    qmm_case(8, 512, 32768, "decode lm_head x (8, 512) @ int8 (512, 32768)")
    qmm_case(8, 512, 512, "decode Wq/Wk/Wv/o x (8, 512) @ int8 (512, 512)",
             main=True)
    qmm_case(8, 512, 2048, "decode wi_0/wi_1 x (8, 512) @ int8 (512, 2048)")
    qmm_case(8, 2048, 512, "decode wo x (8, 2048) @ int8 (2048, 512)")
    # the speculative window's rows: 8 slots x SPEC_WINDOW (4) rows, the
    # decode form's largest M
    for k_dim, n, what in ((512, 32768, "lm_head"), (512, 512, "Wq/Wk/Wv/o"),
                           (512, 2048, "wi_0/wi_1"), (2048, 512, "wo")):
        m = 8 * SPEC_WINDOW
        qmm_case(m, k_dim, n, f"speculative window {what} x ({m}, {k_dim}) "
                 f"@ int8 ({k_dim}, {n})")
    qmm_case(4096, 512, 2048,
             "prefill wi_0/wi_1 x (4096, 512) @ int8 (512, 2048)")
    qmm_case(4096, 512, 512, "prefill Wq/Wk/Wv/o x (4096, 512) @ int8 "
             "(512, 512)")
    qmm_case(4096, 2048, 512, "prefill wo x (4096, 2048) @ int8 (2048, 512)")
    qmm_case(4096, 2048, 512, "prefill wo x (4096, 2048) @ int8 (2048, 512), "
             "scale groups of 64 (scoring's g64)", group_size=64)

    # -- D. decode_attention (CUDA): decoder self- and cross-attention, on
    # the slot engine's int8 caches and on generation's caches in the
    # activations' dtype (bf16 at FAT5-small; f32 on the tiny f32 model)
    def dec_case(L, lengths, with_bias, label, main=False, kv="int8",
                 rows=None, heads=8):
        """`rows(lens)`: the decode state's bias rows of each slot's
        position (lens - 1), (8, heads, L) f32, in place of random ones."""
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        valid = (torch.arange(L, device=dev)[None, :]
                 < lens[:, None])[:, None, None, :]
        f32 = kv == torch.float32
        q_dtype = torch.float32 if f32 else torch.bfloat16

        def make():
            if kv == "int8":
                kq, ks = quant.quantize_kv(randn(8, heads, L, 64,
                                                 dtype=torch.float32))
                vq, vs = quant.quantize_kv(randn(8, heads, L, 64,
                                                 dtype=torch.float32))
                k_lib = quant.dequantize_kv(kq, ks, torch.bfloat16)
                v_lib = quant.dequantize_kv(vq, vs, torch.bfloat16)
            else:
                kq, vq = (randn(8, heads, L, 64, dtype=kv)
                          for _ in range(2))
                ks = vs = None
                k_lib, v_lib = kq, vq
            bias = (randn(8, heads, L, dtype=torch.float32) if with_bias
                    else None)
            if rows is not None:
                bias = rows(lens)
            q = randn(8, heads, 64, dtype=q_dtype)
            # the library call: SDPA over the same cache in the cache's
            # float type, with the lengths and the bias folded into one
            # additive mask
            mask = torch.where(valid, 0.0, -1e30)
            if bias is not None:
                mask = mask + bias[:, :, None, :]
            lib = (q[:, :, None], k_lib, v_lib, mask.to(k_lib.dtype))
            return (q, kq, vq, ks, vs, lens, bias), lib
        (q, kq, vq, ks, vs, _, bias), lib = make()
        used = sum(min(n, L) for n in lengths)     # positions read
        per_pos = heads * (2 * 64 * kq.element_size()
                       + (2 * 4 if ks is not None else 0)
                       + (4 if with_bias else 0))
        # the last cluster rank of the plan that holds positions
        warps = decode_attention.decode_plan(8, heads, L)[1]
        first = max(a for a, _ in decode_attention.decode_pieces(
            8, heads, L)[::warps] if a < L)

        def last_split_zeroed(q, kq, vq, ks, vs, lens, bias):
            v = vq.clone()
            v[:, :, first:] = 0
            return decode_attention.decode_attention(
                q, kq, v, ks, vs, lengths=lens, bias=bias)

        def rows_shifted(q, kq, vq, ks, vs, lens, bias):
            return decode_attention.decode_attention(
                q, kq, vq, ks, vs, lengths=lens,
                bias=torch.roll(bias, 1, dims=2))
        faults = [(f"the V rows of the last split's positions "
                   f"({first}..{L - 1}) zeroed", last_split_zeroed)]
        if rows is not None:
            faults.append(("the bias rows shifted by one position",
                           rows_shifted))
        cases.append(dict(
            name="decode_attention", label=label, make=make,
            faults=faults,
            extra=dict(plan=decode_attention.decode_plan(8, heads, L)),
            in_bytes=nbytes(kq, vq, ks, vs, bias, *lib),
            kernel=lambda q, kq, vq, ks, vs, lens, bias:
                decode_attention.decode_attention(
                    q, kq, vq, ks, vs, lengths=lens, bias=bias),
            plain=lambda q, kq, vq, ks, vs, lens, bias:
                decode_attention.decode_attention_plain(
                    q, kq, vq, ks, vs, lengths=lens, bias=bias),
            library=lambda q, k, v, mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0),
            atol=1e-4 if f32 else 4e-3, rtol=1e-4 if f32 else BF16_ULP,
            bytes=used * per_pos + nbytes(q, lens) + nbytes(q),
            ops=4 * heads * used * 64, ops_type="f32" if f32 else "bf16",
            main=main,
            why=("f32 throughout: sums in another order and another exp"
                 if f32 else "bf16 output: one bf16 ulp, and P from "
                 "another exp")))

    dec_case(512, [512] * 8, False,
             "decode cross-attention q (8, 8, 64) bf16, int8 K/V "
             "(8, 8, 512, 64), lengths 512", main=True)
    dec_case(66, [1, 9, 17, 25, 33, 41, 49, 57], True,
             "decode self-attention q (8, 8, 64) bf16, int8 K/V "
             "(8, 8, 66, 64), bias, lengths 1..57")
    # a tensor rank's heads of FAT5-small across four cards (8 / 4)
    dec_case(512, [512] * 8, False,
             "decode cross-attention, 2 heads (a rank's at t = 4): q "
             "(8, 2, 64) bf16, int8 K/V (8, 2, 512, 64), lengths 512",
             heads=2)
    # generation (`inference.generate` at max_length 64: a self cache of 64
    # positions)
    dec_case(512, [512] * 8, False,
             "generation cross-attention q (8, 8, 64) bf16, bf16 K/V "
             "(8, 8, 512, 64), lengths 512", kv=torch.bfloat16)
    dec_case(GEN_MAX_LENGTH, [1, 9, 17, 25, 33, 41, 49, 57], True,
             f"generation self-attention q (8, 8, 64) bf16, bf16 K/V "
             f"(8, 8, {GEN_MAX_LENGTH}, 64), bias, lengths 1..57",
             kv=torch.bfloat16)
    dec_case(GEN_MAX_LENGTH, [1, 9, 17, 25, 33, 41, 49, 57], True,
             f"generation self-attention on an f32 model: q (8, 8, 64) f32, "
             f"f32 K/V (8, 8, {GEN_MAX_LENGTH}, 64), bias, lengths 1..57",
             kv=torch.float32)

    # generation with ALiBi and FIRE: the decode state's bias rows of each
    # slot's position. ALiBi's asymmetric rows leave half the heads one
    # finite position (the query's own; -1e29 elsewhere, the clamp of
    # `kv_cache._self_bias`), so whole warp and cluster shares hold only
    # masked positions; FIRE's rows are its MLP's output.
    fire = positional.init_fire_params(gen, 8, init_L=128.0, device=dev)
    for len_cap, lengths in ((GEN_MAX_LENGTH, [1, 9, 17, 25, 33, 41, 49, 57]),
                             (512, [512, 449, 385, 300, 200, 129, 64, 2])):
        dec_case(len_cap, lengths, True,
                 f"generation self-attention with ALiBi's asymmetric rows: "
                 f"q (8, 8, 64) bf16, bf16 K/V (8, 8, {len_cap}, 64), "
                 f"lengths {lengths[0]}..{lengths[-1]}", kv=torch.bfloat16,
                 rows=lambda lens, cap=len_cap: _decode_rows(
                     lens, cap, "ALiBi"))
    dec_case(GEN_MAX_LENGTH, [1, 9, 17, 25, 33, 41, 49, 57], True,
             f"generation self-attention with FIRE's rows: q (8, 8, 64) "
             f"bf16, bf16 K/V (8, 8, {GEN_MAX_LENGTH}, 64), lengths 1..57",
             kv=torch.bfloat16,
             rows=lambda lens: _decode_rows(lens, GEN_MAX_LENGTH, "FIRE",
                                            fire))

    return run_checks(cases) if run else cases


PAGED_TOL = 1e-5
# slots, page size, pages a slot: 64 x 2048 tokens in pages of 128
# (tools/paged_roofline.py:34-60)
PAGED_ROOFLINE = (64, 128, 16)


def _paged_pool(dev, gen, n_pages, h, page, d):
    """An int8 fused page record (n_pages + 1 with the trash page) of
    quantized normal values: (values (N, 2, H, P, D), scales (N, 2, H, P))."""
    from flasht5_tpu_torch.ops import quant
    x = torch.randn((n_pages + 1, 2, h, page, d), generator=gen, device=dev)
    q, s = quant.quantize_kv(x)
    return q, s[..., 0]


def check_paged_kernels(dev):
    """paged_decode_attention at the paged engine's serving shape (a) and at
    the roofline shape of tools/paged_roofline.py (b), through the engine's
    route (the fused record, with the softmax state), each against its plain
    version with a planted fault in what the kernel is given (the V pages of
    the plan's last split zeroed); at (a), two more, and the standard-layout
    routes (arrays, ragged) once each. The library call:
    SDPA over the slots' pages gathered beforehand into a dense bf16 cache
    (the gather is not timed; no single PyTorch call reads pages)."""
    from flasht5_tpu_torch.inference import paged_kv
    from flasht5_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(2)
    h, d = 8, 64
    cases = []

    def kernel(q, pkv, skv, table, lengths, bias):
        return paged_kv.paged_decode_attention_chunked_packed(
            q, pkv, skv, table, lengths, bias=bias, return_state=True)

    def plain(q, pkv, skv, table, lengths, bias):
        return pa.paged_attention_plain(
            q, pkv[:, 0], pkv[:, 1], skv[:, 0], skv[:, 1], table, lengths,
            bias=bias, return_state=True)

    def paged_case(slots, page, maxp, lengths, table, with_bias, label,
                   main=False, h=h):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        table = torch.as_tensor(table, dtype=torch.int32, device=dev)
        max_len = maxp * page
        valid = (torch.arange(max_len, device=dev)[None, :]
                 < lens[:, None])[:, None, None, :]

        def make():
            pkv, skv = _paged_pool(dev, gen, slots * maxp, h, page, d)
            q = 0.25 * torch.randn((slots, h, d), generator=gen, device=dev)
            bias = (torch.randn((slots, h, max_len), generator=gen,
                                device=dev) if with_bias else None)
            kf, vf = paged_kv.gather_pool_dense(pkv, skv, table)
            mask = None
            if with_bias or not bool(valid.all()):
                mask = torch.where(valid, 0.0, -1e30)
                if bias is not None:
                    mask = mask + bias[:, :, None, :]
                mask = mask.to(torch.bfloat16)
            lib = (q[:, :, None].to(torch.bfloat16), kf.to(torch.bfloat16),
                   vf.to(torch.bfloat16), mask)
            return (q, pkv, skv, table, lens, bias), lib
        (q, pkv, skv, _, _, bias), lib = make()
        used = sum(lengths)                  # live tokens of every head
        per_tok = h * (2 * d + 2 * 4 + (4 if with_bias else 0))
        # the last cluster rank of the plan that holds pages
        warps = pa.paged_plan(slots, h, maxp)[1]
        first = max(a for a, _ in pa.paged_pieces(slots, h, maxp)[::warps]
                    if a < maxp)

        def last_split_zeroed(q, pkv, skv, table, lengths, bias):
            zeroed = pkv.clone()
            zeroed[table[:, first:].flatten().long(), 1] = 0
            return kernel(q, zeroed, skv, table, lengths, bias)
        faults = [(f"the V pages of the last split (table entries {first}.."
                   f"{maxp - 1}) zeroed", last_split_zeroed)]
        if main:
            def swapped(q, pkv, skv, table, lengths, bias):
                t = table.clone()
                t[-1, [0, 1]] = table[-1, [1, 0]]
                return kernel(q, pkv, skv, t, lengths, bias)

            def short(q, pkv, skv, table, lengths, bias):
                n = lengths.clone()
                n[3] -= 1
                return kernel(q, pkv, skv, table, n, bias)
            faults += [("pages 0 and 1 of the last slot swapped", swapped),
                       ("slot 3 one token short", short)]
        cases.append(dict(
            name="paged_decode_attention", label=label, make=make, outputs=3,
            in_bytes=nbytes(pkv, skv, bias, *lib), kernel=kernel,
            plain=plain, faults=faults,
            extra=dict(plan=pa.paged_plan(slots, h, maxp)),
            library=lambda q, k, v, mask: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=1.0),
            library_note="F.scaled_dot_product_attention over the pages "
                         "gathered into a dense bf16 cache beforehand",
            atol=PAGED_TOL, rtol=PAGED_TOL,
            bytes=used * per_tok + nbytes(q, lens, table) + nbytes(q)
            + 2 * slots * h * 4, ops=4 * h * used * d, ops_type="f32",
            main=main,
            why="f32 products and sums in another order, exp by another "
                "implementation, an online softmax against one maximum"))

    # (a) the serving shape: 8 slots, pages of 64, 5-page tables over a
    # 40-page pool in a random order, lengths spread over [1, 320]
    perm = torch.randperm(40, generator=torch.Generator().manual_seed(3))
    paged_case(8, 64, 5, [1, 40, 64, 65, 130, 200, 257, 320],
               perm.reshape(8, 5), True,
               "serving q (8, 8, 64) f32, int8 fused pool (41, 2, 8, 64, 64), "
               "table (8, 5), lengths 1..320, bias, state", main=True)
    # a tensor rank's heads of FAT5-small across four cards (8 / 4)
    paged_case(8, 64, 5, [1, 40, 64, 65, 130, 200, 257, 320],
               perm.reshape(8, 5), True,
               "serving, 2 heads (a rank's at t = 4): q (8, 2, 64) f32, int8 "
               "fused pool (41, 2, 2, 64, 64), table (8, 5), lengths 1..320, "
               "bias, state", h=2)
    # (b) the roofline shape: tables round-robin over the pool
    slots, page, maxp = PAGED_ROOFLINE
    rr = [[j * slots + s for j in range(maxp)] for s in range(slots)]
    paged_case(slots, page, maxp, [maxp * page] * slots, rr, False,
               f"roofline q ({slots}, 8, 64) f32, int8 fused pool "
               f"({slots * maxp + 1}, 2, 8, {page}, 64), {slots} x "
               f"{maxp * page} tokens, round-robin tables, state")
    results = run_checks(cases)

    # the standard-layout routes, once each at the serving shape
    c = cases[0]
    (q, pkv, skv, table, lens, bias), _ = c["make"]()
    want = plain(q, pkv, skv, table, lens, bias)[0]
    for name in ("paged_decode_attention_arrays",
                 "paged_decode_attention_ragged"):
        got = getattr(paged_kv, name)(
            q, pkv[:, 0].contiguous(), pkv[:, 1].contiguous(),
            skv[:, 0, ..., None].contiguous(),
            skv[:, 1, ..., None].contiguous(), table, lens, bias=bias)
        torch.cuda.synchronize()
        r = _compare(dict(c, outputs=1), None, got, want)[0]
        print(f"paged route {name}: standard layout at the serving shape, "
              f"max abs err {r['max_abs_err']} (worst share "
              f"{r['worst_share']} of the limit)", flush=True)
    return results


def _readings(c, args, got, want):
    """One reading per output of the case: its largest |error| and |want|,
    its worst share (the largest |error| / limit over the entries whose
    limit is not 0) and the count of entries beyond their limit (each of
    them fails). Each entry's limit is the case's `limits(*args, want)`
    where it has one, else atol (times the output's largest |want| where
    the case says `scaled`) + rtol * |want|."""
    n = c.get("outputs", 1)
    got = (got if isinstance(got, tuple) else (got,))[:n]
    want = (want if isinstance(want, tuple) else (want,))[:n]
    if "limits" in c:
        limits = c["limits"](*args, want)
    else:
        limits = [None if w is None else
                  c["atol"] * (float(w.float().abs().max())
                               if c.get("scaled") else 1.0)
                  + c["rtol"] * w.float().abs() for w in want]
    out = []
    for g, w, lim in zip(got, want, limits):
        if g is None and w is None:
            continue
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        lim = torch.as_tensor(lim, device=diff.device).expand_as(diff)
        share = torch.where(lim > 0, diff / lim, 0.0)
        out.append(dict(max_abs_err=float(diff.max()),
                        max_abs_want=float(w.abs().max()),
                        worst_share=float(share.max()),
                        beyond=(int((~(diff <= lim)).sum())
                                if torch.isfinite(g).all() else g.numel())))
    return out


def _compare(c, args, got, want):
    """The readings of the kernel's outputs against the plain version's;
    raises where an output is not finite or an entry lies beyond its
    limit."""
    readings = _readings(c, args, got, want)
    for i, r in enumerate(readings):
        if r["beyond"]:
            raise AssertionError(f"{c['name']} ({c['label']}): output {i} "
                                 f"beyond its limit: {r}")
    return readings


def library_kernels(dev) -> int:
    """`python3 chip_smoke.py --library-kernels`: the kernels SDPA runs for
    each attention row's library_ms, from one profile of the library call
    on one input set of the row ("library-kernels" lines). The smoke runs
    it as a process of its own after its last phase: in one process a
    profile of SDPA's calls has left later profiles without some of their
    kernels (the fused CE forward's gate missed its kernel), and after the
    smoke's phases every profile of SDPA came back empty."""
    cases = (check_kernels(dev, run=False)
             + check_training_kernels(dev, run=False)
             + check_bias_kernels(dev, run=False))
    for c in cases:
        if not (c["name"].startswith("flash_attention")
                and c["library"] is not None):
            continue
        lib_args = c["make"]()[1]
        by_name = _kernels_by_name(lambda: c["library"](*lib_args))
        print("library-kernels " + json.dumps(dict(
            name=c["name"], shape=c["label"], library=c.get("library_note"),
            kernels=[{"name": name[:90], "ms": t, "launches": n}
                     for name, (t, n) in sorted(
                         by_name.items(), key=lambda kv: -kv[1][0])[:4]])),
            flush=True)
        del lib_args
        torch.cuda.empty_cache()
    return 0


def run_checks(cases):
    """Each case: the kernel against its plain version on one input set,
    then device times of the kernel, the plain version and the library
    call over input sets that exceed the L2 cache."""
    results = []
    for c in cases:
        sets = copies_for(c["make"], c["in_bytes"])
        arg_sets = [a for a, _ in sets]
        got = c["kernel"](*arg_sets[0])
        want = c["plain"](*arg_sets[0])
        torch.cuda.synchronize()
        readings = _compare(c, arg_sets[0], got, want)
        # planted faults: each must take some output beyond its limit
        faults = []
        for fault_name, fault in c.get("faults", ()):
            fr = _readings(c, arg_sets[0], fault(*arg_sets[0]), want)
            faults.append(dict(
                fault=fault_name,
                worst_share=max(r["worst_share"] for r in fr),
                beyond=[r["beyond"] for r in fr]))
            if not any(r["beyond"] for r in fr):
                raise AssertionError(f"{c['name']} ({c['label']}): planted "
                                     f"fault ({fault_name}) within the "
                                     f"limits: {fr}")
        del got, want
        if c.get("require"):
            # the form the wrapper's shape dispatch must take here
            _require_kernels(
                _kernels_by_name(lambda: c["kernel"](*arg_sets[0])),
                c["require"], f"{c['name']} ({c['label']})")
        launches_a_call = None
        if c.get("count_launches"):
            # the port's kernels one call launches, by their wrappers'
            # counts (a profile here would precede the fused CE's profiled
            # gates, and profiles taken in a row lose records: --profile-
            # probe; `--ce-probe` counts every kernel in one profile)
            from flasht5_tpu_torch import ops
            ops.reset_launch_counts()
            c["kernel"](*arg_sets[0])
            torch.cuda.synchronize()
            launches_a_call = {k: v for k, v in ops.launch_counts().items()
                               if v}
        # a case of many small launches sets its own count, so that the
        # launches of one timing fit the launch queue
        iters = c.get("iters", 200 if c["bytes"] < 64 * 2 ** 20 else 50)
        ms = device_ms(c["kernel"], arg_sets, iters)
        plain_ms = device_ms(c["plain"], arg_sets, max(10, iters // 4))
        lib_ms = (device_ms(c["library"], [lb for _, lb in sets], iters)
                  if c["library"] is not None else None)

        unfused = ({} if "unfused" not in c else dict(
            unfused_port_ms=device_ms(c["unfused"], [lb for _, lb in sets],
                                      iters),
            unfused_port=c["unfused_note"]))
        t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = c["ops"] / PEAK_OPS_PER_S[c["ops_type"]] * 1e3
        row = dict(name=c["name"], shape=c["label"], main=c["main"],
                   max_abs_err=max(r["max_abs_err"] for r in readings),
                   outputs=readings, faults=faults, atol=c.get("atol"),
                   rtol=c.get("rtol"), tol_reason=c["why"], ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   library=c.get("library_note"),
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=c["bytes"], ops=c["ops"], **unfused,
                   **({} if launches_a_call is None
                      else dict(launches_a_call=launches_a_call)),
                   **c.get("extra", {}))
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


def check_small_reference(dev, d_kv=32):
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
    tolerance. At d_kv 16 the card's attention wrappers zero-pad the head
    dim (the prefill kernels' and `decode_attention`'s)."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import engine
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params

    cfg = FlashT5Config(vocab_size=512, d_model=128, d_kv=d_kv, num_heads=4,
                        d_ff=256, num_layers=2, num_decoder_layers=2,
                        dropout_rate=0.0, attention_scale=1.0,
                        dtype="float32", attention_type="pallas_rpe",
                        use_fused_layernorm=True)
    tag = f"small-reference (d_kv {d_kv})"
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
    print(f"{tag}: teacher-forced logits card vs cpu max abs diff "
          f"{worst} (tol {SMALL_LOGIT_TOL}); {equal} of {len(ids)} requests "
          f"served token-equal, the rest parted at a top-two margin within "
          f"{2 * SMALL_LOGIT_TOL}", flush=True)

    # (3) planted faults
    for name, fault in _planted_faults():
        with fault:
            fault_gap = gap(_forced_logits(got, reqs(), cpu_out, slots))
        print(f"{tag}: planted fault, {name}: logits card vs cpu "
              f"max abs diff {fault_gap} (tol {SMALL_LOGIT_TOL})", flush=True)
        if not fault_gap > SMALL_LOGIT_TOL:
            raise AssertionError(f"planted fault ({name}) moves the logits "
                                 f"by {fault_gap}, within the tolerance")


def check_small_paged(dev, d_kv=32):
    """A tiny f32 model (f32 weights, int8 KV) served by the paged engine on
    the card (the kernels) and on the CPU (their plain versions), through
    each route: `kernel="chunked"` (window appends), `"ragged"` and
    `"dense"`. Everything is f32, so the two differ only in summation order
    and exp, and the served tokens must be identical; the smallest top-two
    logit margin of the CPU's steps (over every slot, live or not) says how
    far that is from a tie. Then the first two pages of every slot swapped
    in what the paged kernel is given must change the served tokens. At
    d_kv 16 the card's wrappers zero-pad the head dim (q and the pools of
    the paged kernel, the prefill kernels' q, k, v)."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import engine, paged_engine, paged_kv
    from flasht5_tpu_torch.models import t5

    cfg = FlashT5Config(vocab_size=512, d_model=128, d_kv=d_kv, num_heads=4,
                        d_ff=256, num_layers=2, num_decoder_layers=2,
                        dropout_rate=0.0, attention_scale=1.0,
                        dtype="float32", attention_type="pallas_rpe",
                        use_fused_layernorm=True)
    cpu_params = t5.init_params(cfg, seed=4, device="cpu")
    gpu_params = _to(cpu_params, dev)
    rng = np.random.default_rng(1)
    ids = [rng.integers(2, 512, size=(n,)).astype(np.int32)
           for n in (12, 30, 7, 25, 16)]

    # a route: the engine config's kernel and opt-in
    routes = {"chunked": {}, "ragged": dict(kernel="ragged"),
              "dense": dict(kernel="dense"),
              "dense_read_max 24": dict(dense_read_max=24),
              "window_stage_max_bytes 1 MB": dict(
                  window_stage_max_bytes=1 << 20)}

    def serve(params, device, route, num_pages=12, engine_out=None):
        eng = paged_engine.PagedInferenceEngine(
            cfg, params, paged_engine.PagedEngineConfig(
                max_slots=3, page_size=8, num_pages=num_pages,
                max_pages_per_slot=3, max_encode_len=32,
                encode_buckets=(16, 32), kv_dtype="int8", steps_per_sync=3,
                **routes[route]), device=device)
        out = [r.result.tolist() for r in eng.run(
            [engine.Request(uid=i, input_ids=x, max_new_tokens=17)
             for i, x in enumerate(ids)])]
        if engine_out is not None:
            engine_out.append(eng)
        return out

    margins = []
    real_argmax = torch.argmax

    def recording_argmax(x, dim=None, keepdim=False):
        top = x.float().topk(2, dim=-1).values
        margins.append(float((top[..., 0] - top[..., 1]).min()))
        return real_argmax(x, dim=dim, keepdim=keepdim)

    real_paged = paged_kv.paged_attention
    real_gather = paged_kv.gather_pool_dense

    def swapped(table):
        t = table.clone()
        t[:, [0, 1]] = table[:, [1, 0]]
        return t

    def swapped_pages(q, k, v, ks, vs, table, *args, **kw):
        return real_paged(q, k, v, ks, vs, swapped(table), *args, **kw)

    def swapped_gather(pages_kv, scales_kv, table, **kw):
        return real_gather(pages_kv, scales_kv, swapped(table), **kw)

    for route in routes:
        # the opt-ins read the committed pages through a gather, the
        # window's newest tokens and the other routes through the kernel
        opt_in = route not in ("chunked", "ragged", "dense")
        margins.clear()
        with _patched(torch, "argmax", recording_argmax):
            want = serve(cpu_params, "cpu", route)
        ops_before = paged_kv.paged_attention.launches
        got = serve(gpu_params, dev, route)
        launched = paged_kv.paged_attention.launches - ops_before
        if got != want or (not opt_in and not launched):
            raise AssertionError(f"tiny paged engine ({route}): card "
                                 f"{got} != cpu {want} ({launched} "
                                 f"launches)")
        if opt_in and launched:
            raise AssertionError(f"tiny paged engine ({route}): the paged "
                                 f"kernel ran ({launched} launches)")
        with _patched(paged_kv, "gather_pool_dense" if opt_in
                      else "paged_attention",
                      swapped_gather if opt_in else swapped_pages):
            faulty = serve(gpu_params, dev, route)
        moved = sum(a != b for a, b in zip(faulty, want))
        print(f"small-paged ({route}, d_kv {d_kv}): card tokens == cpu "
              f"tokens for "
              f"{len(ids)} requests ({sum(map(len, want))} tokens, "
              f"{launched} paged kernel launches); smallest top-two margin "
              f"{min(margins)}; planted fault, pages 0 and 1 swapped: "
              f"{moved} of {len(ids)} requests served other tokens",
              flush=True)
        if not moved:
            raise AssertionError(f"planted page swap ({route}) left the "
                                 f"served tokens unchanged")
        if route == "chunked":
            roomy = want
    # an oversubscribed pool: 5 pages where each request needs 3 (18
    # tokens of KV in pages of 8), so one request at a time
    engines = []
    tight = serve(gpu_params, dev, "chunked", num_pages=5,
                  engine_out=engines)
    deferrals = engines[0].deferrals
    print(f"small-paged oversubscribed (d_kv {d_kv}): 5 pages of 8 for 3 "
          f"slots of 3: {deferrals} admissions deferred; tokens == the "
          f"12-page pool's on the CPU: {tight == roomy}", flush=True)
    if tight != roomy or deferrals < 1:
        raise AssertionError(f"tiny oversubscribed paged engine: "
                             f"{deferrals} deferrals, {tight} != {roomy}")


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
    engine.encode_cross(cfg, params, np.zeros((slots, enc_len), np.int32), dev)
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
    qmm_shapes = {}
    real_qmm = t5.quant_matmul

    def counted_qmm(x, w):
        key = (f"({x.numel() // x.shape[-1]}, {w.shape[0]}) @ "
               f"({w.shape[0]}, {w.shape[1]})")
        qmm_shapes[key] = qmm_shapes.get(key, 0) + 1
        return real_qmm(x, w)
    with _patched(t5, "quant_matmul", counted_qmm):
        eng._window()
    torch.cuda.synchronize()
    per_step = {name: n / k for name, n in ops.launch_counts().items()}
    qmm_per_step = {key: n / k for key, n in qmm_shapes.items()}
    print("launches per prefill (8 x 512): " + json.dumps(per_prefill)
          + "; per decode step: " + json.dumps(per_step)
          + "; quant_matmul per decode step by shape: "
          + json.dumps(qmm_per_step), flush=True)

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
    bodies = (QMM_DECODE_BODY, DECODE_ATTN_BODY, RMS_FWD_BODY)
    by_name = _kernels_by_name(lambda: eng._window()[1].synchronize(),
                               setup=fill_slots)
    _require_kernels(by_name, bodies, "one decode window")
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
        missing = [name for name in SERVING if launches[name] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched while serving: "
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
    kernel_tokens = {r.uid: r.result for r in done}
    spec = run_spec_engine(dev, cfg, params, ecfg, inputs, kernel_tokens,
                           eng)
    del eng
    torch.cuda.empty_cache()
    return median["launches"], dict(
        tokens_per_s_median=median["tokens_per_s"],
        tokens_per_s=[r["tokens_per_s"] for r in runs],
        tokens=median["tokens"], seconds=median["seconds"],
        per_prefill=per_prefill, per_step=per_step,
        quant_matmul_per_step=qmm_per_step, step=step, spec=spec)


SPEC_WINDOW = 4


def _serve(eng, cfg, inputs, max_new, drafts=None):
    """Serve one request of max_new tokens for each of `inputs` (its
    `draft_source` from `drafts`), with the launch counts set to 0 just
    before and read just after: ({uid: tokens}, the run's figures)."""
    from flasht5_tpu_torch import ops
    from flasht5_tpu_torch.inference import engine
    requests = [engine.Request(
        uid=i, input_ids=x, max_new_tokens=max_new,
        draft_source=None if drafts is None else drafts[i])
        for i, x in enumerate(inputs)]
    spec = eng.ecfg.spec_window >= 2
    if spec:
        eng.spec_stats = dict.fromkeys(eng.spec_stats, 0)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    tokens = _check_results(done, cfg, max_new)
    run = dict(tokens=tokens, seconds=wall, tokens_per_s=tokens / wall,
               launches=launches)
    if spec:
        run["stats"] = dict(eng.spec_stats)
        run["tokens_per_slot_window"] = (eng.spec_stats["tokens"]
                                         / eng.spec_stats["slot_windows"])
    return {r.uid: r.result for r in done}, run


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 2.0 ** -133


def _divergence_witness(engines, inputs, tokens, max_new, slots):
    """Where two engines' greedy tokens part, each engine teacher-forced
    along their common prefix: the first position p where they part, and
    at p each engine's margin of its own token over the other engine's,
    in bf16 ulps of its top logit (the logits are bf16); and the largest
    difference between the two engines' logits over steps 0..p, in ulps
    of the largest logit. A margin of a few ulps, where the engines'
    logits differ by as much, is a near-tie that the two rounding orders
    resolve apart; a fault in one engine's attention would part the
    logits by far more. `engines` and `tokens`: two of each, {uid:
    tokens} each."""
    from flasht5_tpu_torch.inference import engine
    a_tok, b_tok = tokens
    uids = [i for i in a_tok if not np.array_equal(a_tok[i], b_tok[i])]
    first = {i: next(t for t in range(min(len(a_tok[i]), len(b_tok[i])))
                     if a_tok[i][t] != b_tok[i][t]) for i in uids}
    reqs = [engine.Request(uid=i, input_ids=inputs[i], max_new_tokens=max_new)
            for i in uids]
    prefixes = [a_tok[i][:first[i] + 1] for i in uids]
    forced = [_forced_logits(eng, reqs, prefixes, slots) for eng in engines]
    rows = []
    for n, i in enumerate(uids):
        p = first[i]
        row = dict(uid=i, position=p, of=len(a_tok[i]))
        for side, (own, other) in enumerate(((a_tok, b_tok), (b_tok, a_tok))):
            lg = forced[side][n, p]
            top = float(lg.max())
            margin = float(lg[own[i][p]] - lg[other[i][p]])
            row[f"engine_{side}"] = dict(
                argmax_reproduced=bool(lg.argmax() == own[i][p]),
                margin=margin, margin_ulps=margin / _bf16_ulp(top))
        gap = max(float(np.abs(forced[0][n, t] - forced[1][n, t]).max())
                  for t in range(p + 1))
        row["logit_gap"] = gap
        row["logit_gap_ulps"] = gap / _bf16_ulp(max(
            float(np.abs(forced[0][n, t]).max()) for t in range(p + 1)))
        rows.append(row)
    for eng in engines:
        eng.state.active = torch.zeros_like(eng.state.active)
    return rows


def run_spec_engine(dev, cfg, params, ecfg, inputs, kernel_tokens,
                    kernel_engine):
    """Speculative serving: the slot engine with `spec_window`
    SPEC_WINDOW (plain attention, as the windows require) beside the
    standard engine on the same plain attention, at the serving settings
    (int8 weights and KV), on the same requests. The speculative run's
    tokens must equal the standard run's, request by request; each run has
    its launch counts set to 0 just before and read just after, and every
    speculative-serving kernel must launch. Then one more speculative run
    with oracle drafts (each request's standard tokens behind the start
    token as its `draft_source`), which must give the same tokens in
    fewer windows, and one window's launches and kernels. Where the
    plain-attention standard engine's tokens part from the decode
    kernel's (`kernel_engine`'s `kernel_tokens`), `_divergence_witness`
    reads both engines' logits there."""
    import dataclasses

    from flasht5_tpu_torch import ops
    from flasht5_tpu_torch.inference import engine

    plain_cfg = dataclasses.replace(ecfg, use_decode_kernel=False)
    spec_cfg = dataclasses.replace(plain_cfg, spec_window=SPEC_WINDOW)
    max_new = ecfg.max_decode_len - 2
    engines = {}
    for way, c in (("standard", plain_cfg), ("spec", spec_cfg)):
        engines[way] = engine.InferenceEngine(cfg, params, c, device=dev)
        engines[way].warmup()
    torch.cuda.synchronize()

    std_tokens, std = _serve(engines["standard"], cfg, inputs, max_new)
    spec_tokens, spec = _serve(engines["spec"], cfg, inputs, max_new)
    oracle = {i: np.concatenate([[0], std_tokens[i]]).astype(np.int32)
              for i in std_tokens}
    oracle_tokens, oracle_run = _serve(engines["spec"], cfg, inputs, max_new,
                                       oracle)
    for label, got in (("speculative", spec_tokens),
                       ("speculative, oracle drafts", oracle_tokens)):
        differ = [i for i in std_tokens
                  if not np.array_equal(std_tokens[i], got[i])]
        if differ:
            raise AssertionError(f"{label} serving: requests {differ} differ "
                                 f"from the standard engine's tokens")
    missing = [name for name in SPEC_SERVING if spec["launches"][name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in speculative serving: "
                             f"{missing}")
    if not oracle_run["stats"]["windows"] < spec["stats"]["windows"]:
        raise AssertionError(f"oracle drafts took no fewer windows: "
                             f"{oracle_run['stats']} {spec['stats']}")
    same_as_kernel = sum(np.array_equal(std_tokens[i], kernel_tokens[i])
                         for i in std_tokens)
    for label, run in (("standard engine, plain attention", std),
                       (f"spec_window {SPEC_WINDOW}", spec),
                       (f"spec_window {SPEC_WINDOW}, oracle drafts",
                        oracle_run)):
        print(f"spec serving ({label}): {len(inputs)} requests, "
              f"{run['tokens']} tokens in {run['seconds']:.6f} s = "
              f"{run['tokens_per_s']:.3f} tokens/s; "
              + json.dumps({k: v for k, v in run.items()
                            if k not in ("tokens", "seconds",
                                         "tokens_per_s")}), flush=True)
    print(f"spec serving: tokens equal to the standard engine's in every "
          f"request (random and oracle drafts); the plain-attention "
          f"standard engine's tokens equal the decode kernel's in "
          f"{same_as_kernel} of {len(inputs)} requests", flush=True)
    witness = _divergence_witness(
        (engines["standard"], kernel_engine), inputs,
        (std_tokens, kernel_tokens), max_new, ecfg.max_slots)
    print("plain attention (engine_0) against the decode kernel (engine_1), "
          "where their tokens part: " + json.dumps(witness), flush=True)

    # one window of SPEC_WINDOW-row steps with every slot decoding
    eng = engines["spec"]
    k = spec_cfg.steps_per_sync

    def fill():
        st = eng.state
        st.enc_len.fill_(spec_cfg.max_encode_len)
        st.pos = torch.zeros_like(st.pos)
        st.budget = torch.full_like(st.budget, max_new)
        st.active = torch.ones_like(st.active)
        torch.cuda.synchronize()
    fill()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng._window()[1].synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    per_step = {name: n / k for name, n in ops.launch_counts().items()}
    by_name = _kernels_by_name(lambda: eng._window()[1].synchronize(),
                               setup=fill, expect={
                                   "quant_matmul": (QMM_DECODE_BODY,),
                                   "rms_norm": (RMS_FWD_BODY,)})
    window = dict(steps=k, wall_ms=window_ms, launches_per_step=per_step,
                  kernels_per_step=sum(n for _, n in by_name.values()) / k,
                  device_ms_per_step=sum(t for t, _ in by_name.values()) / k)
    print(f"spec window ({k} steps of {SPEC_WINDOW} rows, "
          f"{spec_cfg.max_slots} slots): {json.dumps(window)}", flush=True)
    eng.state.active = torch.zeros_like(eng.state.active)
    return dict(standard=std, launches=spec["launches"], random_drafts=spec,
                oracle_drafts=oracle_run, window=window,
                plain_equals_kernel_requests=same_as_kernel,
                plain_against_kernel=witness)


PAGED_REQUESTS = 16   # tools/serving_paged_ab.py serves 32: halved for time
PAGED_MAX_NEW = 128   # its 256: halved for time (3 pages of 64 a request)


def _check_results(done, cfg, max_new):
    """Each request served 1..max_new in-vocabulary tokens ending in EOS;
    returns the count."""
    tokens = 0
    for r in done:
        res = r.result
        if (res is None or not 1 <= len(res) <= max_new
                or res[-1] != cfg.eos_token_id
                or not ((res >= 0) & (res < cfg.vocab_size)).all()):
            raise AssertionError(f"request {r.uid}: bad result {res}")
        tokens += len(res)
    return tokens


def run_paged_engine(dev):
    """The paged path: `PagedInferenceEngine.run` at full FAT5-small width
    (int8 weights and KV; 8 slots, pages of 64, 40 pages, 5 a slot, encode
    512, sync 64: tools/serving_paged_ab.py:39-59), 16 requests of 512
    random tokens and up to PAGED_MAX_NEW new ones. One warm run reads each
    decode window's wall time and launches and profiles one window with
    committed pages (device time, kernels by name); then three timed runs,
    each
    beside a run of the slot engine at the same settings
    (max_decode_len PAGED_MAX_NEW + 2), every launch count set to 0 just
    before each and read just after; then `run_paged_options`."""
    from flasht5_tpu_torch import flagship_config, ops
    from flasht5_tpu_torch.inference import engine, paged_engine
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params
    from torch.profiler import ProfilerActivity

    cfg = flagship_config()
    t0 = time.perf_counter()
    params = quantize_params(t5.init_params(cfg, seed=0, device=dev), "int8")
    slots, enc_len, max_new, sync = 8, 512, PAGED_MAX_NEW, 64
    paged = paged_engine.PagedInferenceEngine(
        cfg, params, paged_engine.PagedEngineConfig(
            max_slots=slots, page_size=64, num_pages=40, max_pages_per_slot=5,
            max_encode_len=enc_len, encode_buckets=(enc_len,),
            kv_dtype="int8", steps_per_sync=sync), device=dev)
    slot = engine.InferenceEngine(
        cfg, params, engine.EngineConfig(
            max_slots=slots, max_decode_len=max_new + 2,
            max_encode_len=enc_len, encode_buckets=(enc_len,),
            kv_dtype="int8", steps_per_sync=sync, use_decode_kernel=True),
        device=dev)
    paged.warmup()
    slot.warmup()
    torch.cuda.synchronize()
    print(f"paged engine: FAT5-small int8 weights + int8 KV, {slots} slots, "
          f"pages of 64, 40 pages, 5 a slot, sync {sync}; init, quantize and "
          f"both engines' warmup {time.perf_counter() - t0:.3f} s",
          flush=True)
    rng = np.random.default_rng(0)
    inputs = [rng.integers(2, cfg.vocab_size, size=(enc_len,)).astype(
        np.int32) for _ in range(PAGED_REQUESTS)]

    def requests():
        return [engine.Request(uid=i, input_ids=x, max_new_tokens=max_new)
                for i, x in enumerate(inputs)]

    # the warm run, window by window
    windows, kernels = [], {}
    real_window = paged._window

    def timed_window(released, mask):
        ops.reset_launch_counts()
        committed = bool(mask.any())
        profile = committed and not kernels
        t1 = time.perf_counter()
        if profile:
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = real_window(released, mask)
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    t, n = kernels.get(e.name, (0.0, 0))
                    kernels[e.name] = (t + e.time_range.elapsed_us() / 1e3,
                                       n + 1)
            if not kernels:
                # the profiler lost this window's records (see
                # _kernels_by_name): the next committed window is profiled
                EMPTY_PROFILES.append(dict(attempt=len(windows),
                                           launched=ops.launch_counts()))
                print("profile-empty " + json.dumps(EMPTY_PROFILES[-1]),
                      flush=True)
        else:
            out = real_window(released, mask)
        windows.append(dict(wall_ms=(time.perf_counter() - t1) * 1e3,
                            committed=committed, profiled=profile,
                            launches=ops.launch_counts()))
        return out

    paged._window = timed_window
    _check_results(paged.run(requests()), cfg, max_new)
    del paged._window
    device_ms = sum(t for t, _ in kernels.values())
    plain_walls = [w["wall_ms"] for w in windows
                   if w["committed"] and not w["profiled"]]
    window = dict(
        steps=sync, wall_ms=sorted(plain_walls)[len(plain_walls) // 2],
        device_ms=device_ms, launches=next(
            w["launches"] for w in windows if w["committed"]))
    window["device_idle_share"] = 1.0 - device_ms / window["wall_ms"]
    _require_kernels(kernels, (QMM_DECODE_BODY, PAGED_ATTN_BODY,
                               RMS_FWD_BODY), "one paged window")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"paged decode window ({sync} steps, committed pages): "
          f"{json.dumps(window)} (wall: median of the warm run's "
          f"{len(plain_walls)} unprofiled windows with committed pages; "
          f"device: the kernels of one profiled window); windows of the "
          f"warm run, wall ms: "
          f"{json.dumps([round(w['wall_ms'], 3) for w in windows])}",
          flush=True)
    print("profile of one paged window: " + json.dumps({
        "kernels_per_step": sum(n for _, n in kernels.values()) / sync,
        "top": [{"name": name[:80], "ms_per_step": t / sync,
                 "launches_per_step": n / sync} for name, (t, n) in top]}),
        flush=True)

    runs = {"paged": [], "slot": []}
    for attempt in range(3):
        for tag, eng, path in (("paged", paged, PAGED),
                               ("slot", slot, SERVING)):
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            done = eng.run(requests())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = ops.launch_counts()
            tokens = _check_results(done, cfg, max_new)
            peak = torch.cuda.max_memory_allocated()
            print(f"{tag} engine.run {attempt + 1} of 3: "
                  f"{PAGED_REQUESTS} requests x {enc_len} tokens, max_new "
                  f"{max_new}, sync {sync}: {tokens} tokens in {wall:.6f} s "
                  f"= {tokens / wall:.3f} tokens/s; peak memory {peak} B; "
                  f"launches {json.dumps(launches)}", flush=True)
            missing = [name for name in path if launches[name] <= 0]
            if missing:
                raise AssertionError(f"kernels not launched in the {tag} "
                                     f"run: {missing}")
            runs[tag].append(dict(tokens=tokens, seconds=wall,
                                  tokens_per_s=tokens / wall,
                                  peak_memory_bytes=peak, launches=launches))
    median = {tag: sorted(r, key=lambda x: x["tokens_per_s"])[1]
              for tag, r in runs.items()}
    # the decoder self-attention KV each engine holds (the peaks above
    # count both engines and the weights)
    kv_bytes = dict(
        paged=sum(nbytes(*layer["pages_kv"]) for layer in paged.state.layers),
        slot=sum(nbytes(*c.self_k, *c.self_v) for c in slot.state.layers))
    result = dict(
        requests=PAGED_REQUESTS, max_new=max_new, window=window,
        tokens_per_s_median=median["paged"]["tokens_per_s"],
        tokens_per_s=[r["tokens_per_s"] for r in runs["paged"]],
        slot_tokens_per_s_median=median["slot"]["tokens_per_s"],
        slot_tokens_per_s=[r["tokens_per_s"] for r in runs["slot"]],
        paged_over_slot=(median["paged"]["tokens_per_s"]
                         / median["slot"]["tokens_per_s"]),
        peak_memory_bytes=median["paged"]["peak_memory_bytes"],
        slot_peak_memory_bytes=median["slot"]["peak_memory_bytes"],
        self_kv_bytes=kv_bytes)
    print(f"paged / slot tokens/s (medians of 3, interleaved): "
          f"{result['paged_over_slot']}", flush=True)
    result.update(run_paged_options(dev, cfg, params, paged, inputs))
    return median["paged"]["launches"], result


PAGED_OPT_IN_MAX_NEW = 64   # the opt-ins' and the oversubscribed runs
PAGED_OPT_IN_SYNC = 32      # their windows: 2 a request


def _paged_window_walls(eng, requests):
    """Serve `requests`, reading each window's wall (ms; windows with
    committed pages); returns (results, walls)."""
    real, walls = eng._window, []

    def timed(released, committed):
        t1 = time.perf_counter()
        out = real(released, committed)
        if committed.any():
            walls.append((time.perf_counter() - t1) * 1e3)
        return out
    eng._window = timed
    try:
        done = eng.run(requests)
    finally:
        del eng._window
    return done, walls


def run_paged_options(dev, cfg, params, paged, inputs):
    """The paged engine's opt-ins and an oversubscribed pool at full width
    (`paged`: run_paged_engine's engine, 40 pages of 64, 5 a slot):
    - the readers at the serving shape (8 slots, 8 heads of 64, int8
      pages of 64, 5 a slot, lengths 1..320, a random f32 bias): the
      chunked kernel's (out, m, l) against `dense_small_pool_attention`'s
      and the window-staged read's (`gather_pool_dense(..., dequant=False)`
      then `dense_cache_attention`), each entry within PAGED_TOL +
      PAGED_TOL x |entry| (f32 sums of up to 320 terms in another order,
      exp by another implementation), a length one short beyond it;
    - four engines at windows of PAGED_OPT_IN_SYNC steps serving the same
      16 requests of 512 tokens, PAGED_OPT_IN_MAX_NEW new each (65 tokens
      of KV, 2 pages): the kernel, `dense_read_max` 320 and
      `window_stage_max_bytes` 8 MB on the 40-page pool (the median window
      with committed pages, its wall beside the kernel's; the share of
      requests whose tokens equal the kernel engine's, printed: bf16), and
      an oversubscribed pool of 8 pages for the 16 the 8 slots would take
      at once (at least one admission deferred, every request served, the
      kernel engine's tokens: the same arithmetic in other slots)."""
    from flasht5_tpu_torch.inference import engine, paged_engine, paged_kv
    gen = torch.Generator(device=dev).manual_seed(12)
    b, h, d, page, per_slot, n_pages = 8, 8, 64, 64, 5, 40
    vals = torch.randint(-127, 128, (n_pages + 1, 2, h, page, d),
                         generator=gen, device=dev, dtype=torch.int8)
    scales = torch.rand((n_pages + 1, 2, h, page), generator=gen,
                        device=dev) * 0.02
    table = torch.randperm(n_pages, generator=gen, device=dev)[
        :b * per_slot].reshape(b, per_slot).to(torch.int32)
    lengths = torch.randint(1, page * per_slot + 1, (b,), generator=gen,
                            device=dev, dtype=torch.int32)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    bias = torch.randn((b, h, page * per_slot), generator=gen, device=dev)
    kw = dict(sm_scale=1.0, bias=bias, return_state=True)
    want = paged_kv.paged_decode_attention_chunked_packed(
        q, vals, scales, table, lengths, **kw)

    def staged(lens):
        (kv, ks), (vv, vs) = paged_kv.gather_pool_dense(vals, scales, table,
                                                        dequant=False)
        return paged_kv.dense_cache_attention(
            q, paged_engine._stage_read(kv, ks),
            paged_engine._stage_read(vv, vs), lens, **kw)

    def worst(got):
        return max(float(((g - w).abs() / (PAGED_TOL + PAGED_TOL
                                            * w.abs())).max())
                   for g, w in zip(got, want))
    readers = {}
    for name, fn in (("dense_small_pool_attention", lambda lens: paged_kv
                      .dense_small_pool_attention(q, vals, scales, table,
                                                  lens, **kw)),
                     ("window-staged", staged)):
        readers[name] = dict(worst_share=worst(fn(lengths)),
                             fault_share=worst(fn(lengths - 1)))
        print(f"paged reader {name} against the chunked kernel at the "
              f"serving shape (out, m, l): " + json.dumps(readers[name]),
              flush=True)
        if not (readers[name]["worst_share"] <= 1.0
                < readers[name]["fault_share"]):
            raise AssertionError(f"paged reader {name}: {readers[name]}")

    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader").splitlines()[0]
    rows = {}
    for name, change in (("kernel", {}),
                         ("dense_read_max 320", dict(dense_read_max=320)),
                         ("window_stage_max_bytes 8 MB",
                          dict(window_stage_max_bytes=8 << 20)),
                         ("oversubscribed, 8 pages", dict(num_pages=8))):
        eng = paged_engine.PagedInferenceEngine(
            cfg, params, dataclasses.replace(
                paged.ecfg, steps_per_sync=PAGED_OPT_IN_SYNC, **change),
            device=dev)
        eng.warmup()
        done, walls = _paged_window_walls(eng, [
            engine.Request(uid=i, input_ids=x,
                           max_new_tokens=PAGED_OPT_IN_MAX_NEW)
            for i, x in enumerate(inputs)])
        _check_results(done, cfg, PAGED_OPT_IN_MAX_NEW)
        served = {r.uid: r.result.tolist() for r in done}
        base = rows.get("kernel", {}).get("served", served)
        rows[name] = dict(
            served=served, window_wall_ms=sorted(walls)[len(walls) // 2],
            windows_with_committed_pages=len(walls),
            dense_read=eng._dense_read, window_stage=eng._window_stage,
            deferrals=eng.deferrals,
            same_tokens_as_kernel=sum(served[u] == base[u] for u in base))
        del eng
    for row in rows.values():
        del row["served"]
    print(f"paged opt-ins and an oversubscribed pool ({smi}; 16 requests, "
          f"{PAGED_OPT_IN_MAX_NEW} new, windows of {PAGED_OPT_IN_SYNC} "
          f"steps, the median wall of the windows with committed pages): "
          + json.dumps(rows), flush=True)
    over = rows["oversubscribed, 8 pages"]
    if not (rows["dense_read_max 320"]["dense_read"]
            and rows["window_stage_max_bytes 8 MB"]["window_stage"]):
        raise AssertionError("an opt-in engine did not take its reader")
    if over["deferrals"] < 1 or over["same_tokens_as_kernel"] != len(inputs):
        raise AssertionError(f"oversubscribed paged pool: {over}")
    torch.cuda.empty_cache()
    return dict(readers=readers, engines=rows)


# ---------------------------------------------------------------------------
# generation: the decode state, generate, beam search, speculation
# ---------------------------------------------------------------------------

GEN_MAX_LENGTH = 64      # the generation phase's max_length (self cache 64)
GEN_LOGIT_TOL = 1e-4     # the tiny f32 model's decode-step logits


def _generation_faults():
    """Faults in what the generation path's kernel is given: (name, context
    manager)."""
    from flasht5_tpu_torch.inference import kv_cache
    real = kv_cache.decode_attention

    def late_write(cache, new, t):
        n = max(0, min(new.shape[2], cache.shape[2] - t - 1))
        cache[:, :, t + 1:t + 1 + n] = new[:, :, :n]

    def short_lengths(q, k, v, k_scales=None, v_scales=None, lengths=None,
                      **kw):
        return real(q, k, v, k_scales, v_scales, (lengths - 1).clamp(min=0),
                    **kw)

    return [("the self cache written one position late",
             _patched(kv_cache, "_write", late_write)),
            ("the decode kernel reading one position too few",
             _patched(kv_cache, "decode_attention", short_lengths))]


def _returned_tokens(cfg, out):
    """Tokens each row of a (B, max_length + 1) generation returns: the
    positions after the start token up to its first EOS; their sum."""
    is_eos = out[:, 1:] == cfg.eos_token_id
    first = torch.where(is_eos.any(dim=-1), is_eos.int().argmax(dim=-1),
                        out.shape[1] - 2)
    return int((first + 1).sum())


def _check_generated(cfg, out, rows, max_length):
    """The generation contract: (rows, max_length + 1) in-vocabulary ids,
    the start token 0 first, one EOS a row and zeros after it."""
    out = out.cpu()
    eos = cfg.eos_token_id
    if (out.shape != (rows, max_length + 1) or (out[:, 0] != 0).any()
            or (out < 0).any() or (out >= cfg.vocab_size).any()
            or ((out == eos).sum(dim=-1) != 1).any()):
        raise AssertionError(f"bad generation {out.shape}: {out}")
    first = (out == eos).int().argmax(dim=-1)
    pos = torch.arange(max_length + 1)[None, :]
    if (out[pos > first[:, None]] != 0).any():
        raise AssertionError("tokens after a row's EOS")


def check_small_generation(dev):
    """A tiny f32 model (d_kv 64) through the generation entry points on the
    card (the kernels: `decode_attention` on f32 caches at every step) and
    on the CPU (their plain versions). Everything is f32, so the two differ
    in summation order and exp only: (1) the teacher-forced decode steps'
    logits agree within GEN_LOGIT_TOL, and greedy `generate`, `beam_generate`
    (4 beams) and `speculative_generate` (window 4) give the CPU's token
    streams (the smallest top-two logit margin of the CPU's greedy steps
    says how far that is from a tie); (2) sampled `generate` gives the same
    stream twice from one seed, and with top_k=1 the greedy stream; (3)
    each planted fault moves the logits beyond GEN_LOGIT_TOL."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import (beam_generate, decode_step,
                                             generate, init_decode_state,
                                             speculative_generate)
    from flasht5_tpu_torch.models import t5

    cfg = FlashT5Config(vocab_size=512, d_model=128, d_kv=64, num_heads=4,
                        d_ff=256, num_layers=2, num_decoder_layers=2,
                        dropout_rate=0.0, dtype="float32",
                        attention_type="pallas_rpe",
                        use_fused_layernorm=True)
    cpu_params = t5.init_params(cfg, seed=5, device="cpu")
    gpu_params = _to(cpu_params, dev)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        2, 512, size=(4, 24)))
    max_len = 16

    def streams(params, device):
        x = ids.to(device)
        return dict(
            greedy=generate(cfg, params, x, max_length=max_len),
            beam=beam_generate(cfg, params, x, num_beams=4,
                               max_length=max_len)[0],
            speculative=speculative_generate(cfg, params, x,
                                             max_length=max_len, window=4))

    want = {k: v.tolist() for k, v in streams(cpu_params, "cpu").items()}

    def forced_logits(params, device):
        """Each decode step's logits along the CPU's greedy tokens."""
        enc = t5.encode(cfg, params, ids.to(device))
        state = init_decode_state(cfg, params, enc, max_len)
        toks = torch.tensor(want["greedy"], device=device)
        out = []
        for t in range(max_len):
            logits, state = decode_step(cfg, params, state, toks[:, t])
            out.append(logits.float().cpu())
        return torch.stack(out)

    cpu_logits = forced_logits(cpu_params, "cpu")
    top2 = cpu_logits.topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    gap = float((forced_logits(gpu_params, dev) - cpu_logits).abs().max())
    got = {k: v.tolist() for k, v in streams(gpu_params, dev).items()}
    if not gap <= GEN_LOGIT_TOL:
        raise AssertionError(f"tiny generation logits: card vs cpu {gap} > "
                             f"{GEN_LOGIT_TOL}")
    for key in want:
        if got[key] != want[key]:
            raise AssertionError(f"tiny generation ({key}): card "
                                 f"{got[key]} != cpu {want[key]}")
    if want["speculative"] != want["greedy"]:
        raise AssertionError("speculative tokens differ from greedy")

    def sampled(**kw):
        return generate(cfg, gpu_params, ids.to(dev), max_length=max_len,
                        temperature=1.0, generator=torch.Generator(
                            device=dev).manual_seed(7), **kw).tolist()
    first, second = sampled(top_k=20, top_p=0.9), sampled(top_k=20,
                                                         top_p=0.9)
    if first != second:
        raise AssertionError(f"sampled generate from one seed: {first} != "
                             f"{second}")
    if sampled(top_k=1) != got["greedy"]:
        raise AssertionError("sampled generate at top_k=1 is not greedy")
    print(f"small-generation: decode-step logits card vs cpu max abs diff "
          f"{gap} (tol {GEN_LOGIT_TOL}); greedy, beam (4) and speculative "
          f"(window 4) tokens == cpu for {ids.shape[0]} rows of "
          f"{max_len}; smallest top-two margin {margin}; sampled streams "
          f"bit-equal from one seed; top_k=1 == greedy", flush=True)
    for name, fault in _generation_faults():
        with fault:
            fault_gap = float((forced_logits(gpu_params, dev)
                               - cpu_logits).abs().max())
            moved = streams(gpu_params, dev)["greedy"].tolist() != want[
                "greedy"]
        print(f"small-generation: planted fault, {name}: logits card vs "
              f"cpu max abs diff {fault_gap} (tol {GEN_LOGIT_TOL}); greedy "
              f"tokens {'moved' if moved else 'unchanged'}", flush=True)
        if not fault_gap > GEN_LOGIT_TOL:
            raise AssertionError(f"planted fault ({name}) moves the logits "
                                 f"by {fault_gap}, within the tolerance")


def run_generation(dev):
    """The generation path at full width: FAT5-small with int8 weights
    (seeded), 8 inputs of 512 random tokens, max_length 64, through the
    entry points a user calls: greedy `generate` (every launch count set to
    0 just before it and read just after: the path's run), sampled
    `generate`, `beam_generate` (2 inputs, 4 beams) and
    `speculative_generate` (window 4). Also a decode step's launches by
    kernel, its wall and its device time (one profiled step) and the
    kernels of a profiled short `generate`."""
    from flasht5_tpu_torch import flagship_config, ops
    from flasht5_tpu_torch.inference import (beam_generate, decode_step,
                                             decode_window_step, generate,
                                             init_decode_state,
                                             speculative_generate)
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params

    cfg = flagship_config()
    params = quantize_params(t5.init_params(cfg, seed=0, device=dev), "int8")
    b, enc_len, max_len = 8, 512, GEN_MAX_LENGTH
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        2, cfg.vocab_size, size=(b, enc_len))).to(dev)
    generate(cfg, params, ids, max_length=2)          # plans and warm-up
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(fn):
        """fn's output, wall seconds and launches, every count set to 0
        just before it and read just after."""
        ops.reset_launch_counts()
        out, wall = timed(fn)
        return out, wall, ops.launch_counts()

    # the set-up every entry point runs once: encode and the cross K/V
    _, _, setup = counted(lambda: init_decode_state(
        cfg, params, t5.encode(cfg, params, ids), max_len))
    layers = cfg.num_decoder_layers

    def per_step(launches, steps):
        """Launches of one decode step (or verify window), by kernel."""
        return {name: (n - setup[name]) / steps
                for name, n in launches.items() if n - setup[name]}

    result = {}
    greedy, wall, launches = counted(lambda: generate(cfg, params, ids,
                                                      max_length=max_len))
    missing = [name for name in GENERATION if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched while generating: "
                             f"{missing}")
    _check_generated(cfg, greedy, b, max_len)
    steps = launches["decode_attention"] // (2 * layers)
    tokens = _returned_tokens(cfg, greedy)
    result["greedy"] = dict(wall_s=wall, tokens=tokens,
                            tokens_per_s=tokens / wall, decode_steps=steps,
                            launches=launches,
                            launches_per_step=per_step(launches, steps))
    print(f"generation: FAT5-small int8 weights, bf16 caches, {b} inputs x "
          f"{enc_len} tokens, max_length {max_len}: greedy generate "
          f"{json.dumps(result['greedy'])}", flush=True)

    # a decode step's wall (8 steps) and one profiled step's kernels
    state = init_decode_state(cfg, params, t5.encode(cfg, params, ids),
                              max_len)
    tok = greedy[:, 1]
    _, step_wall = timed(lambda: [decode_step(cfg, params,
                                              state._replace(t=8 + i), tok)
                                  for i in range(8)])
    by_name = _kernels_by_name(lambda: decode_step(
        cfg, params, state._replace(t=16), tok))
    step = dict(wall_ms=step_wall * 1e3 / 8,
                device_ms=sum(t for t, _ in by_name.values()),
                kernels=sum(n for _, n in by_name.values()))
    step["device_idle_share"] = 1.0 - step["device_ms"] / step["wall_ms"]
    # as the slot engine's "decode step" line reads it: first kernel's start
    # to last kernel's end, the step queued behind a sleep so the device
    # never waits for the host (kernels and the gaps between them)
    spans = []
    for i in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(_cycles_per_ms() * (2.0 * step["wall_ms"]
                                                  + 5.0)))
        start.record()
        decode_step(cfg, params, state._replace(t=17 + i), tok)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    step["queued_device_ms"] = sum(spans) / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"generation decode step ({b} rows, cross length {enc_len}, "
          f"position 16): {json.dumps(step)} (wall: mean of 8 steps; "
          f"device: one profiled step's kernels; queued: mean of 3 steps "
          f"queued behind a sleep); top kernels " + json.dumps(
              [{"name": name[:80], "ms": t, "launches": n}
               for name, (t, n) in top]), flush=True)
    # a speculative verify window (Q = 4): its attention is plain PyTorch
    w_in = torch.cat([tok[:, None], greedy[:, 2:5]], dim=1)
    _, win_wall = timed(lambda: [decode_window_step(
        cfg, params, state._replace(t=24 + 4 * i), w_in) for i in range(4)])
    win_kernels = _kernels_by_name(lambda: decode_window_step(
        cfg, params, state._replace(t=40), w_in))
    window = dict(wall_ms=win_wall * 1e3 / 4,
                  device_ms=sum(t for t, _ in win_kernels.values()),
                  kernels=sum(n for _, n in win_kernels.values()))
    top = sorted(win_kernels.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"generation verify window (Q 4, {b} rows): {json.dumps(window)} "
          f"(wall: mean of 4 windows; device: one profiled window's "
          f"kernels); top kernels " + json.dumps(
              [{"name": name[:80], "ms": t, "launches": n}
               for name, (t, n) in top]), flush=True)
    result["verify_window"] = window
    bodies = (DECODE_ATTN_BODY, WGMMA_FWD_BODY, RMS_FWD_BODY,
              QMM_DECODE_BODY)
    _require_kernels(_kernels_by_name(lambda: generate(
        cfg, params, ids, max_length=4)), bodies,
        "one generate (max_length 4)")
    result["decode_step"] = step

    sampled, wall, launches = counted(lambda: generate(
        cfg, params, ids, max_length=max_len, temperature=0.8, top_k=50,
        top_p=0.95, generator=torch.Generator(device=dev).manual_seed(0)))
    _check_generated(cfg, sampled, b, max_len)
    steps = launches["decode_attention"] // (2 * layers)
    tokens = _returned_tokens(cfg, sampled)
    result["sampled"] = dict(wall_s=wall, tokens=tokens,
                             tokens_per_s=tokens / wall, temperature=0.8,
                             top_k=50, top_p=0.95, decode_steps=steps,
                             launches_per_step=per_step(launches, steps))

    (beams, scores), wall, launches = counted(lambda: beam_generate(
        cfg, params, ids[:2], num_beams=4, max_length=max_len))
    _check_generated(cfg, beams, 2, max_len)
    if not torch.isfinite(scores).all():
        raise AssertionError(f"beam scores {scores}")
    steps = launches["decode_attention"] // (2 * layers)
    tokens = _returned_tokens(cfg, beams)
    result["beam"] = dict(wall_s=wall, tokens=tokens,
                          tokens_per_s=tokens / wall, rows=2, num_beams=4,
                          scores=scores.tolist(), decode_steps=steps,
                          launches_per_step=per_step(launches, steps))

    (spec, stats), wall, launches = counted(lambda: speculative_generate(
        cfg, params, ids, max_length=max_len, window=4, return_stats=True))
    _check_generated(cfg, spec, b, max_len)
    tokens = _returned_tokens(cfg, spec)
    result["speculative"] = dict(
        wall_s=wall, tokens=tokens, tokens_per_s=tokens / wall, window=4,
        windows=stats["windows"],
        tokens_per_window=stats["generated"] / stats["windows"],
        launches_per_window=per_step(launches, stats["windows"]),
        # bf16: a near-tied argmax may flip between the window's Q-row and
        # the single step's one-row matmuls; printed, not gated
        agreement_with_greedy=float((spec[:, 1:] == greedy[:, 1:]).float()
                                    .mean()))
    for key in ("sampled", "beam", "speculative"):
        print(f"generation ({key}): {json.dumps(result[key])}", flush=True)
    return result["greedy"]["launches"], result


# ---------------------------------------------------------------------------
# the positional encodings: ALiBi, RoPE and FIRE
# ---------------------------------------------------------------------------

# the tiny models' encodings (the five of the PE goldens)
SMALL_ENCODINGS = {
    "ALiBi": dict(position_encoding_type="ALiBi"),
    "ALiBi asymmetric, 6 heads": dict(position_encoding_type="ALiBi",
                                      alibi_mode="asymetric", num_heads=6),
    "RoPE": dict(position_encoding_type="RoPE"),
    "RoPE fraction 0.5, interleaved, xPos": dict(
        position_encoding_type="RoPE", rotary_emb_fraction=0.5,
        rotary_interleaved=True, rotary_scale_base=512.0),
    "FIRE": dict(position_encoding_type="FIRE"),
}
# f32 on both sides, sums in other orders and another exp: the logits to
# 1e-4 (absolute; they are O(1)), the loss to 1e-4 relative, each gradient
# leaf to SMALL_GRAD_TOL of its largest entry, or of 1e-2 of the model's
# largest gradient entry where that is more (a leaf whose gradient sums
# terms that cancel exactly, FIRE's b2: each row of dS sums to 0, is
# rounding noise on both sides: 1.6e-7 of the model's largest entry on an
# H100); each planted fault is read in the same run and must land beyond
SMALL_PE_LOGIT_TOL = 1e-4
# the reference's logits through `pallas`: tests/test_golden_reference.py's
# tolerance on the kernels' path (|gap| <= 5e-4 + 5e-4 |want|), the loss 1e-4
GOLDEN_TOL = 5e-4


def _encoding_faults(pet):
    """A planted fault in the bias rows (ALiBi, FIRE: each row takes its
    neighbour's) or in the rotation (RoPE: each position takes its
    neighbour's angles): (name, context manager)."""
    from flasht5_tpu_torch.models import t5
    if pet == "RoPE":
        real = t5.rope_tables

        def rolled(*args):
            return tuple(None if t is None else torch.roll(t, 1, 0)
                         for t in real(*args))
        return ("the rotation tables shifted by one position",
                _patched(t5, "rope_tables", rolled))
    real = t5._position_bias

    def shifted(*args, **kw):
        return torch.roll(real(*args, **kw), 1, dims=2)
    return ("the bias rows shifted by one", _patched(t5, "_position_bias",
                                                     shifted))


def check_small_encodings(dev):
    """Tiny f32 models (d_kv 64, 2+2 layers) for ALiBi symmetric, ALiBi
    asymmetric with 6 heads, RoPE, RoPE with fraction 0.5, interleaved and
    xPos, and FIRE, on `pallas`: the card (the bias kernels; RoPE the
    kernels without a bias) against the CPU (their plain versions): the
    forward's logits and loss, every gradient leaf (FIRE's MLP and scalars
    included) and greedy `generate`'s tokens (`decode_attention` with the
    bias rows, or the rotations, at every step). A planted fault in the
    bias rows (RoPE: in the rotation) must move the logits beyond the
    tolerance."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.inference import generate
    from flasht5_tpu_torch.models import t5

    base = dict(vocab_size=512, d_model=128, d_kv=64, num_heads=4, d_ff=256,
                num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
                dtype="float32", attention_type="pallas",
                use_fused_layernorm=True, use_fused_crossentropy=True,
                z_loss=1e-4, pad_token_id=0)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(2, 512, (2, 96)))
    labels = torch.from_numpy(rng.integers(2, 512, (2, 40)))
    labels[:, -5:] = -100
    results = {}
    for tag, kw in SMALL_ENCODINGS.items():
        cfg = FlashT5Config(**dict(base, **kw))
        cpu_params = t5.init_params(cfg, seed=5, device="cpu")

        def step(device, cfg=cfg, cpu_params=cpu_params):
            params = _to(copy.deepcopy(cpu_params), device)
            leaves = t5.tree_leaves_with_path(params)
            for _, p in leaves:
                p.requires_grad_(True)
            out = t5.forward(cfg, params, input_ids=ids.to(device),
                             labels=labels.to(device))
            out["loss"].backward()
            return (out["logits"].detach().cpu(),
                    float(out["loss"].detach()),
                    [(path, p.grad.cpu()) for path, p in leaves])

        want_logits, want_loss, want_grads = step("cpu")
        logits, loss, grads = step(dev)
        logit_gap = float((logits - want_logits).abs().max())
        grad_gap, where = 0.0, None
        floor = 1e-2 * max(float(w.abs().max()) for _, w in want_grads)
        for (path, g), (_, w) in zip(grads, want_grads):
            rel = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   floor)
            if rel > grad_gap:
                grad_gap, where = rel, path
        tokens = [generate(cfg, _to(cpu_params, device),
                           ids[:, :48].to(device), max_length=16).cpu()
                  for device in ("cpu", dev)]
        name, fault = _encoding_faults(cfg.position_encoding_type)
        with fault, torch.no_grad():
            faulted = t5.forward(cfg, _to(cpu_params, dev),
                                 input_ids=ids.to(dev),
                                 labels=labels.to(dev))["logits"].cpu()
        fault_gap = float((faulted - want_logits).abs().max())
        results[tag] = dict(
            logit_gap=logit_gap, loss_card=loss, loss_cpu=want_loss,
            grad_gap=grad_gap, grad_gap_at=where,
            greedy_equal=bool(torch.equal(tokens[0], tokens[1])),
            fault=name, fault_logit_gap=fault_gap)
        print(f"small-encoding ({tag}, pallas): {json.dumps(results[tag])} "
              f"(tol: logits {SMALL_PE_LOGIT_TOL}, loss 1e-4 relative, "
              f"gradients {SMALL_GRAD_TOL} of each leaf's largest entry, "
              f"at least 1e-2 of the model's)", flush=True)
        if not (logit_gap <= SMALL_PE_LOGIT_TOL
                and abs(loss - want_loss) <= 1e-4 * abs(want_loss)
                and grad_gap <= SMALL_GRAD_TOL):
            raise AssertionError(f"tiny {tag} model: card and cpu differ: "
                                 f"{results[tag]}")
        if not torch.equal(tokens[0], tokens[1]):
            raise AssertionError(f"tiny {tag} model: greedy tokens card "
                                 f"{tokens[1].tolist()} != cpu "
                                 f"{tokens[0].tolist()}")
        if not fault_gap > SMALL_PE_LOGIT_TOL:
            raise AssertionError(f"tiny {tag} model: planted fault ({name}) "
                                 f"moves the logits by {fault_gap}")
    return results


def check_goldens(dev):
    """The ten original PyTorch FAT5 goldens (`tests/golden/ref_*.npz`: the
    reference's weights, inputs, logits and loss; d_kv 16, which the
    attention wrappers zero-pad to the kernels' 32) imported by the port
    and run through `pallas` on the card, f32: the logits within GOLDEN_TOL
    (absolute and relative) of the reference's, the loss within 1e-4."""
    import glob
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.convert.hf_import import state_dict_to_params
    from flasht5_tpu_torch.models import t5

    paths = sorted(glob.glob(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
        "ref_*.npz")))
    if len(paths) != 10:
        raise AssertionError(f"expected the ten goldens, found {paths}")
    results = {}
    for path in paths:
        z = np.load(path)
        cfg_json = json.loads(bytes(z["config_json"]).decode())
        sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")
              and not k.endswith("embed_tokens.weight")}
        cfg = FlashT5Config.from_dict(dict(
            cfg_json, dtype="float32", param_dtype="float32",
            attention_type="pallas",
            use_full_bias_size=bool(cfg_json.get("use_full_bias_size")
                                    or cfg_json.get("use_masking"))))
        params = state_dict_to_params(sd, device=dev)
        with torch.no_grad():
            out = t5.forward(cfg, params, **{
                k: torch.from_numpy(z[k]).to(dev)
                for k in ("input_ids", "attention_mask", "labels")})
        want = torch.from_numpy(z["logits"])
        got = out["logits"].cpu()
        share = float(((got - want).abs()
                       / (GOLDEN_TOL + GOLDEN_TOL * want.abs())).max())
        loss_gap = abs(float(out["loss"]) - float(z["loss"]))
        tag = os.path.basename(path)[4:-4]
        results[tag] = dict(
            position_encoding_type=cfg.position_encoding_type, d_kv=cfg.d_kv,
            max_abs_err=float((got - want).abs().max()), worst_share=share,
            loss_gap=loss_gap)
        if not (share <= 1.0 and loss_gap < 1e-4):
            raise AssertionError(f"golden {tag} on the card: {results[tag]}")
    print(f"goldens through pallas on the card (logits within {GOLDEN_TOL} "
          f"+ {GOLDEN_TOL} |want| of the reference's, loss within 1e-4): "
          + json.dumps(results), flush=True)
    return results


# the kernels each encoding's full-width path runs: on `pallas` the
# encoder's and the decoder's self-attention take the bias kernels (RoPE:
# the kernels without a bias), the cross-attention the RPE kernels without
# a table
BIAS_TRAINING = ("rms_norm", "rms_norm_bwd", "flash_attention_rpe",
                 "flash_attention_bwd", "flash_attention_bias",
                 "flash_attention_bias_dkv", "flash_attention_bias_dq",
                 "cross_entropy_fwd", "cross_entropy_bwd")
BIAS_GENERATION = ("rms_norm", "flash_attention_bias", "quant_matmul",
                   "decode_attention")
FULL_ENCODINGS = {
    "ALiBi": dict(position_encoding_type="ALiBi"),
    # at max_sequence_length 2048 the draw is not the identity (the
    # training length is 1024)
    "RoPE": dict(position_encoding_type="RoPE",
                 use_randomized_position_encoding=True,
                 max_sequence_length=2048),
    "FIRE": dict(position_encoding_type="FIRE"),
}


def run_encodings(dev):
    """FAT5-small widths (`flagship_config()` with `attention_type="pallas"`)
    with ALiBi (symmetric), RoPE (randomized positions up to 2048, gradient
    accumulation over 2 micro-batches) and FIRE. Each: `Trainer.train` for
    a warm-up step, then a counted run (every launch count set to 0 just
    before it, read just after; each kernel of the path must launch) of 4
    steps at 8 x (1024 + 256) tokens (RoPE: 6 micro-batches, 3 updates)
    whose losses must be finite and falling; a profiled step's device ms
    and kernels (the attention's tensor-core bodies on the bias source, or
    on none for RoPE) and the peak memory. Then greedy `generate` of 8 x 64
    tokens from 512-token inputs with int8 weights, counted; a decode
    step's wall, device ms and kernels (`decode_attn_kernel` among them)."""
    from flasht5_tpu_torch import flagship_config, ops
    from flasht5_tpu_torch.inference import decode_step, generate
    from flasht5_tpu_torch.inference import init_decode_state
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params
    from flasht5_tpu_torch.train import Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    results, launches_by_path = {}, {}
    for pe, extra in FULL_ENCODINGS.items():
        cfg = flagship_config().replace(attention_type="pallas", **extra)
        k = 2 if cfg.use_randomized_position_encoding else 1
        tcfg = TrainerConfig(learning_rate=1e-3, weight_decay=0.0,
                             lr_scheduler="constant", max_steps=10 ** 6,
                             logging_steps=1, seed=0,
                             gradient_accumulation_steps=k)
        trainer = Trainer(cfg, tcfg, device=dev)
        batch = {"input_ids": rng.integers(0, cfg.vocab_size, (
                     TRAIN_B, TRAIN_ENC)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (
                     TRAIN_B, TRAIN_DEC)).astype(np.int32)}
        warm = [e["loss"] for e in trainer.train([batch] * k)["logs"]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n = 3 * k if k > 1 else 4
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [e["loss"] for e in trainer.train([batch] * n)["logs"]]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = warm + losses
        path = TRAINING if pe == "RoPE" else BIAS_TRAINING
        missing = [name for name in path if launches[name] <= 0]
        if missing:
            raise AssertionError(f"{pe} training launched no {missing}")
        if not (all(np.isfinite(losses))
                and np.mean(losses[-k:]) < np.mean(losses[:k])):
            raise AssertionError(f"{pe} training losses {losses}")
        db = trainer._device_batch(batch)
        # one update: k micro-batches
        bodies = wgmma_bodies(NO_BIAS) + (() if pe == "RoPE"
                                          else TENSOR_BODIES)
        by_name = _kernels_by_name(lambda: [trainer._step(db)
                                            for _ in range(k)])
        _require_kernels(by_name, bodies, f"one {pe} train step")
        tokens = n * TRAIN_B * (TRAIN_ENC + TRAIN_DEC)
        train = dict(
            micro_batches=n, gradient_accumulation_steps=k,
            randomized_positions=cfg.use_randomized_position_encoding,
            max_sequence_length=cfg.max_sequence_length, losses=losses,
            wall_s=wall, tokens_per_s=tokens / wall,
            launches_per_micro_batch={name: c / n for name, c in
                                      launches.items() if c},
            update_device_ms=sum(t for t, _ in by_name.values()),
            update_kernels=sum(c for _, c in by_name.values()),
            peak_memory_bytes=peak)
        print(f"{pe} training (FAT5-small widths, pallas, batch {TRAIN_B} x "
              f"({TRAIN_ENC} + {TRAIN_DEC})): {json.dumps(train)} (device: "
              f"one profiled update, {k} micro-batch(es))", flush=True)
        launches_by_path[f"{pe}_training"] = launches
        del trainer, db
        torch.cuda.empty_cache()

        params = quantize_params(t5.init_params(cfg, seed=0, device=dev),
                                 "int8")
        ids = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                            size=(8, 512))).to(dev)
        generate(cfg, params, ids, max_length=2)        # plans, warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(cfg, params, ids, max_length=GEN_MAX_LENGTH)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        path = GENERATION if pe == "RoPE" else BIAS_GENERATION
        missing = [name for name in path if launches[name] <= 0]
        if missing:
            raise AssertionError(f"{pe} generation launched no {missing}")
        _check_generated(cfg, out, 8, GEN_MAX_LENGTH)
        n_tok = _returned_tokens(cfg, out)
        state = init_decode_state(cfg, params, t5.encode(cfg, params, ids),
                                  GEN_MAX_LENGTH)
        tok = out[:, 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            decode_step(cfg, params, state._replace(t=8 + i), tok)
        torch.cuda.synchronize()
        step_wall = (time.perf_counter() - t0) * 1e3 / 8
        bodies = (DECODE_ATTN_BODY, QMM_DECODE_BODY)
        by_name = _kernels_by_name(lambda: decode_step(
            cfg, params, state._replace(t=16), tok))
        _require_kernels(by_name, bodies, f"one {pe} decode step")
        steps = launches["decode_attention"] // (2 * cfg.num_decoder_layers)
        gen = dict(wall_s=gen_wall, tokens=n_tok,
                   tokens_per_s=n_tok / gen_wall, decode_steps=steps,
                   launches={name: c for name, c in launches.items() if c},
                   step_wall_ms=step_wall,
                   step_device_ms=sum(t for t, _ in by_name.values()),
                   step_kernels=sum(c for _, c in by_name.values()))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        print(f"{pe} generation (FAT5-small widths, int8 weights, bf16 "
              f"caches, 8 inputs x 512 tokens, max_length "
              f"{GEN_MAX_LENGTH}): {json.dumps(gen)}; decode step's top "
              f"kernels " + json.dumps([{"name": name[:80], "ms": t,
                                        "launches": c}
                                       for name, (t, c) in top]), flush=True)
        launches_by_path[f"{pe}_generation"] = launches
        results[pe] = dict(training=train, generation=gen)
        del params, state
        torch.cuda.empty_cache()
    return launches_by_path, results


# ---------------------------------------------------------------------------
# training: kernel checks at the train step's shapes
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_ENC, TRAIN_DEC = 8, 1024, 256     # bench.py:45
PRETRAIN_B = 64     # configs/fr/fat5-fr-small.yaml's per-device batch


def check_training_kernels(dev, rope_generator=True, run=True):
    """The training path's new kernels (and the forward without a table) at
    the FAT5-small train step's shapes. The library yardsticks: autograd's
    backward of F.rms_norm, of F.scaled_dot_product_attention (the RPE bias
    as a float mask, which gives no gradient of the bucket table) and of
    F.cross_entropy (no z-loss). With `rope_generator=False` the RoPE rows
    draw from the other rows' generator, as they did when the encoder row's
    dq first went beyond its old limit (`attn_probe` reads those inputs);
    with `run=False` the cases are returned, not run."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.ops import (cross_entropy, flash_attention_rpe,
                                       rmsnorm)

    gen = torch.Generator(device=dev).manual_seed(1)

    # the RoPE rows draw from a generator of their own, so that the other
    # rows' inputs do not depend on which rows follow them
    rope_gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0, generator=None):
        return (torch.randn(shape, generator=generator or gen, device=dev)
                * scale).to(dtype)

    cases = []

    # -- rms_norm backward (CUDA): the model's form (`cast_w`: w rounded to
    # bf16 on load, dW on store) and the op's (w and dW in fp32) ----------
    def rms_bwd_case(rows, label, main=False, cast_w=True):
        d = 512

        def bwd(x, w, rstd, dy):
            return rmsnorm.rms_norm_bwd(x, w, rstd, dy, cast_w=cast_w)

        def rstd_row_doubled(x, w, rstd, dy):
            """A planted fault: the last row's rstd doubled."""
            rstd = rstd.clone()
            rstd[-1] *= 2
            return bwd(x, w, rstd, dy)

        def last_cta_dy_zeroed(x, w, rstd, dy):
            """A planted fault: dy zeroed on the rows of the plan's last
            CTA, as dW would come out had the merge left that CTA out."""
            rows, d = x.shape
            cpl, warps, grid, _ = rmsnorm.plan(
                True, rows, d, x.dtype, dy.dtype,
                rmsnorm._vectors(d, x, w, dy), x.device.index)
            r = torch.arange(rows, device=x.device)
            dy = torch.where(((r // (warps if cpl else 1)) % grid
                              == grid - 1)[:, None], 0.0, dy).to(dy.dtype)
            return bwd(x, w, rstd, dy)

        def make():
            x = randn(rows, d)
            w = 1 + 0.1 * randn(d, dtype=torch.float32)
            dy = randn(rows, d)
            _, rstd = rmsnorm.rms_norm_plain(x, w, cast_w=cast_w)
            xl = x.detach().requires_grad_(True)
            wl = (w.to(torch.bfloat16) if cast_w else w).requires_grad_(True)
            y = F.rms_norm(xl, (d,), wl, 1e-6)
            return (x, w, rstd, dy), (y, xl, wl, dy)
        (x, w, rstd, dy), _ = make()
        cases.append(dict(
            name="rms_norm_bwd", label=label, make=make, outputs=2,
            in_bytes=3 * nbytes(x), kernel=bwd,
            plain=lambda x, w, rstd, dy: rmsnorm.rms_norm_bwd_plain(
                x, w, rstd, dy, cast_w=cast_w),
            library=lambda y, x, w, dy: torch.autograd.grad(
                y, (x, w), dy, retain_graph=True),
            library_note=("autograd backward of F.rms_norm, the weight "
                          "cast to bf16 beforehand" if cast_w else
                          "autograd backward of F.rms_norm, the fp32 "
                          "weight as it is"),
            atol=1e-3, rtol=BF16_ULP, scaled=True,
            bytes=nbytes(x, dy, rstd, w) + nbytes(x) + d * 4,
            ops=8 * rows * d, ops_type="f32", main=main,
            faults=[("the last row's rstd doubled", rstd_row_doubled),
                    ("dy zeroed on the last CTA's rows",
                     last_cta_dy_zeroed)],
            why="dx in bf16: one bf16 ulp; dW an fp32 sum over the rows in "
                "another order: 1e-3 of its largest entry"))

    rms_bwd_case(TRAIN_B * TRAIN_ENC, "encoder x, dy (8192, 512) bf16, w f32",
                 main=True)
    rms_bwd_case(TRAIN_B * TRAIN_DEC, "decoder x, dy (2048, 512) bf16, w f32")
    rms_bwd_case(PRETRAIN_B * TRAIN_DEC, "pretraining decoder x, dy "
                 "(16384, 512) bf16, w f32")
    rms_bwd_case(PRETRAIN_B * TRAIN_ENC, "pretraining encoder x, dy "
                 "(65536, 512) bf16, w f32")
    rms_bwd_case(TRAIN_B * TRAIN_ENC, "op form: x, dy (8192, 512) bf16, "
                 "w f32 unrounded, dW f32", cast_w=False)

    # -- attention backward (CUDA) and the forward without a table -------
    def attn_case(m_len, n_len, causal, table, label, main=False, g=None):
        b, h, d = TRAIN_B, 8, 64
        kw = dict(causal=causal, bidirectional=not causal, sm_scale=1.0)
        # without a table the library call takes its own causal mask
        lib_causal = causal and not table

        def make():
            q, do = (randn(b, h, m_len, d, generator=g),
                     randn(b, h, m_len, d, generator=g))
            k, v = (randn(b, h, n_len, d, generator=g),
                    randn(b, h, n_len, d, generator=g))
            w = (randn(32, h, dtype=torch.float32, scale=0.5)
                 if table else None)
            o, lse = flash_attention_rpe.flash_attention_rpe_fwd(q, k, v, w,
                                                                 **kw)
            delta = (do.float() * o.float()).sum(-1)
            mask = None
            if table:
                mask = positional.t5_relative_bias(
                    {"relative_attention_bias": w}, m_len, n_len,
                    bidirectional=not causal)
                if causal:
                    mask = torch.where(flash_attention_rpe._visible(
                        m_len, n_len, True, dev), mask, -1e30)
                mask = mask.to(torch.bfloat16)
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                 is_causal=lib_causal,
                                                 scale=1.0)
            return ((q, k, v, w, lse, delta, do),
                    (out, ql, kl, vl, do))
        (q, k, v, w, lse, delta, do), _ = make()
        pairs = m_len * n_len
        if causal:   # the scores a bottom-right causal mask leaves
            pairs = int(flash_attention_rpe._visible(m_len, n_len, True,
                                                     "cpu").sum())

        def kernel(q, k, v, w, lse, delta, do):
            return flash_attention_rpe.flash_attention_bwd(
                q, k, v, w, lse, delta, do, **kw)

        def limits(q, k, v, w, lse, delta, do, want):
            """dq, dk, dv: the plain module's `grad_limits`, from the
            rounding points; dW: DW_TOL of the sum of |dS| over each
            bucket's scores, the scale of its rounding error."""
            lims = flash_attention_rpe.grad_limits(
                flash_attention_rpe.flash_attention_grad_abs_plain(
                    q, k, v, w, lse, delta, do, **kw),
                want[:3], k.shape[2], q.shape[2])
            if w is not None:
                lims.append(DW_TOL * flash_attention_rpe
                            .flash_attention_dw_abs_plain(
                                q, k, v, w, lse, delta, do, **kw))
            return lims
        if main:
            faults = [("the bucket one above", _bucket_one_above(kernel))]
        elif not table:
            faults = [_keys_rolled(kernel)]
        else:
            faults = []
        cases.append(dict(
            name="flash_attention_bwd", label=label, make=make, outputs=4,
            in_bytes=8 * nbytes(q) + 2 * nbytes(lse),
            kernel=kernel,
            plain=lambda q, k, v, w, lse, delta, do:
                flash_attention_rpe.flash_attention_bwd_plain(
                    q, k, v, w, lse, delta, do, **kw),
            faults=faults,
            library=lambda out, q, k, v, do: torch.autograd.grad(
                out, (q, k, v), do, retain_graph=True),
            library_note="autograd backward of F.scaled_dot_product_attention"
                         + (" with the bias as a float mask; no dW"
                            if table else
                            ", is_causal" if lib_causal else ""),
            limits=limits,
            bytes=nbytes(q, k, v, do) + nbytes(q) + nbytes(q, k, v)
            + nbytes(lse) + (nbytes(w) if table else 0),
            ops=10 * b * h * pairs * d, ops_type="bf16", main=main,
            why=f"dq, dk, dv in bf16, from the rounding points: one bf16 "
                f"ulp of each entry (its own rounding) plus one bf16 ulp, "
                f"and n f32 ulps, of the sum of the magnitudes its bf16 P "
                f"or dS terms carry (|dS| |k|, |dS|^T |q|, P^T |dO|, each "
                f"with D 2^-16 of the f32 scores' and dP's sums of |products| "
                f"on P and dS), since P and dS rounded from f32 values an "
                f"f32 ulp apart may land one bf16 ulp apart; dW, an fp32 sum "
                f"that nearly cancels: {DW_TOL} of each bucket's sum of "
                f"|dS|"))

    attn_case(TRAIN_ENC, TRAIN_ENC, False, True,
              "encoder q,k,v (8,8,1024,64) bf16, bidirectional, table",
              main=True)
    attn_case(TRAIN_DEC, TRAIN_ENC, False, False,
              "cross q (8,8,256,64), k,v (8,8,1024,64) bf16, no table")
    attn_case(TRAIN_DEC, TRAIN_DEC, True, True,
              "decoder self q,k,v (8,8,256,64) bf16, causal, table")
    # RoPE's self-attention: the same shapes without a table
    if not rope_generator:
        rope_gen = None
    attn_case(TRAIN_ENC, TRAIN_ENC, False, False,
              "RoPE encoder q,k,v (8,8,1024,64) bf16, bidirectional, "
              "no table", g=rope_gen)
    attn_case(TRAIN_DEC, TRAIN_DEC, True, False,
              "RoPE decoder self q,k,v (8,8,256,64) bf16, causal, no table",
              g=rope_gen)

    # the forward at the train step's shapes: the encoder's (with the
    # table), the cross-attention's, and RoPE's encoder and causal decoder
    # self-attention (without)
    def fwd_case(m_len, n_len, causal, table, label, g=None):
        kw = dict(causal=causal, bidirectional=not causal)
        pairs = m_len * n_len
        if causal:
            pairs = int(flash_attention_rpe._visible(m_len, n_len, True,
                                                     "cpu").sum())

        def make():
            q = randn(TRAIN_B, 8, m_len, 64, generator=g)
            k, v = (randn(TRAIN_B, 8, n_len, 64, generator=g),
                    randn(TRAIN_B, 8, n_len, 64, generator=g))
            w = (randn(32, 8, dtype=torch.float32, scale=0.5)
                 if table else None)
            bias = None if w is None else positional.t5_relative_bias(
                {"relative_attention_bias": w}, m_len, n_len,
                bidirectional=not causal).to(torch.bfloat16)
            return (q, k, v, w), (q, k, v, bias)
        (q, k, v, w), _ = make()
        assert not (causal and table)
        cases.append(dict(
            name="flash_attention_rpe", label=label, make=make,
            in_bytes=nbytes(q, k, v) + (8 * m_len * n_len * 2
                                        if table else 0),
            kernel=lambda q, k, v, w: flash_attention_rpe
            .flash_attention_rpe_fwd(q, k, v, w, **kw),
            plain=lambda q, k, v, w: flash_attention_rpe
            .flash_attention_rpe_plain(q, k, v, w, **kw),
            library=lambda q, k, v, bias: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, is_causal=causal, scale=1.0),
            library_note="F.scaled_dot_product_attention"
                         + (", the bias as a float mask" if table else
                            ", is_causal" if causal else ""),
            atol=2e-2, rtol=BF16_ULP, bytes=nbytes(q, k, v) + nbytes(q)
            + TRAIN_B * 8 * m_len * 4 + (nbytes(w) if table else 0),
            ops=4 * TRAIN_B * 8 * pairs * 64, ops_type="bf16",
            main=False, faults=[_keys_rolled(**kw)],
            why="bf16 output and P rounded to bf16 against per-tile maxima"))

    fwd_case(TRAIN_ENC, TRAIN_ENC, False, True, "encoder forward q,k,v "
             "(8,8,1024,64) bf16, bidirectional, table")
    fwd_case(TRAIN_DEC, TRAIN_ENC, False, False, "cross forward q "
             "(8,8,256,64), k,v (8,8,1024,64) bf16, no table")
    fwd_case(TRAIN_ENC, TRAIN_ENC, False, False, "RoPE encoder forward "
             "q,k,v (8,8,1024,64) bf16, bidirectional, no table", g=rope_gen)
    fwd_case(TRAIN_DEC, TRAIN_DEC, True, False, "RoPE decoder self forward "
             "q,k,v (8,8,256,64) bf16, causal, no table", g=rope_gen)

    # -- cross-entropy forward and backward (Triton) ----------------------
    rows, vocab = TRAIN_B * TRAIN_DEC, 32768

    def make_ce():
        logits = randn(rows, vocab, scale=3.0)
        labels = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        lse = torch.logsumexp(logits.float(), -1)
        dloss = torch.full((rows,), 1.0 / rows, device=dev)
        dz = torch.zeros((rows,), device=dev)
        ll = logits.detach().requires_grad_(True)
        loss = F.cross_entropy(ll, labels, reduction="none")
        return ((logits, labels, lse, dloss, dz),
                (logits, labels, loss, ll, dloss))
    (logits, labels, lse, dloss, dz), _ = make_ce()

    def ce_fwd(plain=False, shift=0):
        """The forward's (loss, lse, z-loss) rows, z-loss 1e-4; `shift`
        moves every label by that many columns (a planted fault)."""
        fn = (cross_entropy.cross_entropy_fwd_plain if plain
              else cross_entropy.cross_entropy_fwd)
        return lambda x, labels, *rest: tuple(fn(
            x, (labels + shift) % vocab if shift else labels,
            lse_square_scale=1e-4))
    cases.append(dict(
        name="cross_entropy_fwd", label="logits (2048, 32768) bf16, z-loss "
        "1e-4: (loss, lse, z-loss), the loss in the kernel's epilogue",
        make=make_ce, in_bytes=2 * nbytes(logits), outputs=3,
        kernel=ce_fwd(), plain=ce_fwd(plain=True),
        faults=[("labels one column off", ce_fwd(shift=1))],
        library=lambda x, labels, *rest: F.cross_entropy(
            x, labels, reduction="none"),
        library_note="F.cross_entropy forward (no z-loss)",
        atol=1e-4, rtol=1e-5, bytes=nbytes(logits, labels) + 3 * rows * 4,
        ops=4 * rows * vocab, ops_type="f32", main=True,
        why="fp32 log-sum-exp over 32768 values in another order; the "
            "label's logit read alike",
        count_launches=True))
    def ce_bwd(x, labels, lse, dloss, dz):
        return cross_entropy.cross_entropy_bwd(x, labels, lse, dloss, dz,
                                               lse_square_scale=1e-4)

    def where_small(fn):
        """A planted fault: `fn` applied to the entries of dlogits under
        1e-6 (all but the largest few per row)."""
        def fault(*args):
            g = ce_bwd(*args)
            return torch.where(g.abs() < 1e-6, fn(g), g)
        return fault
    cases.append(dict(
        name="cross_entropy_bwd", label="logits (2048, 32768) bf16, z-loss "
        "1e-4", make=make_ce, in_bytes=2 * nbytes(logits),
        kernel=ce_bwd,
        plain=lambda x, labels, lse, dloss, dz:
            cross_entropy.cross_entropy_bwd_plain(x, labels, lse, dloss, dz,
                                                  lse_square_scale=1e-4),
        faults=[("entries under 1e-6 flushed to 0",
                 where_small(torch.zeros_like)),
                ("entries under 1e-6 doubled", where_small(lambda g: 2 * g))],
        library=lambda x, labels, loss, ll, dloss: torch.autograd.grad(
            loss, ll, dloss, retain_graph=True),
        library_note="autograd backward of F.cross_entropy (no z-loss)",
        atol=0.0, rtol=BF16_ULP, bytes=2 * nbytes(logits) + rows * 16,
        ops=10 * rows * vocab, ops_type="f32", main=True,
        why="bf16 dlogits from the same lse, exp by another implementation "
            "in fp32: one bf16 ulp of each entry (a flip of its rounding) "
            "and no absolute floor, so every entry is held"))

    # -- the vocab-split form: the train step's logits in 4 shards of 8192,
    # smoothing spread over the whole vocabulary, z-loss 1e-4 ---------------
    n_shards = 4
    sv = vocab // n_shards
    split_kw = dict(lse_square_scale=1e-4, label_smoothing=0.1,
                    total_classes=vocab)

    def make_shard():
        logits = randn(rows, vocab, scale=3.0)
        labels = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        shard = logits[:, sv:2 * sv].contiguous()
        del logits
        lse = torch.logsumexp(shard.float(), -1)
        dloss = torch.full((rows,), 1.0 / rows, device=dev)
        dz = torch.zeros((rows,), device=dev)
        local = labels - sv
        local = torch.where((local >= 0) & (local < sv), local, -100)
        ll = shard.detach().requires_grad_(True)
        loss = F.cross_entropy(ll, local, reduction="none")
        return ((shard, labels, lse, dloss, dz),
                (shard, local, loss, ll, dloss))

    def split_loss(start, plain=False):
        """The split loss at one rank: the forward kernel's split form on
        the shard, then the combine over the one shard's (partial, lse)
        rows: (loss, lse, z-loss)."""
        fwd, comb = ((cross_entropy.cross_entropy_fwd_plain,
                      cross_entropy.cross_entropy_combine_plain) if plain
                     else (cross_entropy.cross_entropy_fwd,
                           cross_entropy.cross_entropy_combine))

        def fn(shard, labels, *rest):
            out = fwd(shard, labels, class_start_idx=start, split=True,
                      **split_kw)
            return tuple(comb(out[None, :2], labels, lse_square_scale=1e-4))
        return fn

    def split_bwd(start, plain=False):
        fn = (cross_entropy.cross_entropy_bwd_plain if plain
              else cross_entropy.cross_entropy_bwd)

        def bwd(shard, labels, lse, dloss, dz):
            return fn(shard, labels, lse, dloss, dz, class_start_idx=start,
                      **split_kw)
        return bwd
    (shard, labels, lse, dloss, dz), _ = make_shard()
    off_by_one = "class_start_idx one too high"
    shard_label = (f"shard 2 of 4: logits (2048, {sv}) of {vocab} bf16, "
                   f"class_start_idx {sv}, smoothing 0.1 over {vocab}")
    cases.append(dict(
        name="cross_entropy_fwd", label=shard_label + ", z-loss 1e-4, "
        "split: the kernel, then cross_entropy_combine over the one shard: "
        "(loss, lse, z-loss)",
        make=make_shard, in_bytes=2 * nbytes(shard), outputs=3,
        kernel=split_loss(sv), plain=split_loss(sv, plain=True),
        faults=[(off_by_one, split_loss(sv + 1))],
        library=lambda x, labels, *rest: F.cross_entropy(
            x, labels, reduction="none"),
        library_note="F.cross_entropy forward on the shard, labels of other "
                     "shards ignored (a yardstick: no call computes the "
                     "partial loss)",
        atol=1e-4, rtol=1e-5, bytes=nbytes(shard, labels) + rows * 36,
        ops=4 * rows * sv, ops_type="f32", main=False,
        why="fp32 log-sum-exp and row sum over 8192 values in another "
            "order; the label's logit read alike",
        count_launches=True))
    cases.append(dict(
        name="cross_entropy_bwd", label=shard_label + ", z-loss 1e-4",
        make=make_shard, in_bytes=2 * nbytes(shard),
        kernel=split_bwd(sv), plain=split_bwd(sv, plain=True),
        faults=[(off_by_one, split_bwd(sv + 1))],
        library=lambda x, labels, loss, ll, dloss: torch.autograd.grad(
            loss, ll, dloss, retain_graph=True),
        library_note="autograd backward of F.cross_entropy on the shard",
        atol=2.0 ** -24, scaled=True, rtol=BF16_ULP,
        bytes=2 * nbytes(shard) + rows * 16, ops=10 * rows * sv,
        ops_type="f32", main=False,
        why="one bf16 ulp of each entry, plus one f32 ulp of the largest "
            "entry where smoothing's constant cancels the probability"))

    def make_shards():
        logits = randn(rows, vocab, scale=3.0)
        labels = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        shards = [logits[:, i * sv:(i + 1) * sv].contiguous()
                  for i in range(n_shards)]
        return (logits, labels, *shards), (logits, labels)

    def combined(bad=None):
        """The shards' split forwards combined as tensor parallelism
        combines them: their (partial, lse) rows stacked, then
        `cross_entropy_combine`: (loss, lse, z-loss)."""
        def fn(logits, labels, *shards):
            parts = torch.stack([cross_entropy.cross_entropy_fwd(
                shard, labels, class_start_idx=i * sv + (i == bad),
                split=True, **split_kw)[:2]
                for i, shard in enumerate(shards)])
            return tuple(cross_entropy.cross_entropy_combine(
                parts, labels, lse_square_scale=1e-4))
        return fn
    (logits, labels, *shards), _ = make_shards()
    cases.append(dict(
        name="cross_entropy_fwd", label=f"4 shards of (2048, {sv}) combined "
        f"against the unsplit (2048, {vocab}) bf16 loss, smoothing 0.1, "
        f"z-loss 1e-4: (loss, lse, z-loss)", make=make_shards,
        in_bytes=2 * nbytes(logits), outputs=3, kernel=combined(),
        plain=lambda logits, labels, *rest: tuple(
            cross_entropy.cross_entropy_fwd_plain(
                logits, labels, lse_square_scale=1e-4,
                label_smoothing=0.1)),
        faults=[("shard 3's " + off_by_one, combined(bad=2))],
        library=lambda logits, labels: F.cross_entropy(
            logits, labels, reduction="none", label_smoothing=0.1),
        library_note="F.cross_entropy forward on the whole logits, "
                     "smoothing 0.1 (no z-loss)",
        atol=2e-4, rtol=1e-5, bytes=nbytes(logits, labels) + rows * 36,
        ops=4 * rows * vocab, ops_type="f32", main=False,
        why="the global lse by logsumexp of four shard lses against one "
            "streaming pass, row sums in another order",
        count_launches=True))

    # -- the combine alone: four shards' (partial, lse) rows --------------
    def make_parts():
        parts = torch.randn((n_shards, 2, rows), generator=gen, device=dev)
        parts[:, 1] = 10.0 + parts[:, 1]
        labels = torch.randint(0, vocab, (rows,), generator=gen, device=dev)
        labels[::7] = -100
        return (parts, labels), (parts, labels)
    (parts, labels), _ = make_parts()
    cases.append(dict(
        name="cross_entropy_combine", label=f"parts ({n_shards}, 2, "
        f"{rows}) f32 (partials and shard lses drawn from a seeded normal), "
        "z-loss 1e-4: (loss, lse, z-loss)", make=make_parts,
        in_bytes=nbytes(parts, labels), outputs=3,
        kernel=lambda p, y: tuple(cross_entropy.cross_entropy_combine(
            p, y, lse_square_scale=1e-4)),
        plain=lambda p, y: tuple(cross_entropy.cross_entropy_combine_plain(
            p, y, lse_square_scale=1e-4)),
        faults=[("shard 0 left out", lambda p, y: tuple(
            cross_entropy.cross_entropy_combine(p[1:], y,
                                                lse_square_scale=1e-4)))],
        library=None, atol=1e-5, rtol=1e-6,
        bytes=nbytes(parts, labels) + 3 * rows * 4, ops=6 * n_shards * rows,
        ops_type="f32", main=True,
        why="the same log-sum-exp over four values, in another order"))
    del logits, shards, shard, parts
    return run_checks(cases) if run else cases


def check_wgmma_descriptor(dev):
    """wgmma's MN-major B operand alone, before any kernel that reads V, K,
    Q or dO through it runs: a (64, 64) @ (64, N) product of seeded bf16
    values for N 64 and 128, A from shared memory and from registers,
    against torch.matmul in f32 (exact products, f32 sums in another
    order: 1e-5 of the largest entry), and b's rows rolled by one (a
    descriptor that read the wrong rows) beyond it."""
    from flasht5_tpu_torch.ops import flash_attention_rpe as rpe
    gen = torch.Generator(device=dev).manual_seed(7)
    for n in (64, 128):
        a, b = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((64, 64), (64, n)))
        want = a.float() @ b.float()
        lim = 1e-5 * float(want.abs().max())
        errs = [float((c - want).abs().max())
                for c in rpe.wgmma_mn_check(a, b)]
        fault = float((rpe.wgmma_mn_check(a, torch.roll(b, 1, 0))[0]
                       - want).abs().max())
        print(f"wgmma MN-major descriptor, (64, 64) @ (64, {n}) bf16: max abs "
              f"err A in shared memory {errs[0]}, A in registers {errs[1]} "
              f"(limit {lim}); b's rows rolled by one: {fault}", flush=True)
        if not (max(errs) <= lim and fault > lim):
            raise AssertionError(f"wgmma MN-major descriptor at N {n}: "
                                 f"{errs}, fault {fault}, limit {lim}")


# ---------------------------------------------------------------------------
# pretraining: the materialized-bias attention kernels
# ---------------------------------------------------------------------------

DBIAS_TOL = 1e-4          # of each dbias entry, plus as much of the largest


def check_bias_grad_kernel(dev):
    """The T5 bucket table's gradient (`ops.t5_bias_grad`, the backward of
    the pretraining step's bias gather) against its plain version, the
    `index_put_(accumulate=True)` that autograd's gather runs (which is
    also its library yardstick): at the pretraining encoder's (1, 8, 1024,
    1024) bidirectional bias and the decoder's (1, 8, 256, 256) causal
    one, and at the encoder's shape with randomized positions under 2048.
    Planted fault: every key's bucket moved one key over."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.ops import t5_bias_grad

    gen = torch.Generator(device=dev).manual_seed(5)
    cases = []

    def case(m_len, n_len, bidirectional, explicit, label, main=False):
        nb, h = 32, 8
        kw = dict(bidirectional=bidirectional, num_buckets=nb, max_len=2048)
        if explicit:
            cpu_gen = torch.Generator().manual_seed(6)
            kw.update({key: positional._randomized_positions(
                cpu_gen, length, 2048) for key, length in
                (("q_positions", m_len), ("k_positions", n_len))})
        buckets = positional.bucket_map(m_len, n_len, device=dev, **kw)

        def make():
            g = torch.randn((1, h, m_len, n_len), device=dev, generator=gen)
            return (g, buckets), None

        def kernel(g, buckets):
            return t5_bias_grad.t5_bias_grad(g, buckets, nb)

        def plain(g, buckets):
            return t5_bias_grad.t5_bias_grad_plain(g, buckets, nb)

        def limits(g, buckets, want):
            return [1e-6 * t5_bias_grad.t5_bias_grad_plain(g.abs(), buckets,
                                                           nb) + 1e-6]

        def shifted(g, buckets):
            return kernel(g, torch.roll(buckets, 1, dims=1))

        g = make()[0][0]
        cases.append(dict(
            name="t5_bias_grad", label=label, make=make, in_bytes=nbytes(g),
            kernel=kernel, plain=plain, limits=limits,
            faults=([("every key's bucket one key over", shifted)]
                    if main else []),
            library=None, library_note="the plain version is the call",
            bytes=nbytes(g, buckets) + nb * h * 4, ops=g.numel(),
            ops_type="f32", main=main,
            why="f32 sums of the same dbias entries in another order than "
                "index_put_'s: 1e-6 of each bucket's sum of |dbias|, plus "
                "1e-6"))

    case(1024, 1024, True, False,
         "encoder dbias (1,8,1024,1024) f32, bidirectional", main=True)
    case(256, 256, False, False, "decoder dbias (1,8,256,256) f32, causal")
    case(1024, 1024, True, True,
         "encoder dbias (1,8,1024,1024) f32, randomized positions")
    return run_checks(cases)


def check_bias_kernels(dev, run=True):
    """The three bias kernels (forward, dK/dV + dbias, dQ) against their
    plain versions, entry by entry: at the pretraining driver's own shapes
    (batch 64: the encoder's self-attention with the T5 bias of one table,
    (1, 8, 1024, 1024), and the decoder's causal self-attention), at batch 8
    (the training slice's shapes, to compare with its rows), on a ragged
    causal shape with one bias for all heads, and on a per-batch
    (B, H, M, N) bias with use_masking's padded query rows (-1e29 after the
    clamp). The library yardstick: F.scaled_dot_product_attention with the
    bias as a float attn_mask, and for the backward its autograd with the
    mask requiring grad (dq, dk, dv and dbias in one call); the kernels it
    runs are printed. The biases of the other encodings at the train step's
    shapes (batch 8): ALiBi's asymmetric one (half the heads with the future
    at -inf, half with the past, clamped at -1e29 as the wrapper clamps
    them) at the encoder and the causal decoder, and FIRE's (its MLP's
    output, whose dbias trains the MLP) at the encoder. Planted faults at
    the pretraining encoder shape and at each of those: the bias rows shifted
    by one (each kernel), and dbias summed over the heads as well as the
    batch. With `run=False` the cases are returned, not run."""
    from flasht5_tpu_torch import positional
    from flasht5_tpu_torch.ops import flash_attention as fa
    from flasht5_tpu_torch.ops import flash_attention_rpe as rpe

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def t5_bias(m_len, n_len, causal):
        table = randn(32, 8, dtype=torch.float32, scale=0.5)
        return positional.t5_relative_bias(
            {"relative_attention_bias": table}, m_len, n_len,
            bidirectional=not causal)

    def shifted(fn):
        def fault(q, k, v, bias, *rest):
            return fn(q, k, v, torch.roll(bias, 1, dims=2), *rest)
        return fault

    def wrong_axis(*args, **kw):
        with _patched(fa, "_reduce", lambda full, shape: full.sum(
                (0, 1), keepdim=True).expand(shape)):
            return fa.flash_attention_bias_dkv(*args, **kw)

    def fwd_lib(q, k, v, mask, *rest):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=1.0)

    def bwd_lib(q, k, v, mask, out, ql, kl, vl, ml, do):
        return torch.autograd.grad(out, (ql, kl, vl, ml), do,
                                   retain_graph=True)

    def sums(q, k, v, bias, lse, delta, do, kw):
        return rpe.grad_abs_plain(q, k, v, bias.float(), lse, delta, do,
                                  **kw)

    def grad_limits(q, k, v, bias, lse, delta, do, want, kw):
        """dk, dv: the plain module's `grad_limits`, from the rounding
        points; dbias (fp32 dS, summed by the same PyTorch sum on both
        sides): DBIAS_TOL of each entry plus DBIAS_TOL of the largest."""
        lims = rpe.grad_limits(
            sums(q, k, v, bias, lse, delta, do, kw)[1:], want[:2],
            q.shape[2], q.shape[2])
        lims.append(DBIAS_TOL * want[2].abs().max()
                    + DBIAS_TOL * want[2].abs())
        return lims

    def dq_limits(q, k, v, bias, lse, delta, do, want, kw):
        """dq: the plain module's `grad_limits`, from the rounding
        points."""
        return rpe.grad_limits(sums(q, k, v, bias, lse, delta, do, kw)[:1],
                               want, k.shape[2], q.shape[2])

    cases, yardsticks = [], {}
    fire = positional.init_fire_params(gen, 8, init_L=128.0, device=dev)
    shapes = [
        ("encoder", 64, 1024, 1024, False, "t5", True),
        ("decoder self", 64, 256, 256, True, "t5", False),
        ("encoder", 8, 1024, 1024, False, "t5", False),
        ("decoder self", 8, 256, 256, True, "t5", False),
        ("ragged", 8, 300, 700, True, "11", False),
        ("masked rows", 8, 512, 512, False, "bh", False),
        ("ALiBi encoder", 8, 1024, 1024, False, "alibi_asym", False),
        ("ALiBi decoder self", 8, 256, 256, True, "alibi_asym", False),
        ("FIRE encoder", 8, 1024, 1024, False, "fire", False),
    ]
    for tag, b, m_len, n_len, causal, form, main in shapes:
        kw = dict(causal=causal, sm_scale=1.0)
        faulted = main or form in ("alibi_asym", "fire")

        def make(b=b, m_len=m_len, n_len=n_len, causal=causal, form=form,
                 kw=kw):
            q, do = randn(b, 8, m_len, 64), randn(b, 8, m_len, 64)
            k, v = randn(b, 8, n_len, 64), randn(b, 8, n_len, 64)
            if form == "t5":
                bias = t5_bias(m_len, n_len, causal)
            elif form == "alibi_asym":
                bias = positional.alibi_bias(
                    8, m_len, n_len, mode="asymetric",
                    device=dev).clamp_min(-1e29)
            elif form == "fire":
                bias = positional.fire_bias(fire, m_len)
            elif form == "11":
                bias = randn(1, 1, m_len, n_len, dtype=torch.float32)
            else:     # use_masking's fold of padded query rows, clamped
                bias = t5_bias(m_len, n_len, causal).expand(
                    b, -1, -1, -1).clone()
                for i in range(b):
                    bias[i, :, m_len - 37 * i:] = -1e29
            o, lse = fa.flash_attention_bias_fwd(q, k, v, bias, **kw)
            delta = (do.float() * o.float()).sum(-1)
            mask = bias
            if causal:
                mask = torch.where(rpe._visible(m_len, n_len, True, dev),
                                   bias, -1e30)
            mask = mask.to(torch.bfloat16)
            ql, kl, vl, ml = (t.detach().requires_grad_(True)
                              for t in (q, k, v, mask))
            out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=ml,
                                                 scale=1.0)
            return ((q, k, v, bias, lse, delta, do),
                    (q, k, v, mask, out, ql, kl, vl, ml, do))

        (q, k, v, bias, lse, delta, do), lib = make()
        pairs = m_len * n_len
        if causal:
            pairs = int(rpe._visible(m_len, n_len, True, "cpu").sum())
        bh_ops = b * 8 * pairs * 64
        in_bytes = nbytes(q, k, v, do, lse, delta, bias) + nbytes(*lib[:4])
        label = (f"{tag} q ({b},8,{m_len},64), k,v ({b},8,{n_len},64) bf16, "
                 f"{'causal, ' if causal else ''}bias "
                 f"{tuple(bias.shape)} f32")
        if main:
            yardsticks = dict(forward=(fwd_lib, lib), backward=(bwd_lib, lib))
        bwd_note = ("autograd backward of F.scaled_dot_product_attention "
                    "with the bf16 mask requiring grad (dq, dk, dv and dbias "
                    "in one call)")
        common = dict(label=label, make=make, in_bytes=in_bytes, main=main,
                      ops_type="bf16")
        cases.append(dict(
            common, name="flash_attention_bias", outputs=2,
            kernel=lambda q, k, v, bias, *rest, kw=kw:
                fa.flash_attention_bias_fwd(q, k, v, bias, **kw),
            plain=lambda q, k, v, bias, *rest, kw=kw:
                fa.flash_attention_bias_plain(q, k, v, bias, **kw),
            faults=([("bias rows shifted by one", shifted(
                lambda q, k, v, bias, *rest, kw=kw:
                    fa.flash_attention_bias_fwd(q, k, v, bias, **kw)))]
                    if faulted else []),
            library=fwd_lib,
            library_note="F.scaled_dot_product_attention, the bias as a "
                         "bf16 float mask",
            atol=2e-2, rtol=BF16_ULP,
            bytes=nbytes(q, k, v, bias) + nbytes(q) + nbytes(lse),
            ops=4 * bh_ops,
            why="bf16 output and P rounded to bf16 against per-tile maxima; "
                "lse in fp32"))
        cases.append(dict(
            common, name="flash_attention_bias_dkv", outputs=3,
            kernel=lambda *a, kw=kw: fa.flash_attention_bias_dkv(*a, **kw),
            plain=lambda *a, kw=kw: fa.flash_attention_bias_dkv_plain(*a,
                                                                     **kw),
            faults=([("bias rows shifted by one",
                      shifted(lambda *a, kw=kw:
                              fa.flash_attention_bias_dkv(*a, **kw))),
                     ("dbias summed over the heads as well as the batch",
                      lambda *a, kw=kw: wrong_axis(*a, **kw))]
                    if faulted else []),
            library=bwd_lib, library_note=bwd_note,
            limits=lambda *a, kw=kw: grad_limits(*a, kw),
            bytes=nbytes(q, k, v, do, lse, delta, bias) + nbytes(k, v)
            + bias.numel() * 4, ops=8 * bh_ops,
            extra=dict(dbias_per_batch_bytes=b * 8 * m_len * n_len * 4),
            why=f"dk, dv in bf16: one bf16 ulp of each entry plus one bf16 "
                f"ulp of the sum of the magnitudes its bf16 P or dS terms "
                f"carry (ops/flash_attention_rpe.py::grad_limits); dbias, "
                f"fp32 dS summed by the same PyTorch sum on both sides: "
                f"{DBIAS_TOL} of each entry plus {DBIAS_TOL} of the "
                f"largest"))
        cases.append(dict(
            common, name="flash_attention_bias_dq", outputs=1,
            kernel=lambda *a, kw=kw: fa.flash_attention_bias_dq(*a, **kw),
            plain=lambda *a, kw=kw: fa.flash_attention_bias_dq_plain(*a,
                                                                    **kw),
            faults=([("bias rows shifted by one",
                      shifted(lambda *a, kw=kw:
                              fa.flash_attention_bias_dq(*a, **kw)))]
                    if faulted else []),
            library=bwd_lib, library_note=bwd_note,
            limits=lambda *a, kw=kw: dq_limits(*a, kw),
            bytes=nbytes(q, k, v, do, lse, delta, bias) + nbytes(q),
            ops=6 * bh_ops,
            why="dq in bf16: one bf16 ulp of each entry plus one bf16 ulp "
                "of the sum of the magnitudes its bf16 dS terms carry "
                "(ops/flash_attention_rpe.py::grad_limits)"))
        del q, k, v, bias, lse, delta, do, lib
    if not run:
        return cases
    results = run_checks(cases)
    for way, (fn, args) in yardsticks.items():
        by_name = _kernels_by_name(lambda: fn(*args))
        top = sorted(by_name, key=lambda name: -by_name[name][0])[:2]
        print(f"library yardstick at the driver's encoder shape, {way}: "
              f"SDPA runs "
              f"{[name[:60] for name in top]}", flush=True)
    return results


# ---------------------------------------------------------------------------
# scoring and the fused train step: the fused lm_head + CE kernels
# ---------------------------------------------------------------------------

SCORING_ROWS = 4 * 64      # bench_quality.py:89-93: 4 x 64 label rows


def _flce_limits(kw, bf16):
    """Per-entry limits of the fused lm_head+CE kernels' outputs against
    their plain versions (`check_flce_kernels`)."""
    from flasht5_tpu_torch.ops import fused_linear_ce as flce
    from flasht5_tpu_torch.ops.cross_entropy import cross_entropy_bwd_plain

    full = dict(lse_square_scale=kw.get("lse_square_scale", 0.0),
                label_smoothing=kw.get("label_smoothing", 0.0),
                logit_scale=kw.get("logit_scale", 1.0), ignore_index=-100,
                total_classes=None)

    def fwd(x, w, labels, lse, dloss, dz, want):
        # lse: f32 sums of the same products in another order; the row sum
        # of the logits: 1e-6 of the row's sum of |logits|
        lse, total = want
        lim = [1e-5 + 1e-5 * lse.abs(), None]
        if total is not None:
            lim[1] = 1e-6 * flce._logits(x, w, full["logit_scale"]).abs() \
                .sum(-1)
        return lim

    def bwd(x, w, labels, lse, dloss, dz, want):
        # a dlogit whose two f32 values straddle a bf16 rounding boundary
        # rounds one ulp apart (up to 2^-7 relative), in any term of a sum:
        # two such flips (2^-6) times the largest |term factor| pair of
        # each entry's sum (the tensor cores' f32 sums of the logits differ
        # from cuBLAS's in their last bits, and an entry of dW sums 2048
        # terms), plus 1e-4 of the entry (f32 sums in another order), plus
        # one bf16 ulp of a bf16 dx; in f32, 1e-5 for the sums' order
        dl = cross_entropy_bwd_plain(flce._logits(x, w, 1.0), labels, lse,
                                     dloss, dz, **full).to(x.dtype).float()
        dla = dl.abs()
        wa = w.to(x.dtype).float().abs()
        xa = x.float().abs()
        flip = 2.0 ** -6 if bf16 else 1e-5
        dx_lim = (flip * dla.amax(1)[:, None] * wa.amax(1)[None, :]
                  + (2.0 ** -7 if bf16 else 1e-4) * want[0].float().abs())
        dw_lim = (flip * xa.amax(0)[:, None] * dla.amax(0)[None, :]
                  + 1e-4 * want[1].float().abs())
        return [dx_lim, dw_lim]
    return fwd, bwd


def check_flce_kernels(dev):
    """The fused lm_head+CE kernels at the train step's shape (2048 rows,
    d 512, V 32768, bf16 activations, the f32 lm_head, z-loss 1e-4), at
    the scoring batches' 256 rows, and a ragged f32 case (300 rows, V
    32128, smoothing 0.1, logit_scale 2.0, a quarter of the rows ignored),
    at d 768 and 2048, and at d 100, whose rows TMA cannot describe; each
    forward row's profiled call must run the form its shape takes (bf16:
    the TMA + wgmma form, the mma.sync form at d 100; f32: the CUDA-core
    form). Library yardstick: the unfused composition of two PyTorch calls,
    F.linear and F.cross_entropy (no z-loss), forward or autograd's
    backward; beside it the port's own unfused path (torch.matmul of the
    cast weight and the port's Triton CE kernels), `unfused_port_ms`.
    Planted faults: the last vocab split dropped from the merge; the
    z-loss term left out of dlogits; the dW columns shifted by one."""
    from flasht5_tpu_torch.ops import cross_entropy
    from flasht5_tpu_torch.ops import fused_linear_ce as flce

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []

    def shape_cases(rows, v, x_dtype, kw, label, main, faults, d=512):
        fkw = dict(logit_scale=kw.get("logit_scale", 1.0),
                   label_smoothing=kw.get("label_smoothing", 0.0))
        ls = kw.get("label_smoothing", 0.0)

        def make():
            x = torch.randn((rows, d), generator=gen, device=dev).to(x_dtype)
            w = torch.randn((d, v), generator=gen, device=dev) * d ** -0.5
            labels = torch.randint(0, v, (rows,), generator=gen, device=dev)
            if rows == 300:
                labels[torch.rand(rows, generator=gen, device=dev)
                       < 0.25] = -100
            lse = flce.fused_linear_ce_fwd_plain(x, w, **fkw)[0]
            dloss = torch.full((rows,), 1.0 / rows, device=dev)
            dz = torch.zeros((rows,), device=dev)
            # the yardsticks' inputs and graphs, built here, not timed
            xr = x.detach().requires_grad_(True)
            wt = w.t().to(x_dtype).contiguous().requires_grad_(True)
            lib_loss = F.cross_entropy(F.linear(xr, wt) * fkw["logit_scale"],
                                       labels, reduction="none",
                                       label_smoothing=ls)
            wr = w.detach().requires_grad_(True)
            port_loss, _ = cross_entropy.cross_entropy_loss(
                torch.matmul(xr, wr.to(x_dtype)), labels,
                kw.get("lse_square_scale", 0.0), ls, fkw["logit_scale"])
            return ((x, w, labels, lse, dloss, dz),
                    (x, wt, labels, dloss, xr, lib_loss, wr, port_loss))
        (x, w, labels, lse, dloss, dz), _ = make()
        fwd_lim, bwd_lim = _flce_limits(kw, x_dtype == torch.bfloat16)
        # the backward's scratch: planned (bf16: chunks of rows, slabs of
        # the vocabulary) and the peak above its inputs and outputs
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = flce.fused_linear_ce_bwd(x, w, labels, lse, dloss, dz, **kw)
        torch.cuda.synchronize()
        workspace = dict(
            workspace_bytes=(flce.bwd_workspace_bytes(x, w)
                             if x_dtype == torch.bfloat16 else None),
            peak_above_inputs_outputs_bytes=torch.cuda.max_memory_allocated()
            - base - nbytes(*out))
        del out
        in_bytes = 2 * nbytes(x, w, labels)
        flops = 2 * rows * d * v
        ops_type = "bf16" if x_dtype == torch.bfloat16 else "f32"
        why = ("f32 sums of the same products in another order; dlogits "
               "that round to another bf16 value (2^-8 relative) where the "
               "two f32 values straddle a rounding boundary")

        def fwd(x, w, *rest):
            return flce.fused_linear_ce_fwd(x, w, **fkw)

        def split_dropped(x, w, *rest):
            part = flce.fwd_partials(x, w, **fkw)
            lse, total = flce.merge_partials(part, part.shape[1] - 1)
            return lse, (total if ls > 0.0 else None)

        def bwd(x, w, labels, lse, dloss, dz):
            return flce.fused_linear_ce_bwd(x, w, labels, lse, dloss, dz,
                                            **kw)

        def no_zloss(x, w, labels, lse, dloss, dz):
            return flce.fused_linear_ce_bwd(
                x, w, labels, lse, dloss, dz, **dict(kw, lse_square_scale=0.0))

        def dw_shifted(*args):
            dx, dw = bwd(*args)
            return dx, torch.roll(dw, 1, dims=1)

        cases.append(dict(
            name="fused_linear_ce_fwd", label=label, make=make,
            in_bytes=in_bytes, kernel=fwd,
            plain=lambda x, w, *rest: flce.fused_linear_ce_fwd_plain(
                x, w, **fkw),
            library=lambda x, wt, labels, *rest: F.cross_entropy(
                F.linear(x, wt) * fkw["logit_scale"], labels,
                reduction="none", label_smoothing=ls),
            library_note="F.linear + F.cross_entropy, two calls (no z-loss)",
            unfused=lambda x, wt, labels, dloss, xr, ll, wr, pl:
                cross_entropy.cross_entropy_loss(
                    torch.matmul(x, wr.detach().to(x.dtype)), labels,
                    kw.get("lse_square_scale", 0.0), ls, fkw["logit_scale"]),
            unfused_note="torch.matmul(x, w cast) + the port's Triton CE "
                         "forward and loss assembly",
            outputs=2, limits=fwd_lim,
            faults=[("the last vocab split dropped from the merge",
                     split_dropped)] if faults else [],
            require=(("flce_fwd_kernel",) if x_dtype == torch.float32
                     else (FLCE_FWD_BODY,) if d % 8 == 0
                     else ("flce_fwd_mma_kernel",)),
            bytes=nbytes(x, w) + rows * 8, ops=flops, ops_type=ops_type,
            main=main, why=why))
        cases.append(dict(
            name="fused_linear_ce_bwd", label=label, make=make,
            in_bytes=in_bytes, kernel=bwd,
            plain=lambda *args: flce.fused_linear_ce_bwd_plain(*args, **kw),
            library=lambda x, wt, labels, dloss, xr, ll, wr, pl:
                torch.autograd.grad(ll, (xr, wt), dloss, retain_graph=True),
            library_note="autograd backward of F.linear + F.cross_entropy "
                         "(no z-loss)",
            unfused=lambda x, wt, labels, dloss, xr, ll, wr, pl:
                torch.autograd.grad(pl, (xr, wr), dloss, retain_graph=True),
            unfused_note="autograd backward of the port's unfused path (its "
                         "Triton CE backward, two cuBLAS products, the "
                         "weight cast's backward)",
            outputs=2, limits=bwd_lim,
            faults=[("the z-loss term left out of dlogits", no_zloss),
                    ("the dW columns shifted by one", dw_shifted)]
            if faults else [],
            bytes=(nbytes(x, w, lse, dloss, dz) + rows * 4
                   + nbytes(x, w)), ops=3 * flops, ops_type=ops_type,
            main=main, why=why, extra=workspace))

    zkw = dict(lse_square_scale=1e-4)
    shape_cases(TRAIN_B * TRAIN_DEC, 32768, torch.bfloat16, zkw,
                "x (2048, 512) bf16 @ w (512, 32768) f32, z-loss 1e-4",
                main=True, faults=True)
    shape_cases(SCORING_ROWS, 32768, torch.bfloat16, zkw,
                "scoring: x (256, 512) bf16 @ w (512, 32768) f32",
                main=False, faults=True)
    shape_cases(300, 32128, torch.float32,
                dict(lse_square_scale=1e-4, label_smoothing=0.1,
                     logit_scale=2.0),
                "ragged: x (300, 512) f32 @ w (512, 32128) f32, smoothing "
                "0.1, logit_scale 2, a quarter of the rows ignored",
                main=False, faults=True)
    # the FAT5-base scoring's width (d 768, the flan vocabulary) and the
    # FAT5-XL width (d 2048) at the train step's rows: chunks of d
    shape_cases(SCORING_ROWS, 32128, torch.bfloat16, zkw,
                "FAT5-base scoring: x (256, 768) bf16 @ w (768, 32128) f32",
                main=False, faults=True, d=768)
    shape_cases(TRAIN_B * TRAIN_DEC, 32128, torch.bfloat16, zkw,
                "FAT5-XL width: x (2048, 2048) bf16 @ w (2048, 32128) f32, "
                "z-loss 1e-4", main=False, faults=True, d=2048)
    # a d that TMA cannot describe (rows of 200 bytes): the bf16 forward's
    # mma.sync form
    shape_cases(SCORING_ROWS, 32128, torch.bfloat16, zkw,
                "d % 8 != 0: x (256, 100) bf16 @ w (100, 32128) f32, "
                "z-loss 1e-4", main=False, faults=True, d=100)
    return run_checks(cases)


# ---------------------------------------------------------------------------
# training: a tiny model's step on the card against the CPU
# ---------------------------------------------------------------------------

SMALL_GRAD_TOL = 1e-4


def _bucket_one_above(attn_bwd):
    """`attn_bwd` given, for every offset, the bucket one above: a planted
    fault in the attention backward's bucket array."""
    from flasht5_tpu_torch.ops import flash_attention_rpe as fa
    real_table_args = fa._table_args

    def shifted_table_args(*args):
        table, bucket, nb = real_table_args(*args)
        if bucket is None:      # no table (cross-attention): nothing to shift
            return table, bucket, nb
        return table, (bucket + 1).clamp(max=nb - 1), nb

    def fault(*args, **kw):
        with _patched(fa, "_table_args", shifted_table_args):
            return attn_bwd(*args, **kw)
    return fault


def _training_faults():
    """Small faults in what the card's backward kernels are given, each of
    which the card-vs-CPU gradient check must catch: (name, manager)."""
    from flasht5_tpu_torch.ops import cross_entropy as ce
    from flasht5_tpu_torch.ops import flash_attention_rpe as fa
    from flasht5_tpu_torch.ops import rmsnorm as rn

    attn_bwd_bucket_one_above = _bucket_one_above(fa.flash_attention_bwd)
    real_rms_bwd, real_ce_bwd = rn.rms_norm_bwd, ce.cross_entropy_bwd

    def rms_bwd_row_rstd(x, w, rstd, dy, **kw):
        rstd = rstd.clone()
        rstd.view(-1)[-1] = rstd.view(-1)[0]
        return real_rms_bwd(x, w, rstd, dy, **kw)

    def ce_bwd_lse_rolled(logits, labels, lse, dloss, dz, **kw):
        return real_ce_bwd(logits, labels, torch.roll(lse, 1), dloss, dz,
                           **kw)

    # each wrapper counts its launches through its module-level name, which
    # the fault takes over for its duration: give the stand-in a count too
    for fault in (attn_bwd_bucket_one_above, rms_bwd_row_rstd,
                  ce_bwd_lse_rolled):
        fault.launches = 0
    return [
        ("flash_attention_bwd reads the bucket one above",
         _patched(fa, "flash_attention_bwd", attn_bwd_bucket_one_above)),
        ("rms_norm_bwd gets the first row's rstd in the last row",
         _patched(rn, "rms_norm_bwd", rms_bwd_row_rstd)),
        ("cross_entropy_bwd gets each row's lse one row down",
         _patched(ce, "cross_entropy_bwd", ce_bwd_lse_rolled)),
    ]


def _fused_ce_faults():
    """A fault in what the fused lm_head+CE backward kernels are given."""
    from flasht5_tpu_torch.ops import fused_linear_ce as flce

    real = flce.fused_linear_ce_bwd

    def lse_rolled(x, w, labels, lse, dloss, dz, **kw):
        return real(x, w, labels, torch.roll(lse, 1), dloss, dz, **kw)
    lse_rolled.launches = 0     # the wrapper counts through this name
    return [("fused_linear_ce_bwd gets each row's lse one row down",
             _patched(flce, "fused_linear_ce_bwd", lse_rolled))]


def _bias_training_faults():
    """Faults in what the bias backward kernels are given: (name,
    manager)."""
    from flasht5_tpu_torch.ops import flash_attention as fa

    def rows_shifted(real):
        def fault(q, k, v, bias, *rest, **kw):
            return real(q, k, v, torch.roll(bias, 1, dims=2), *rest, **kw)
        fault.launches = 0     # the wrapper counts through this name
        return fault
    return [(f"{name} gets the bias rows shifted by one",
             _patched(fa, name, rows_shifted(getattr(fa, name))))
            for name in ("flash_attention_bias_dkv",
                         "flash_attention_bias_dq")]


def check_small_training(dev):
    """One training step's loss and every gradient leaf of a tiny f32 model,
    on the card (the kernels) against the CPU (their plain versions): on the
    train step's path (pallas_rpe, fused norm and CE, z-loss), on it with
    the fused lm_head+CE, and on the pretraining path's (pallas, with
    use_masking over a padded batch).

    Both compute in f32; the kernels sum in other orders and evaluate exp
    by other means, so the gradients agree to a few 1e-6 of each leaf's
    largest entry. SMALL_GRAD_TOL (1e-4 of that entry) leaves room for that
    and sits below the gap of each planted fault, read in the same run: a
    fault within the tolerance fails the check."""
    from flasht5_tpu_torch.config import FlashT5Config

    base = dict(vocab_size=512, d_model=128, d_kv=32, num_heads=4, d_ff=256,
                num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
                attention_scale=1.0, dtype="float32",
                use_fused_layernorm=True, use_fused_crossentropy=True,
                z_loss=1e-4, pad_token_id=0)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(2, 512, (2, 96)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(2, 512, (2, 40)).astype(np.int32))
    labels[:, -5:] = -100
    mask = torch.ones(ids.shape, dtype=torch.bool)
    mask[1, 70:] = False
    _small_training_step(
        dev, "pallas_rpe", FlashT5Config(**base, attention_type="pallas_rpe"),
        dict(input_ids=ids, labels=labels), _training_faults())
    _small_training_step(
        dev, "pallas_rpe, fused lm_head+CE", FlashT5Config(
            **base, attention_type="pallas_rpe", use_fused_lm_head_ce=True),
        dict(input_ids=ids, labels=labels), _fused_ce_faults())
    _small_training_step(
        dev, "pallas, use_masking", FlashT5Config(
            **base, attention_type="pallas", use_masking=True,
            use_full_bias_size=True),
        dict(input_ids=torch.where(mask, ids, 0), attention_mask=mask,
             labels=labels), _bias_training_faults())


def _small_training_step(dev, tag, cfg, batch, faults):
    from flasht5_tpu_torch.models import t5

    cpu_params = t5.init_params(cfg, seed=5, device="cpu")

    def step(device):
        params = _to(copy.deepcopy(cpu_params), device)   # fresh leaves
        leaves = t5.tree_leaves_with_path(params)
        for _, p in leaves:
            p.requires_grad_(True)
        loss = t5.forward(cfg, params, **{k: v.to(device)
                                          for k, v in batch.items()})["loss"]
        loss.backward()
        return float(loss.detach()), [(path, p.grad.cpu())
                                      for path, p in leaves]

    want_loss, want = step("cpu")

    def gap(grads):
        worst, where = 0.0, None
        for (path, g), (_, w) in zip(grads, want):
            rel = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
            if rel > worst:
                worst, where = rel, path
        return worst, where

    got_loss, got = step(dev)
    worst, where = gap(got)
    print(f"small-training ({tag}): loss card {got_loss} cpu {want_loss}; "
          f"gradients card vs cpu: largest gap {worst} of the leaf's "
          f"largest entry, at {where} (tol {SMALL_GRAD_TOL})", flush=True)
    if not (abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
            and worst <= SMALL_GRAD_TOL):
        raise AssertionError(f"tiny training step ({tag}): card and cpu "
                             f"differ")
    for name, fault in faults:
        with fault:
            fault_gap, fault_where = gap(step(dev)[1])
        print(f"small-training ({tag}): planted fault, {name}: gradients "
              f"card vs cpu largest gap {fault_gap} at {fault_where} (tol "
              f"{SMALL_GRAD_TOL})", flush=True)
        if not fault_gap > SMALL_GRAD_TOL:
            raise AssertionError(f"planted fault ({name}) moves the "
                                 f"gradients by {fault_gap}, within the "
                                 f"tolerance")


# ---------------------------------------------------------------------------
# training: the full-width FAT5-small train step through Trainer.train
# ---------------------------------------------------------------------------

# profiles that recorded no device event at all, each retaken (see
# _kernels_by_name)
EMPTY_PROFILES = []
# profiles retaken because their launches differed from the wrappers'
SHORT_PROFILES = []


def _kernels_by_name(fn, setup=None, tries: int = 3, expect=None):
    """{kernel name: (device ms, launches)} of one profiled call of fn
    (`setup()` runs first, outside the profile).

    A profile that holds no device event at all says nothing of which
    kernels fn ran (fn always launches some): the profiler lost the
    session's activity records, as it did about once in twenty smoke
    runs under torch 2.11. Such a profile is retaken, up to `tries` in
    all, each printed with the launches the port's wrappers counted
    meanwhile. A profile that holds kernels is never retaken for that, so
    a dispatch to the wrong form always fails its gate.

    `expect` ({wrapper: bodies}) holds the profile to the wrappers'
    counts: each body's launches in the profile must equal the launches
    its wrapper counted during the profiled call (each of these wrappers
    launches each of its bodies once a call). A profile that holds fewer
    or more lost or mixed up records, so its times are not the call's:
    it is printed as "profile-short" and retaken, within the same
    `tries`, and the smoke fails if none holds them all. Such a profile
    first traces one more call of fn (after `setup()`) as the profiler's
    warm-up, whose records it drops: a fine-tune step's profile taken
    without it missed the step's first kernels, three times of three
    (1 of 12 attention forwards, 2 of 25 `rms_norm` forwards)."""
    from torch.profiler import ProfilerActivity, schedule

    from flasht5_tpu_torch import ops
    for attempt in range(tries):
        if setup is not None:
            setup()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1)
                if expect else None) as prof:
            if expect:
                fn()
                torch.cuda.synchronize()
                if setup is not None:
                    setup()
                prof.step()
            counted = ops.launch_counts()
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            # kernels only: a record_function range (the optimizer's
            # step) also shows on the device's timeline, spanning its
            # kernels
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3,
                                   n + 1)
        launched = {name: n - counted[name]
                    for name, n in ops.launch_counts().items()
                    if n != counted[name]}
        if not by_name:
            EMPTY_PROFILES.append(dict(attempt=attempt, launched=launched))
            print("profile-empty " + json.dumps(EMPTY_PROFILES[-1]),
                  flush=True)
            continue
        short = {f"{wrapper}: {body}": dict(
            counted=launched.get(wrapper, 0),
            profiled=sum(n for name, (_, n) in by_name.items()
                         if body in name))
            for wrapper, bodies in (expect or {}).items() for body in bodies}
        short = {k: v for k, v in short.items()
                 if v["counted"] != v["profiled"]}
        if not short:
            return by_name
        SHORT_PROFILES.append(dict(attempt=attempt, differ=short))
        print("profile-short " + json.dumps(SHORT_PROFILES[-1]), flush=True)
    if expect and by_name:
        raise AssertionError(f"no profile of {tries} held the launches the "
                             f"wrappers counted: {SHORT_PROFILES[-1]}")
    return by_name


# the bf16 attention bodies on TMA + wgmma (csrc/wgmma_attention.cuh), each
# built on a bias source (its second template argument): every bf16
# training step runs the three on its self-attention's source (the T5
# step the table, RoPE's none) and on none for the cross-attention; every
# prefill of the T5 encoding runs the forward on the table. On the bias
# tensor (ALiBi's, FIRE's and the pretraining driver's self-attention) the
# backward's two run on wgmma and the forward on mma.sync (csrc/
# attention.cuh's fwd_mma_kernel): TENSOR_BODIES.
NO_BIAS, TABLE, TENSOR = 0, 1, 2
WGMMA_NAMES = ("fwd_wgmma_kernel", "dkdv_wgmma_kernel", "dq_wgmma_kernel")
WGMMA_FWD_BODY = "fwd_wgmma_kernel<64, 1>"
TENSOR_BODIES = ("fwd_mma_kernel", f"dkdv_wgmma_kernel<64, {TENSOR}>",
                 f"dq_wgmma_kernel<64, {TENSOR}>")


def wgmma_bodies(*sources, d=64):
    """The three bodies' names at head dim d on each bias source."""
    return tuple(f"{name}<{d}, {src}>" for src in sources
                 for name in WGMMA_NAMES)
# quant_matmul's decode form, which every decode step runs, and the fused
# lm_head+CE forward on TMA + wgmma, which the fused train step and the
# scoring evals run
QMM_DECODE_BODY = "qmm_decode_kernel"
FLCE_FWD_BODY = "flce_fwd_wgmma_kernel"
# the single-query attention kernels split over warps and a cluster
# (csrc/single_query.cuh): decode_attention's, which every decode step
# runs, and the paged one, which every paged window runs
DECODE_ATTN_BODY = "decode_attn_kernel"
PAGED_ATTN_BODY = "paged_attn_kernel"
# the rms_norm kernels' one-warp-a-row forms (csrc/rmsnorm.cu), which every
# path at d_model 512 runs: the forward in each decode window and step, the
# backward in each train and pretrain step
RMS_FWD_BODY = "rms_fwd_warp_kernel"
RMS_BWD_BODY = "rms_bwd_warp_kernel"
# the cross-entropy's Triton kernels (ops/cross_entropy.py), the unsplit
# and the vocab-split form alike
CE_FWD_BODY = "ce_fwd_kernel"
CE_BWD_BODY = "ce_bwd_kernel"
CE_COMBINE_BODY = "ce_combine_kernel"


def _require_kernels(by_name, bodies, what):
    """Raise unless a profiled kernel's name holds each of `bodies`, and
    print those kernels with their device ms and launches."""
    found = {b: [(name, t, n) for name, (t, n) in by_name.items()
                 if b in name] for b in bodies}
    missing = [b for b, ks in found.items() if not ks]
    if missing:
        raise AssertionError(f"{what} ran no {missing}; the profile holds "
                             f"{[name[:70] for name in by_name][:12]}")
    print(f"{what} runs " + json.dumps(
        {b: [{"name": name[:100], "ms": t, "launches": n}
             for name, t, n in ks] for b, ks in found.items()}), flush=True)


def run_training(dev):
    """The training path: `Trainer(flagship_config(), ...).train(batches)`
    on one random batch of 8 x (1024 + 256) tokens repeated, AdamWScale at
    lr 1e-3 with no weight decay (bench.py:45-58), beside the same trainer
    with `use_fused_lm_head_ce` (the A/B of `__graft_entry__.py:37-49`).
    Three warm-up steps each, then three timed loops of 10 steps each, the
    two in turns; every kernel of each path must launch in each of its
    loops, the fused loops must launch no unfused CE kernel, and the loss
    on the repeated batch must fall on both."""
    from flasht5_tpu_torch import flagship_config, ops
    from flasht5_tpu_torch.train import Trainer, TrainerConfig

    cfg = flagship_config()
    tcfg = TrainerConfig(learning_rate=1e-3, weight_decay=0.0,
                         lr_scheduler="constant", max_steps=10 ** 6,
                         logging_steps=1, seed=0)
    t0 = time.perf_counter()
    trainers = {"unfused": Trainer(cfg, tcfg, device=dev),
                "fused": Trainer(cfg.replace(use_fused_lm_head_ce=True),
                                 tcfg, device=dev)}
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (
                 TRAIN_B, TRAIN_ENC)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (
                 TRAIN_B, TRAIN_DEC)).astype(np.int32)}
    tokens_per_step = TRAIN_B * (TRAIN_ENC + TRAIN_DEC)     # bench.py:108
    losses = {way: [e["loss"] for e in tr.train([batch] * 3)["logs"]]
              for way, tr in trainers.items()}
    torch.cuda.synchronize()
    print(f"training: FAT5-small {cfg.num_layers}+{cfg.num_decoder_layers} "
          f"layers, batch {TRAIN_B} x ({TRAIN_ENC} + {TRAIN_DEC}), "
          f"{cfg.dtype} activations, fp32 params; unfused and fused "
          f"lm_head+CE trainers, init and 3 warm-up steps each "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    paths = {"unfused": TRAINING, "fused": FUSED_TRAINING}
    loops = {way: [] for way in trainers}
    torch.cuda.reset_peak_memory_stats()
    for attempt in range(3):
        for way, trainer in trainers.items():
            prefix = "training" if way == "unfused" else "fused training"
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            logs = trainer.train([batch] * 10)["logs"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = ops.launch_counts()
            loop_losses = [e["loss"] for e in logs]
            losses[way] += loop_losses
            print(f"{prefix} loop {attempt + 1} of 3: 10 steps, "
                  f"{10 * tokens_per_step} tokens in {wall:.6f} s = "
                  f"{10 * tokens_per_step / wall:.3f} tokens/s; losses "
                  f"{json.dumps(loop_losses)}; launches per step "
                  f"{json.dumps({k: n / 10 for k, n in launches.items()})}",
                  flush=True)
            missing = [name for name in paths[way] if launches[name] <= 0]
            if missing:
                raise AssertionError(f"kernels not launched in {prefix}: "
                                     f"{missing}")
            if way == "fused" and (launches["cross_entropy_fwd"]
                                   or launches["cross_entropy_bwd"]):
                raise AssertionError("fused training launched the unfused "
                                     "CE kernels")
            clocks = sh("nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                        "temperature.gpu", "--format=csv,noheader")
            print(f"{prefix} loop {attempt + 1}: card after it (SM clock, "
                  f"power, temperature): {clocks}", flush=True)
            loops[way].append(dict(seconds=wall, launches=launches,
                                   tokens_per_s=10 * tokens_per_step / wall,
                                   card_after=clocks))
    peak = torch.cuda.max_memory_allocated()
    for way, ls in losses.items():
        if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
            raise AssertionError(f"{way} training losses {ls}")
    median = {way: sorted(rs, key=lambda r: r["tokens_per_s"])[1]
              for way, rs in loops.items()}

    db = trainers["unfused"]._device_batch(batch)
    steps = {}
    for way, trainer in trainers.items():
        step = dict(wall_ms=median[way]["seconds"] / 10 * 1e3)
        # the kernels of one step by name and device time; the step's
        # device time is their sum (a step queued behind a sleep overstated
        # it where the host could not queue the step within the sleep)
        bodies = (wgmma_bodies(TABLE, NO_BIAS) + (RMS_FWD_BODY, RMS_BWD_BODY)
                  + (("flce_gemm_kernel", FLCE_FWD_BODY) if way == "fused"
                     else ()))
        by_name = _kernels_by_name(lambda: trainer._step(db))
        step["kernels_per_step"] = sum(n for _, n in by_name.values())
        step["device_ms"] = sum(t for t, _ in by_name.values())
        step["device_idle_share"] = 1.0 - step["device_ms"] / step["wall_ms"]
        # the peak memory of one step (the fused lm_head+CE keeps the
        # (2048, 32768) logits out of it)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer._step(db)
        torch.cuda.synchronize()
        step["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        _require_kernels(by_name, bodies, f"one {way} train step")
        if way == "unfused":       # the optimizer's launches alone
            opt_kernels = _kernels_by_name(trainer.optimizer.step)
            step["optimizer_launches"] = sum(
                n for _, n in opt_kernels.values())
            step["optimizer_kernel_ms"] = sum(
                t for t, _ in opt_kernels.values())
        prefix = "train step" if way == "unfused" else "fused train step"
        print(f"{prefix}: {json.dumps(step)} (wall: median loop / 10; "
              f"device: the sum of one profiled step's kernel times)",
              flush=True)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
        print(f"profile of one {prefix}: " + json.dumps(
            [{"name": name[:80], "ms": t, "launches": n}
             for name, (t, n) in top]), flush=True)
        steps[way] = step
    tps = {way: [r["tokens_per_s"] for r in rs] for way, rs in loops.items()}
    fused_tps, unfused_tps = (median[way]["tokens_per_s"]
                       for way in ("fused", "unfused"))
    print(f"fused / unfused train step: tokens/s medians {fused_tps} / "
          f"{unfused_tps} = {fused_tps / unfused_tps}; device ms "
          f"{steps['fused']['device_ms']} / {steps['unfused']['device_ms']}",
          flush=True)
    result = dict(
        tokens_per_s_median=median["unfused"]["tokens_per_s"],
        tokens_per_s=tps["unfused"], tokens_per_step=tokens_per_step,
        losses=losses["unfused"], peak_memory_bytes=peak,
        step=steps["unfused"],
        launches_per_step={k: n / 10 for k, n in
                           median["unfused"]["launches"].items()},
        fused=dict(tokens_per_s_median=median["fused"]["tokens_per_s"],
                   tokens_per_s=tps["fused"], losses=losses["fused"],
                   step=steps["fused"],
                   launches_per_step={k: n / 10 for k, n in
                                      median["fused"]["launches"].items()}))
    return median["unfused"]["launches"], median["fused"]["launches"], result


# ---------------------------------------------------------------------------
# training across ranks: parallel/ on torch.distributed, one rank a card
# ---------------------------------------------------------------------------

PAR_STEPS = 3              # counted steps of each step function
PAR_TRAINER_STEPS = 5      # Trainer(tensor_parallel=n).train
PAR_MICROBATCHES = 4       # the pipeline step's
PAR_TIMEOUT_S = 300        # the children's join, then they are killed
# the tiny f32 models' card-vs-CPU gradients: of each leaf's largest entry
# (or of a hundredth of the tree's, for a leaf that small), as
# check_small_training's f32 steps agree to a few 1e-6
PAR_SMALL_TOL = 1e-5
# the full-width witness: the tensor-parallel step and the one-card step
# both in f32, each gradient leaf of its largest entry (or of a hundredth
# of the tree's); sums in other orders over 24 blocks, far under the bf16
# gaps (a few 1e-2) that the bf16 gate below admits
PAR_F32_TOL = 1e-3
BF16_EPS = 2.0 ** -8       # half a bf16 ulp, relative


def _par_tcfg(**kw):
    from flasht5_tpu_torch.train import TrainerConfig
    return TrainerConfig(learning_rate=1e-3, weight_decay=0.0,
                         lr_scheduler="constant", max_steps=10 ** 6,
                         logging_steps=1, seed=0, **kw)


def _par_batch(cfg, b=8, enc=1024, dec=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, cfg.vocab_size, (b, enc)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, dec)).astype(
                np.int32)}


def _par_small_config():
    from flasht5_tpu_torch.config import FlashT5Config
    return FlashT5Config(vocab_size=512, d_model=128, d_kv=32, num_heads=4,
                         d_ff=256, num_layers=4, num_decoder_layers=4,
                         dropout_rate=0.0, attention_scale=1.0,
                         dtype="float32", attention_type="pallas_rpe",
                         use_fused_layernorm=True,
                         use_fused_crossentropy=True, z_loss=1e-4,
                         label_smoothing=0.1, pad_token_id=0)


def _grads_by_path(params) -> dict:
    """{path: gradient} of a tree's leaves (zeros where none)."""
    from flasht5_tpu_torch.models import t5
    return {path: (p.grad if p.grad is not None else torch.zeros_like(p))
            for path, p in t5.tree_leaves_with_path(params)}


def _par_references(dev, cfg, batch):
    """What the steps across ranks are held to, made before the process
    group exists (the one-card trainer's path): the one-card
    `Trainer._step` on the batch (its loss and every gradient), the same
    step in f32 (what the bf16 step rounds), the bf16 step with the batch
    cut into the pipeline's micro-batches of 8 / PAR_MICROBATCHES rows and
    their gradients summed by hand (the rounding that the reordering alone
    brings), and a tiny f32 model's loss and gradients on the CPU."""
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.train import Trainer
    ref = {}
    for key, c in (("", cfg), ("f32_", cfg.replace(dtype="float32"))):
        tr = Trainer(c, _par_tcfg(), device=dev)
        out = tr._step(tr._device_batch(batch))
        ref[key + "loss"] = float(out["loss"])
        ref[key + "grads"] = {path: p.grad.detach().clone()
                              for path, p in zip(tr._paths, tr._leaves)}
        del tr, out
    params = t5.init_params(cfg, seed=0, device=dev)
    for _, p in t5.tree_leaves_with_path(params):
        p.requires_grad_(True)
    db = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    mb = len(batch["input_ids"]) // PAR_MICROBATCHES
    loss = 0.0
    for i in range(PAR_MICROBATCHES):
        rows = slice(i * mb, (i + 1) * mb)
        part = t5.forward(cfg, params, input_ids=db["input_ids"][rows],
                          labels=db["labels"][rows])["loss"] / \
            PAR_MICROBATCHES
        part.backward()
        loss += float(part.detach())
    ref["acc_loss"] = loss
    ref["acc_grads"] = _grads_by_path(params)
    del params
    small = _par_small_config()
    sbatch = _par_batch(small, enc=96, dec=40, seed=3)
    sp = t5.init_params(small, seed=5, device="cpu")
    for _, p in t5.tree_leaves_with_path(sp):
        p.requires_grad_(True)
    sl = t5.forward(small, sp, **{k: torch.from_numpy(v)
                                  for k, v in sbatch.items()})["loss"]
    sl.backward()
    ref["small"] = {"loss": float(sl.detach()), "grads": _grads_by_path(sp)}
    torch.cuda.empty_cache()
    return ref


def _par_split_check(dev):
    """The split backward (`vocab_parallel.split_backward`) at the train
    step's logits (2048, 32768) bf16 as four tensor ranks run it (a shard
    of 8192 each, its `class_start_idx`, `total_classes` 32768, the global
    lse), against the plain unsplit gradient, dloss 1 a row, z-loss 1e-4,
    label smoothing 0 and 0.1: within one bf16 ulp of each entry plus one
    f32 ulp of the largest (the vocab-split kernel rows' limit: the same
    f32 math rounded to bf16 once on each side); the planted fault, each
    shard fed its own lse, beyond it. Returns each run's worst share of
    the limit."""
    from flasht5_tpu_torch.ops import cross_entropy
    from flasht5_tpu_torch.parallel.vocab_parallel import split_backward
    gen = torch.Generator(device=dev).manual_seed(11)
    rows, v, shards = 2048, 32768, 4
    logits = (3 * torch.randn((rows, v), generator=gen, device=dev)).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (rows,), generator=gen, device=dev)
    dloss = torch.ones((rows,), device=dev)
    lse = torch.logsumexp(logits.float(), dim=-1)
    shares = {}
    for smoothing in (0.0, 0.1):
        want = cross_entropy.cross_entropy_bwd_plain(
            logits, labels, lse, dloss, torch.zeros_like(lse),
            lse_square_scale=1e-4, label_smoothing=smoothing).float()
        limit = BF16_ULP * want.abs() + 2.0 ** -24 * want.abs().max()
        for name, fault in (("global lse", False),
                            ("fault: shard's lse", True)):
            parts = []
            for start in range(0, v, v // shards):
                shard = logits[:, start:start + v // shards].contiguous()
                parts.append(split_backward(
                    shard, labels,
                    torch.logsumexp(shard.float(), dim=-1) if fault else lse,
                    dloss, lse_square_scale=1e-4, label_smoothing=smoothing,
                    total_classes=v, class_start_idx=start))
            got = torch.cat(parts, dim=1).float()
            shares[f"{name}, smoothing {smoothing}"] = float(
                ((got - want).abs() / limit).max())
            del parts, got
        del want, limit
    print("parallel split backward, 4 shards of the train step's logits: "
          "worst share of the limit " + json.dumps(shares), flush=True)
    for smoothing in (0.0, 0.1):
        if not (shares[f"global lse, smoothing {smoothing}"] <= 1.0
                < shares[f"fault: shard's lse, smoothing {smoothing}"]):
            raise AssertionError(f"split backward: {shares}")
    return shares


def _par_state(kind, cfg, mesh, dev, params=None):
    """(local parameters, optimizer, step function) of a step kind."""
    from flasht5_tpu_torch.parallel import pp_step, tp_step, train_step
    if kind == "pp":
        local, opt = pp_step.pp_train_state(cfg, mesh, seed=0, params=params,
                                            device=dev)
        return local, opt, pp_step.make_pp_train_step(
            cfg, mesh, opt, n_microbatches=PAR_MICROBATCHES)
    local, opt = tp_step.tp_train_state(cfg, mesh, seed=0, params=params,
                                        device=dev)
    make = (tp_step.make_tp_train_step if kind == "tp"
            else train_step.make_train_step)
    return local, opt, make(cfg, mesh, opt)


def _par_gather_grads(kind, local, mesh) -> dict:
    """{path: the whole tree's gradient} on every rank (a collective)."""
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.parallel import pp_step
    from flasht5_tpu_torch.parallel.sharding import gather_tree, param_pspecs
    from flasht5_tpu_torch.quantize import _map_with_path
    grads = _grads_by_path(local)
    tree = _map_with_path(lambda path, _: grads[path], local)
    if kind == "pp":
        full = pp_step.from_pp_params(gather_tree(
            tree, pp_step.pp_param_pspecs(tree), mesh, "pipe"))
    else:
        full = gather_tree(tree, param_pspecs(tree), mesh)
    return dict(t5.tree_leaves_with_path(full))


def _grad_gaps(got: dict, want: dict, floor_share: float = 0.0) -> dict:
    """{path: max|got - want| / (the leaf's largest |want|, at least
    floor_share of the tree's)}."""
    top = max(float(w.abs().max()) for w in want.values())
    return {path: float((got[path].float() - w.float()).abs().max())
            / max(float(w.abs().max()), floor_share * top, 1e-30)
            for path, w in want.items()}


def _par_layouts(n):
    """[(kind, mesh shape)] of the step functions at n cards."""
    layouts = [("tp", (1, n)), ("dp", (n, 1)), ("pp", (n, 1))]
    if n == 4:
        layouts += [("tp", (2, 2)), ("pp", (2, 2))]
    return layouts


def _par_mesh(kind, shape):
    from flasht5_tpu_torch.parallel.mesh import make_mesh, make_pp_mesh
    return make_pp_mesh(*shape) if kind == "pp" else make_mesh(*shape)


def _par_planted_fault(cfg, mesh, dev, rows, ref, limits, rank):
    """Step 1 of the tensor-parallel step with the split backward fed each
    rank's own lse (where t > 1 the shards' lse differ from the global
    one): some leaf must land beyond its limit."""
    from flasht5_tpu_torch.parallel import vocab_parallel
    real = vocab_parallel.split_backward

    def own_lse(logits, labels, lse, dloss, **kw):
        return real(logits, labels, torch.logsumexp(logits.float(), -1),
                    dloss, **kw)

    local, _, step = _par_state("tp", cfg, mesh, dev)
    with _patched(vocab_parallel, "split_backward", own_lse):
        step(local, rows)
    grads = _par_gather_grads("tp", local, mesh)
    row = None
    if rank == 0:
        gaps = _grad_gaps(grads, ref["grads"])
        worst = max(gaps, key=lambda p: gaps[p] / limits[p])
        row = dict(worst_share_of_limit=gaps[worst] / limits[worst],
                   worst_leaf=worst,
                   leaves_over=sum(g > limits[p] for p, g in gaps.items()))
        print("parallel planted fault (the split backward on each rank's "
              "own lse): " + json.dumps(row), flush=True)
        if not row["leaves_over"]:
            raise AssertionError("the planted fault stays within the limits")
    del local, step
    torch.cuda.empty_cache()
    return row


def _par_f32_witness(cfg, mesh, dev, rows, ref, rank, tag):
    """Step 1 of the tensor-parallel step in f32 against the one-card step
    in f32 on the same parameters and batch: the loss within PAR_F32_TOL
    relative, every gradient leaf within PAR_F32_TOL of its largest entry
    (or of a hundredth of the tree's). What bf16 leaves of the gap to the
    one-card step is then rounding, not the layout's math."""
    cfg32 = cfg.replace(dtype="float32")
    local, _, step = _par_state("tp", cfg32, mesh, dev)
    loss = float(step(local, rows)["loss"])
    grads = _par_gather_grads("tp", local, mesh)
    row = None
    if rank == 0:
        gaps = _grad_gaps(grads, ref["f32_grads"], 1e-2)
        worst = max(gaps, key=gaps.get)
        row = dict(loss=loss, ref_loss=ref["f32_loss"],
                   loss_gap=abs(loss - ref["f32_loss"]) / abs(
                       ref["f32_loss"]),
                   worst_grad_gap=gaps[worst], worst_leaf=worst,
                   median_grad_gap=float(np.median(list(gaps.values()))),
                   tol=PAR_F32_TOL)
        print(f"parallel {tag} f32 witness vs the one-card f32 step: "
              + json.dumps(row), flush=True)
        if not (row["loss_gap"] <= PAR_F32_TOL
                and gaps[worst] <= PAR_F32_TOL):
            raise AssertionError(f"{tag}: the f32 step parts from the "
                                 f"one-card f32 step")
    del local, step, grads
    torch.cuda.empty_cache()
    return row


def _par_sharded_step(cfg, mesh, dev, batch, ref, limits, rank, tag):
    """`train_step.sharded_train_step` on the mesh (its parameters drawn
    from seed 0, as the one-card reference's): its loss against the
    one-card step's, within the steps' loss limit."""
    from flasht5_tpu_torch.parallel.train_step import sharded_train_step
    loss = float(sharded_train_step(cfg, mesh, batch["input_ids"],
                                    batch["labels"], device=dev, seed=0))
    row = None
    if rank == 0:
        row = dict(mesh=tag, loss=loss, ref_loss=ref["loss"],
                   loss_gap=abs(loss - ref["loss"]),
                   loss_limit=limits["loss"])
        print("parallel sharded_train_step: " + json.dumps(row), flush=True)
        if not (np.isfinite(loss) and row["loss_gap"] <= row["loss_limit"]):
            raise AssertionError(f"sharded_train_step on {tag}: {row}")
    torch.cuda.empty_cache()
    return row


def _sum_over_ranks(counts: dict, dev) -> dict:
    """{kernel: launches} summed over every rank (a collective)."""
    import torch.distributed as dist
    names = sorted(counts)
    t = torch.tensor([counts[k] for k in names], dtype=torch.int64,
                     device=dev)
    dist.all_reduce(t)
    return dict(zip(names, t.tolist()))


def parallel_rank(rank: int, world: int, work: str) -> int:
    """One rank of `run_parallel` (`chip_smoke.py --parallel-rank R N
    DIR`): the kernels the parent built, NCCL over the cards."""
    import torch.distributed as dist

    from flasht5_tpu_torch import flagship_config, ops, runtime
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.parallel.distributed import initialize_multihost
    from flasht5_tpu_torch.parallel.sharding import batch_slice
    from flasht5_tpu_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in runtime.kernel_sources()
               if not runtime._lib_path(n).exists()]
    if missing:
        raise RuntimeError(f"the parent built no {missing}")
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    cfg = flagship_config()
    batch = _par_batch(cfg)
    t0 = time.perf_counter()
    ref = _par_references(dev, cfg, batch) if rank == 0 else None
    ref_s = time.perf_counter() - t0
    info = initialize_multihost(device="cuda")
    assert dist.get_backend() == "nccl", dist.get_backend()
    out = {"world": info, "references_s": ref_s, "small": {}, "steps": {}}
    if rank == 0:
        out["split_backward"] = _par_split_check(dev)

    def rows_of(mesh, b):
        s = batch_slice(mesh, len(b["input_ids"]))
        return {k: torch.from_numpy(v[s]).to(dev) for k, v in b.items()}

    # ---- tiny f32 models: the card's steps against the CPU's one rank ----
    small = _par_small_config()
    sbatch = _par_batch(small, enc=96, dec=40, seed=3)
    sparams = t5.init_params(small, seed=5, device="cpu")
    for kind, shape in _par_layouts(world):
        mesh = _par_mesh(kind, shape)
        local, _, step = _par_state(kind, small, mesh, dev, params=sparams)
        loss = float(step(local, rows_of(mesh, sbatch))["loss"])
        grads = _par_gather_grads(kind, local, mesh)
        if rank == 0:
            gaps = _grad_gaps({k: g.cpu() for k, g in grads.items()},
                              ref["small"]["grads"], 1e-2)
            worst = max(gaps, key=gaps.get)
            loss_gap = abs(loss - ref["small"]["loss"]) / abs(
                ref["small"]["loss"])
            row = dict(loss=loss, cpu_loss=ref["small"]["loss"],
                       loss_gap=loss_gap, worst_grad_gap=gaps[worst],
                       worst_leaf=worst, tol=PAR_SMALL_TOL)
            out["small"][f"{kind}{shape}"] = row
            print(f"parallel small {kind} {shape}: " + json.dumps(row),
                  flush=True)
            if not (loss_gap <= PAR_SMALL_TOL
                    and gaps[worst] <= PAR_SMALL_TOL):
                raise AssertionError(f"tiny {kind} step at {shape}: card "
                                     f"and CPU differ")
        del local, step
    del sparams

    # ---- the full-width steps ----
    # Each leaf's limit, of its largest entry: (t + 1) times the leaf's own
    # bf16 noise, plus half a bf16 ulp. The noise is the larger of two
    # gaps of the one-card step, each of that leaf: to the same step in
    # f32 (the rounding of every activation, which a tensor-parallel
    # layout changes at each row-split product) and to the same step
    # summed over PAR_MICROBATCHES micro-batches (the rounding of the
    # sums over rows, which data and pipeline layouts change; it leaves
    # every row's activations as they were). t, the layout's tensor
    # degree: each row-split product's output is t partial sums rounded
    # to bf16 and summed once more where the one-card product rounds
    # once, and the one-card step's own rounding adds one more draw. The
    # f32 witness below holds the tensor-parallel math itself to 1e-3.
    noise = None
    if rank == 0:
        acc_gaps = _grad_gaps(ref["acc_grads"], ref["grads"])
        f32_gaps = _grad_gaps(ref["grads"], ref["f32_grads"])
        noise = {p: max(acc_gaps[p], f32_gaps[p]) for p in ref["grads"]}
        out["limits"] = dict(
            loss=(2.0 * abs(ref["acc_loss"] - ref["loss"])
                  + BF16_EPS * abs(ref["loss"])),
            worst_acc_gap=max(acc_gaps.values()),
            worst_f32_gap=max(f32_gaps.values()),
            median_acc_gap=float(np.median(list(acc_gaps.values()))),
            median_f32_gap=float(np.median(list(f32_gaps.values()))),
            f32_loss_gap=abs(ref["f32_loss"] - ref["loss"]))
        print("parallel limits: " + json.dumps(out["limits"]), flush=True)
        del ref["acc_grads"]
    launches = {}
    for kind, shape in _par_layouts(world):
        tag = f"{kind}{shape}"
        limits = None
        if rank == 0:
            t = shape[1] if kind == "tp" else 1
            limits = {p: (t + 1) * noise[p] + BF16_EPS for p in noise}
        mesh = _par_mesh(kind, shape)
        local, opt, step = _par_state(kind, cfg, mesh, dev)
        rows = rows_of(mesh, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = float(step(local, rows)["loss"])
        grads = _par_gather_grads(kind, local, mesh)
        row = {"loss_step1": first}
        if rank == 0:
            gaps = _grad_gaps(grads, ref["grads"])
            over = {p: (g, limits[p]) for p, g in gaps.items()
                    if g > limits[p]}
            worst = max(gaps, key=lambda p: gaps[p] / limits[p])
            shares = sorted(gaps[p] / limits[p] for p in gaps)
            row.update(ref_loss=ref["loss"],
                       loss_gap=abs(first - ref["loss"]),
                       loss_limit=out["limits"]["loss"],
                       grad_limit=limits[worst],
                       worst_share_of_limit=shares[-1],
                       median_share_of_limit=float(np.median(shares)),
                       worst_leaf=worst, worst_gap=gaps[worst],
                       worst_leaf_noise=noise[worst],
                       worst_gap_over_noise=max(gaps[p] / noise[p]
                                                for p in gaps if noise[p]),
                       leaves_over=len(over))
            print(f"parallel {tag} step 1 vs the one-card step: "
                  + json.dumps(row), flush=True)
            if over or row["loss_gap"] > row["loss_limit"]:
                raise AssertionError(f"{tag}: step 1 beyond its limits: "
                                     f"{list(over.items())[:5]}")
        del grads
        if kind == "tp":
            row["f32_witness"] = _par_f32_witness(cfg, mesh, dev, rows, ref,
                                                  rank, tag)
        if kind == "tp" and "sharded_train_step" not in out:
            out["sharded_train_step"] = _par_sharded_step(
                cfg, mesh, dev, batch, ref, out.get("limits"), rank, tag)
        if kind == "tp" and shape[1] > 1 and "fault" not in out:
            out["fault"] = _par_planted_fault(cfg, mesh, dev, rows, ref,
                                              limits, rank)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = [first] + [float(step(local, rows)["loss"])
                            for _ in range(PAR_STEPS)]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) / PAR_STEPS
        # the path's launches: every rank's (a pipeline's first stages
        # compute no loss, so launch no CE kernel)
        counted = _sum_over_ranks(ops.launch_counts(), dev)
        # each kind's first layout spans every card
        launches.setdefault(f"{kind}_training", counted)
        # the tensor-parallel loss is the split form: forward, combine
        missing = [k for k in TRAINING + (("cross_entropy_combine",)
                                          if kind == "tp" else ())
                   if counted[k] <= 0]
        if missing:
            raise AssertionError(f"{tag}: kernels not launched {missing}")
        expect = None
        if kind == "tp":
            expect = {"flash_attention_rpe": ("fwd_wgmma_kernel",),
                      "flash_attention_bwd": ("dkdv_wgmma_kernel",
                                              "dq_wgmma_kernel"),
                      "rms_norm": (RMS_FWD_BODY,),
                      "rms_norm_bwd": (RMS_BWD_BODY,),
                      "cross_entropy_fwd": (CE_FWD_BODY,),
                      "cross_entropy_combine": (CE_COMBINE_BODY,),
                      "cross_entropy_bwd": (CE_BWD_BODY,)}
        # a profile retaken on one rank would leave the others a step
        # behind in the collectives: one try where there are several
        by_name = _kernels_by_name(lambda: step(local, rows), expect=expect,
                                   tries=3 if world == 1 else 1)
        if kind == "tp" and rank == 0:
            _require_kernels(by_name, wgmma_bodies(TABLE, NO_BIAS)
                             + (RMS_FWD_BODY, RMS_BWD_BODY, CE_FWD_BODY,
                                CE_COMBINE_BODY, CE_BWD_BODY),
                             f"one {tag} train step")
        nccl = {name: v for name, v in by_name.items()
                if "nccl" in name.lower()}
        # NCCL's kernels also wait for the other ranks: their time apart
        row.update(losses=losses, wall_ms=wall * 1e3,
                   device_ms=sum(t for name, (t, _) in by_name.items()
                                 if name not in nccl),
                   nccl_ms=sum(t for t, _ in nccl.values()),
                   kernels=sum(n for _, n in by_name.values()),
                   nccl_kernels=sum(n for _, n in nccl.values()),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   launches_per_step={k: v / PAR_STEPS
                                      for k, v in counted.items() if v})
        out["steps"][tag] = row
        if rank == 0:
            print(f"parallel {tag}: " + json.dumps(
                {k: v for k, v in row.items() if k != "launches_per_step"}),
                flush=True)
        del local, opt, step
        torch.cuda.empty_cache()

    # ---- the trainer across ranks, through train() ----
    # tp_axis set: the tensor-parallel model and the split CE at any
    # count of cards, one included
    tcfg = _par_tcfg(tensor_parallel=world)
    tr = Trainer(cfg.replace(tp_axis="tensor"), tcfg, device=dev)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    logs = tr.train([batch] * PAR_TRAINER_STEPS)["logs"]
    torch.cuda.synchronize()
    losses = [e["loss"] for e in logs]
    out["trainer"] = dict(tensor_parallel=world, losses=losses,
                          wall_ms=(time.perf_counter() - t1)
                          / PAR_TRAINER_STEPS * 1e3,
                          launches=_sum_over_ranks(ops.launch_counts(), dev))
    if rank == 0:
        print(f"parallel Trainer(tensor_parallel={world}): "
              + json.dumps({k: v for k, v in out["trainer"].items()
                            if k != "launches"}), flush=True)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                and abs(losses[0] - ref["loss"]) <= out["limits"]["loss"]):
            raise AssertionError(f"Trainer(tensor_parallel={world}) "
                                 f"losses {losses}")
    out["launches"] = launches
    dist.barrier()
    if rank == 0:
        with open(os.path.join(work, "rank0.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_parallel(dev):
    """Training across ranks (`parallel/`): one child process a card
    (`torch.cuda.device_count()`), NCCL, a TCP rendezvous on localhost;
    the children load the kernels this process built. Each holds, at
    FAT5-small width with the train step's batch (8 x (1024 + 256)):
    `make_tp_train_step` on a (1, n) mesh (the vocab-parallel loss on the
    CE kernels' split form), `make_train_step` on (n, 1) and
    `make_pp_train_step` on (pipe n, data 1) with 4 micro-batches (and at
    4 cards also (2, 2) and (pipe 2, data 2)): step 1's loss and every
    gradient leaf against the one-card `Trainer._step` on the same
    parameters and batch (and, for the tensor-parallel step, its f32 form
    against the one-card f32 step, and `sharded_train_step`'s loss), then
    PAR_STEPS more steps counted from 0, one
    profiled step (the TP step's held to the wrappers' counts: the CE
    split form's bodies, the wgmma attention's and rms_norm's); tiny f32
    models' TP, DP and PP steps against the CPU's one rank; then
    `Trainer(tensor_parallel=n).train` for 5 steps (losses falling).
    The children are joined within PAR_TIMEOUT_S and killed after it."""
    import socket
    import tempfile

    del dev
    n = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="parallel-") as work:
        procs = []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--parallel-rank", str(r), str(n), work], env=env))
        t0 = time.perf_counter()
        try:
            # a rank that fails leaves the others waiting in a collective:
            # the first failure, or the time limit, ends them all
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.perf_counter() - t0 < PAR_TIMEOUT_S):
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise AssertionError(f"parallel ranks exited with {codes} "
                                 f"(killed at {PAR_TIMEOUT_S} s or after "
                                 f"another rank's failure)")
        with open(os.path.join(work, "rank0.json")) as f:
            out = json.load(f)
    out["cards"] = n
    out["wall_s"] = time.perf_counter() - t0
    launches = out.pop("launches")
    print(f"parallel phase: {n} card(s), {out['wall_s']:.3f} s", flush=True)
    return launches, out


SERVE_TIMEOUT_S = 420       # the serving ranks' join, then they are killed
SERVE_MAX_NEW = 32          # the full-width runs' new tokens a request
# the slot engine's probe logits across cards against one card's: bf16
# activations whose row-split sums round in another order, so a few bf16
# ulps of the largest logit (a wrong shard moves them by the logits' size)
SERVE_PROBE_ULPS = 16


def _serve_layouts(n):
    """The serving meshes at n cards: (1, n), (n, 1) and, at four, (2, 2);
    each with the collective matmul off and, where t > 1, on."""
    shapes = list(dict.fromkeys([(1, n), (n, 1)] + ([(2, 2)] if n == 4
                                                    else [])))
    return [(shape, cm) for shape in shapes
            for cm in ((False, True) if shape[1] > 1 else (False,))]


def _serve_small_config():
    from flasht5_tpu_torch.config import FlashT5Config
    return FlashT5Config(vocab_size=512, d_model=128, d_kv=32, num_heads=4,
                         d_ff=256, num_layers=4, num_decoder_layers=4,
                         dropout_rate=0.0, attention_scale=1.0,
                         dtype="float32", attention_type="pallas_rpe",
                         use_fused_layernorm=True)


def _served(done) -> dict:
    return {r.uid: r.result.tolist() for r in done}


def serving_rank(rank: int, world: int, work: str) -> int:
    """One rank of `run_serving_ranks` (`chip_smoke.py --serving-rank R N
    DIR`): the kernels the parent built, NCCL over the cards."""
    import torch.distributed as dist

    from flasht5_tpu_torch import flagship_config, ops, runtime
    from flasht5_tpu_torch.inference import engine, paged_engine
    from flasht5_tpu_torch.inference.sharded_engine import (
        ShardedEngine, make_serving_mesh)
    from flasht5_tpu_torch.inference.sharded_paged_engine import (
        ShardedPagedEngine)
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.parallel.distributed import initialize_multihost
    from flasht5_tpu_torch.parallel.mesh import use_mesh
    from flasht5_tpu_torch.quantize import quantize_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    missing = [n for n in runtime.kernel_sources()
               if not runtime._lib_path(n).exists()]
    if missing:
        raise RuntimeError(f"the parent built no {missing}")
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    info = initialize_multihost(device="cuda")
    assert dist.get_backend() == "nccl", dist.get_backend()
    out = {"world": info, "small": {}, "full": {}}
    layouts = _serve_layouts(world)
    meshes = {shape: make_serving_mesh(*shape)
              for shape in dict.fromkeys(s for s, _ in layouts)}

    # ---- tiny f32 models: both sharded engines against the CPU's ----
    # f32 weights and KV: card and CPU differ in summation order alone.
    # (int8 KV rounds K/V values an f32 ulp apart to int8 steps of 1/127
    # of a row's absmax, which parts tokens at this random model's
    # near-ties: top-two margins down to 8e-4; with int8 KV one of six
    # requests parted at (1, 1).)
    cfg = _serve_small_config()
    cpu_params = t5.init_params(cfg, seed=7, device="cpu")
    gpu_params = _to(cpu_params, dev)
    rng = np.random.default_rng(2)
    ids = [rng.integers(2, 512, size=(n,)).astype(np.int32)
           for n in (12, 30, 7, 25, 16, 9)]
    kinds = {
        "slot": (ShardedEngine, engine.InferenceEngine, engine.EngineConfig(
            max_slots=4, max_decode_len=20, max_encode_len=32,
            encode_buckets=(16, 32), steps_per_sync=4,
            use_decode_kernel=True)),
        "paged": (ShardedPagedEngine, paged_engine.PagedInferenceEngine,
                  paged_engine.PagedEngineConfig(
                      max_slots=4, page_size=8, num_pages=12,
                      max_pages_per_slot=3, max_encode_len=32,
                      encode_buckets=(16, 32), steps_per_sync=3))}

    def small_requests():
        return [engine.Request(uid=i, input_ids=x, max_new_tokens=17)
                for i, x in enumerate(ids)]
    want = ({kind: _served(single(cfg, cpu_params, ecfg, device="cpu").run(
        small_requests())) for kind, (_, single, ecfg) in kinds.items()}
        if rank == 0 else None)
    for (shape, cm), kind in [(lay, kind) for lay in layouts
                              for kind in kinds]:
        sharded, _, ecfg = kinds[kind]
        eng = sharded(cfg.replace(use_collective_matmul=cm), gpu_params,
                      ecfg, meshes[shape], device=dev)
        got = _served(eng.run(small_requests()))
        tag = f"{kind} {shape}{' ring' if cm else ''}"
        if rank == 0:
            same = sum(got[u] == want[kind][u] for u in want[kind])
            out["small"][tag] = same
            print(f"serving-ranks small {tag}: {same} of {len(ids)} "
                  f"requests served the CPU's single-device tokens",
                  flush=True)
            if same != len(ids):
                raise AssertionError(f"tiny sharded {tag}: {got} != "
                                     f"{want[kind]}")
        del eng

    # ---- full width: FAT5-small, int8 weights and KV ----
    cfg = flagship_config()
    params = quantize_params(t5.init_params(cfg, seed=0, device=dev), "int8")
    enc_len, max_new = 512, SERVE_MAX_NEW
    rng = np.random.default_rng(0)
    inputs = [rng.integers(2, cfg.vocab_size, size=(enc_len,)).astype(
        np.int32) for _ in range(16)]

    def requests():
        return [engine.Request(uid=i, input_ids=x, max_new_tokens=max_new)
                for i, x in enumerate(inputs)]
    kinds = {
        "slot": (ShardedEngine, engine.InferenceEngine, engine.EngineConfig(
            max_slots=8, max_decode_len=max_new + 2, max_encode_len=enc_len,
            encode_buckets=(enc_len,), kv_dtype="int8", steps_per_sync=8,
            use_decode_kernel=True), ("decode_attention",),
            (QMM_DECODE_BODY, DECODE_ATTN_BODY, RMS_FWD_BODY)),
        "paged": (ShardedPagedEngine, paged_engine.PagedInferenceEngine,
                  paged_engine.PagedEngineConfig(
                      max_slots=8, page_size=64, num_pages=8,
                      max_pages_per_slot=1, max_encode_len=enc_len,
                      encode_buckets=(enc_len,), kv_dtype="int8",
                      steps_per_sync=16), ("paged_decode_attention",),
                  (QMM_DECODE_BODY, PAGED_ATTN_BODY, RMS_FWD_BODY))}
    launches = {}
    for kind, (sharded, single, ecfg, own, bodies) in kinds.items():
        ref = {}
        if rank == 0:
            eng = single(cfg, params, ecfg, device=dev)
            eng.warmup()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref["tokens"] = _served(eng.run(requests()))
            torch.cuda.synchronize()
            ref["seconds"] = time.perf_counter() - t1
            if kind == "slot":
                for i, r in enumerate(requests()[:ecfg.max_slots]):
                    eng.admit_request(r, i)
                ref["logits"] = eng.probe_step()[1]
                ref["step_host_ms"] = host_us(
                    lambda: eng._step(eng.state.cur_token), (), 20) / 1e3
            del eng
            torch.cuda.empty_cache()
        dist.barrier()
        for shape, cm in layouts:
            tag = f"{kind} {shape}{' ring' if cm else ''}"
            eng = sharded(cfg.replace(use_collective_matmul=cm), params,
                          ecfg, meshes[shape], device=dev)
            eng.warmup()
            real, windows = eng._window, []

            def counted_window(*args):
                windows.append(1)
                return real(*args)
            eng._window = counted_window
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            done = eng.run(requests())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            del eng._window
            counted = _sum_over_ranks(ops.launch_counts(), dev)
            tokens = _check_results(done, cfg, max_new)
            got = _served(done)
            launches.setdefault(f"sharded_{kind}_serving", counted)
            need = ("rms_norm", "flash_attention_rpe", "quant_matmul") + own
            not_run = [k for k in need if counted[k] <= 0]
            if not_run:
                raise AssertionError(f"{tag}: kernels not launched "
                                     f"{not_run}")
            # one window profiled, every slot live (the slot engine's
            # pool filled through admit_request; the paged engine's
            # through a run that stops after its first window)
            with use_mesh(eng.mesh):
                if kind == "slot":
                    def setup():
                        for i, r in enumerate(requests()[:ecfg.max_slots]):
                            eng.admit_request(r, i)
                    by_name = _kernels_by_name(
                        lambda: eng._window()[1].synchronize(), setup=setup,
                        tries=3 if world == 1 else 1)
                else:
                    by_name = _kernels_by_name(
                        lambda: eng._window(
                            np.zeros(ecfg.max_slots, bool),
                            np.ones(ecfg.max_slots, bool)),
                        tries=3 if world == 1 else 1)
            nccl = {n: v for n, v in by_name.items() if "nccl" in n.lower()}
            row = dict(
                tokens=tokens, seconds=wall, tokens_per_s=tokens / wall,
                windows=len(windows), window_wall_ms=wall * 1e3
                / len(windows), steps_per_window=ecfg.steps_per_sync,
                window_device_ms=sum(t for n, (t, _) in by_name.items()
                                     if n not in nccl),
                window_kernels=sum(n for _, n in by_name.values()),
                window_nccl_kernels=sum(n for _, n in nccl.values()),
                window_nccl_ms=sum(t for t, _ in nccl.values()),
                launches={k: v for k, v in counted.items() if v})
            row["idle_share"] = (1.0 - row["window_device_ms"]
                                 / row["window_wall_ms"])
            if kind == "slot":
                # the host's time of one decode step, the launches queued
                # behind a sleep (host_us), beside the one-card engine's
                with use_mesh(eng.mesh):
                    row["step_host_ms"] = host_us(
                        lambda: eng._step(eng.state.cur_token), (), 20) / 1e3
            if rank == 0:
                _require_kernels(by_name, bodies, f"one {tag} window")
                same = sum(got[u] == ref["tokens"][u] for u in got)
                row["same_tokens_as_one_card"] = same
                row["one_card_tokens_per_s"] = tokens / ref["seconds"]
                if kind == "slot":
                    row["one_card_step_host_ms"] = ref["step_host_ms"]
                    for i, r in enumerate(requests()[:ecfg.max_slots]):
                        eng.admit_request(r, i)
                    logits = eng.probe_step()[1]
                    row["probe_max_abs_err"] = float(
                        np.abs(logits - ref["logits"]).max())
                    row["probe_limit"] = SERVE_PROBE_ULPS * _bf16_ulp(
                        float(np.abs(ref["logits"]).max()))
                print(f"serving-ranks {tag}: " + json.dumps(
                    {k: v for k, v in row.items() if k != "launches"}),
                    flush=True)
                # one card: the one-rank collectives are the identity, so
                # every token is the single-device engine's; across cards
                # the row-split sums round in another order (bf16
                # near-ties part tokens; the logits are held instead)
                if world == 1 and same != len(got):
                    raise AssertionError(f"{tag}: {same} of {len(got)} "
                                         f"requests served the one-card "
                                         f"engine's tokens")
                if (row.get("probe_max_abs_err", 0.0)
                        > row.get("probe_limit", 0.0)):
                    raise AssertionError(f"{tag}: probe logits "
                                         f"{row['probe_max_abs_err']} from "
                                         f"the one-card engine's")
            elif kind == "slot":
                for i, r in enumerate(requests()[:ecfg.max_slots]):
                    eng.admit_request(r, i)
                eng.probe_step()
            out["full"][tag] = row
            del eng
            torch.cuda.empty_cache()
    out["launches"] = launches
    dist.barrier()
    if rank == 0:
        with open(os.path.join(work, "rank0.json"), "w") as f:
            json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _spawn_ranks(flag: str, timeout_s: float) -> dict:
    """One child process a card (`chip_smoke.py FLAG R N DIR`), NCCL over a
    TCP rendezvous on localhost; the first failure, or the time limit,
    ends them all. Returns rank 0's JSON."""
    import socket
    import tempfile

    n = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="ranks-") as work:
        procs = []
        for r in range(n):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, str(r),
                 str(n), work], env=env))
        t0 = time.perf_counter()
        try:
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.perf_counter() - t0 < timeout_s):
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise AssertionError(f"{flag} ranks exited with {codes} (killed "
                                 f"at {timeout_s} s or after another "
                                 f"rank's failure)")
        with open(os.path.join(work, "rank0.json")) as f:
            out = json.load(f)
    out["cards"] = n
    out["wall_s"] = time.perf_counter() - t0
    return out


def run_serving_ranks(dev):
    """Serving across ranks (`inference/sharded_engine.py`,
    `sharded_paged_engine.py`): one child process a card, NCCL. Each
    serves, on every layout of `_serve_layouts` (one card: mesh (1,
    1)):
    - tiny f32 models (4 + 4 layers, f32 KV): both sharded engines'
      tokens equal to the CPU's single-device engines', request by request;
    - FAT5-small (int8 weights and KV; 16 requests of 512 random tokens,
      SERVE_MAX_NEW new; the slot engine's 8 slots on the decode kernel,
      the paged engine's 8 pages of 64 a data rank): `ShardedEngine` and
      `ShardedPagedEngine` against `InferenceEngine` and
      `PagedInferenceEngine` on one card, every launch count set to 0
      just before and read just after (each path kernel must launch), one
      profiled window (device ms, NCCL kernels); at one card every token
      must be the single-device engine's; across cards the slot engine's
      `probe_step` logits must lie within SERVE_PROBE_ULPS bf16 ulps of
      the one-card engine's largest logit and the tokens' agreement is
      printed."""
    del dev
    out = _spawn_ranks("--serving-rank", SERVE_TIMEOUT_S)
    launches = out.pop("launches")
    print(f"serving-ranks phase: {out['cards']} card(s), "
          f"{out['wall_s']:.3f} s", flush=True)
    return launches, out


def serving_ranks_only() -> int:
    """`python3 chip_smoke.py --serving-ranks`: the kernels' build, then
    `run_serving_ranks` alone (a call with several cards)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from flasht5_tpu_torch import runtime
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    print(f"cards: {smi}", flush=True)
    runtime.build_kernels()
    launches, out = run_serving_ranks(torch.device("cuda", 0))
    print(json.dumps({"serving_ranks": out, "launches": launches}))
    print(smi.splitlines()[0])
    return 0


def parallel_only() -> int:
    """`python3 chip_smoke.py --parallel`: the kernels' build, then
    `run_parallel` alone (a call with several cards)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from flasht5_tpu_torch import runtime
    smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")
    print(f"cards: {smi}", flush=True)
    runtime.build_kernels()
    launches, out = run_parallel(torch.device("cuda", 0))
    print(json.dumps({"parallel": out, "launches": launches}))
    print(smi.splitlines()[0])
    return 0


# ---------------------------------------------------------------------------
# fine-tuning: the task heads over the encoder trunk
# ---------------------------------------------------------------------------

def _first_eos_pooling():
    """A planted fault of the sequence-classification head: each row
    pools its first EOS instead of its last."""
    from flasht5_tpu_torch.models import heads

    def first_eos(input_ids, eos_token_id):
        eos = input_ids == eos_token_id
        return torch.where(eos.any(dim=1), eos.int().argmax(dim=1),
                           input_ids.shape[1] - 1)
    return _patched(heads, "last_eos_positions", first_eos)


def check_small_finetune(dev):
    """Each task head over a tiny f32 trunk on `pallas_rpe` with the fused
    `rms_norm`, on the card (the kernels) against the CPU (their plain
    versions): token classification, sequence classification in each
    problem type (regression, single- and multi-label) and extractive QA;
    the logits, the loss and every gradient leaf, each gap relative to the
    output's or leaf's largest entry, within SMALL_GRAD_TOL (the tiny
    training step's limit: f32 on both sides, sums in other orders). A
    leaf whose largest entry is under a hundredth of the tree's largest is
    held relative to that hundredth: its entries are rounding noise where
    the gradient is zero in exact arithmetic, as the QA bias's is (the
    softmax over a row's positions is blind to a shift of the row). A
    planted fault, pooling each row's first EOS instead of its last, must
    move the sequence-classification logits beyond it."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.models import heads
    from flasht5_tpu_torch.models.t5 import tree_leaves_with_path

    cfg = FlashT5Config(vocab_size=512, d_model=128, d_kv=32, num_heads=4,
                        d_ff=256, num_layers=2, dropout_rate=0.0,
                        attention_scale=1.0, dtype="float32",
                        attention_type="pallas_rpe", use_fused_layernorm=True,
                        pad_token_id=0)
    rng = np.random.default_rng(7)
    b, n = 4, 96
    ids = rng.integers(2, 512, (b, n)).astype(np.int32)
    ids[0, 30] = ids[0, 80] = 1          # two EOS: the last is pooled
    ids[1, n - 1] = 1
    ids[3, 50] = 1                       # row 2 has none: its last position
    ids = torch.from_numpy(ids)
    tok_labels = torch.from_numpy(rng.integers(0, 9, (b, n)))
    tok_labels[2, 10:20] = -100
    cases = {
        "token classification": (
            lambda: heads.init_token_classification_params(
                cfg, 9, seed=3, device="cpu"),
            lambda p, d: heads.token_classification_forward(
                cfg, p, ids.to(d), labels=tok_labels.to(d)), ("logits",)),
        "question answering": (
            lambda: heads.init_question_answering_params(
                cfg, seed=3, device="cpu"),
            lambda p, d: heads.question_answering_forward(
                cfg, p, ids.to(d),
                start_positions=torch.tensor([3, 90, n + 4, 0], device=d),
                end_positions=torch.tensor([9, n - 1, 40, -2], device=d)),
            ("start_logits", "end_logits")),
    }
    seq_labels = {
        "regression": (1, torch.from_numpy(
            rng.standard_normal((b, 1)).astype(np.float32))),
        "single_label_classification": (3, torch.from_numpy(
            rng.integers(0, 3, (b,)))),
        "multi_label_classification": (3, torch.from_numpy(
            (rng.random((b, 3)) > 0.5).astype(np.float32))),
    }
    for problem, (nl, labels) in seq_labels.items():
        cases[f"sequence classification, {problem}"] = (
            lambda nl=nl: heads.init_sequence_classification_params(
                cfg, nl, seed=3, device="cpu"),
            lambda p, d, nl=nl, labels=labels:
                heads.sequence_classification_forward(
                    cfg, p, ids.to(d), labels=labels.to(d), num_labels=nl),
            ("logits",))

    def run(init, fwd, keys, device, cpu_params):
        params = _to(copy.deepcopy(cpu_params), device)
        leaves = tree_leaves_with_path(params)
        for _, p in leaves:
            p.requires_grad_(True)
        out = fwd(params, device)
        out["loss"].backward()
        return ([out[k].detach().float().cpu() for k in keys + ("loss",)],
                [(path, p.grad.cpu()) for path, p in leaves])

    def gap(a, b, floor=0.0):
        worst, where = 0.0, None
        for (path, g), (_, w) in zip(a, b):
            rel = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   floor, 1e-30)
            if rel > worst:
                worst, where = rel, path
        return worst, where

    results = {}
    for name, (init, fwd, keys) in cases.items():
        cpu_params = init()
        want_out, want = run(init, fwd, keys, "cpu", cpu_params)
        got_out, got = run(init, fwd, keys, dev, cpu_params)
        names = keys + ("loss",)
        out_gap = gap(list(zip(names, got_out)), list(zip(names, want_out)))
        grad_gap = gap(got, want, floor=1e-2 * max(
            float(w.abs().max()) for _, w in want))
        print(f"small-finetune ({name}): outputs card vs cpu largest gap "
              f"{out_gap[0]} at {out_gap[1]}, gradients {grad_gap[0]} at "
              f"{grad_gap[1]} (of the largest entry; tol {SMALL_GRAD_TOL})",
              flush=True)
        if not (out_gap[0] <= SMALL_GRAD_TOL and grad_gap[0] <= SMALL_GRAD_TOL):
            raise AssertionError(f"tiny {name}: card and cpu differ")
        results[name] = dict(output_gap=out_gap[0], gradient_gap=grad_gap[0])
        if name.endswith("single_label_classification"):
            with _first_eos_pooling():
                fault_out, _ = run(init, fwd, keys, dev, cpu_params)
            fault_gap = gap(list(zip(names, fault_out)),
                            list(zip(names, want_out)))
            print(f"small-finetune ({name}): planted fault, the first EOS "
                  f"pooled: outputs largest gap {fault_gap[0]} at "
                  f"{fault_gap[1]} (tol {SMALL_GRAD_TOL})", flush=True)
            if not fault_gap[0] > SMALL_GRAD_TOL:
                raise AssertionError("pooling the first EOS stays within "
                                     "the tolerance")
            results[name]["fault_gap"] = fault_gap[0]
    return results


FT_B, FT_LEN, FT_STEPS = 32, 512, 30


def run_finetune(dev):
    """Fine-tuning at full width: the FAT5-small encoder trunk (12 layers,
    d_model 512, `pallas_rpe`, bf16 activations), written to safetensors by
    the port's exporter and read back by `load_fat5_safetensors`, with a
    2-label sequence-classification head; FT_STEPS steps of
    `finetune_classification.train_step` on the demo's toy task at 32 x 512
    (four fixed batches), with the launch counts set to 0 just before and
    read just after, and `EnergyCallback` at the card's power limit; the
    loss must fall. Then one profiled step (the wgmma attention bodies and
    the `rms_norm` kernels required), the step timed by
    `utils.profiling.timed`, and one step each of token classification and
    QA heads over the same trunk."""
    import tempfile

    from flasht5_tpu_torch import flagship_config, ops
    from flasht5_tpu_torch.convert import (load_fat5_safetensors,
                                           params_to_fat5_state_dict,
                                           safetensors_file)
    from flasht5_tpu_torch.models import heads, t5
    from flasht5_tpu_torch.train import EnergyCallback
    from flasht5_tpu_torch.train import finetune_classification as ft
    from flasht5_tpu_torch.utils import profiling

    cfg = flagship_config()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fat5-small-encoder.safetensors")
        safetensors_file.save_file(params_to_fat5_state_dict(
            t5.init_encoder_params(cfg, seed=0, device=dev)), path)
        size = os.path.getsize(path)
        trunk = load_fat5_safetensors(path, device=dev)
    if set(trunk) != {"shared", "encoder"}:
        raise AssertionError(f"the exported trunk read back as {set(trunk)}")
    params = ft.attach_head(cfg, trunk, 2)
    optimizer = ft.make_optimizer(params, 1e-4)
    pool = [(torch.from_numpy(i).to(dev), torch.from_numpy(y).to(dev))
            for i, y in ft.toy_pool(cfg, rows=FT_B, length=FT_LEN)]
    torch.cuda.synchronize()
    print(f"finetune: FAT5-small encoder {cfg.num_layers} layers, "
          f"{cfg.attention_type}, {cfg.dtype} activations; trunk written "
          f"({size} bytes) and read back, head attached "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def step(i):
        ids, y = pool[i % len(pool)]
        return ft.train_step(cfg, params, optimizer, ids, y, 2)

    for i in range(2):                     # warm-up: Triton and cuBLAS
        step(i)
    torch.cuda.synchronize()
    energy = EnergyCallback(device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    energy.on_train_begin(None)
    t1 = time.perf_counter()
    out = [step(i) for i in range(FT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ops.launch_counts()
    result = {}
    energy.on_train_end(None, result)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(loss) for loss, _ in out]
    accs = [float(acc) for _, acc in out]
    tokens = FT_STEPS * FT_B * FT_LEN
    print(f"finetune loop: {FT_STEPS} steps of {FT_B} x {FT_LEN}, {tokens} "
          f"tokens in {wall:.6f} s = {tokens / wall:.3f} tokens/s; losses "
          f"{json.dumps(losses)}; accuracies {json.dumps(accs)}; launches "
          f"{json.dumps(launches)}; peak memory {peak} bytes; energy at the "
          f"card's power limit ({energy.watts} W) "
          f"{json.dumps(result['energy'])}", flush=True)
    missing = [name for name in FINETUNE if launches[name] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in fine-tuning: "
                             f"{missing}")
    if not (all(np.isfinite(losses))
            and np.mean(losses[-4:]) < np.mean(losses[:4])):
        raise AssertionError(f"fine-tuning losses {losses}")

    fwd, dkdv, dq = wgmma_bodies(TABLE)
    by_name = _kernels_by_name(lambda: step(0), expect={
        "flash_attention_rpe": (fwd,), "flash_attention_bwd": (dkdv, dq),
        "rms_norm": (RMS_FWD_BODY,), "rms_norm_bwd": (RMS_BWD_BODY,)})
    _require_kernels(by_name, wgmma_bodies(TABLE)
                     + (RMS_FWD_BODY, RMS_BWD_BODY), "one fine-tune step")
    timed_s = profiling.timed(step, 0, iters=5, warmup=1)
    one = dict(wall_ms=wall / FT_STEPS * 1e3, timed_ms=timed_s * 1e3,
               device_ms=sum(t for t, _ in by_name.values()),
               kernels_per_step=sum(n for _, n in by_name.values()))
    one["device_idle_share"] = 1.0 - one["device_ms"] / one["wall_ms"]
    print(f"finetune step: {json.dumps(one)} (wall: the loop / "
          f"{FT_STEPS}; timed: utils.profiling.timed, CUDA events over 5 "
          f"steps queued back to back; device: the sum of one profiled "
          f"step's kernel times)", flush=True)

    # one step each of the other heads over the same trunk
    others = {}
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, (
        FT_B, FT_LEN)).astype(np.int32)).to(dev)
    for name, init, fwd in (
            ("token classification",
             lambda: heads.init_token_classification_params(
                 cfg, 9, seed=2, device=dev),
             lambda p: heads.token_classification_forward(
                 cfg, p, ids, labels=torch.randint(
                     0, 9, (FT_B, FT_LEN), device=dev))),
            ("question answering",
             lambda: heads.init_question_answering_params(
                 cfg, seed=2, device=dev),
             lambda p: heads.question_answering_forward(
                 cfg, p, ids,
                 start_positions=torch.randint(0, FT_LEN, (FT_B,), device=dev),
                 end_positions=torch.randint(0, FT_LEN, (FT_B,),
                                             device=dev)))):
        p = init()
        p["shared"], p["encoder"] = trunk["shared"], trunk["encoder"]
        opt = ft.make_optimizer(p, 1e-4)
        ops.reset_launch_counts()
        t2 = time.perf_counter()
        loss = fwd(p)["loss"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        others[name] = dict(loss=float(loss.detach()), wall_ms=(
            time.perf_counter() - t2) * 1e3, launches=ops.launch_counts())
        if not np.isfinite(others[name]["loss"]) or any(
                others[name]["launches"][k] <= 0 for k in FINETUNE):
            raise AssertionError(f"{name} step: {others[name]}")
        print(f"finetune {name}: one step {json.dumps(others[name])}",
              flush=True)
    return launches, dict(
        tokens_per_s=tokens / wall, tokens=tokens, seconds=wall,
        losses=losses, accuracies=accs, peak_memory_bytes=peak, step=one,
        energy=result["energy"], watts=energy.watts, trunk_bytes=size,
        other_heads=others)


# ---------------------------------------------------------------------------
# scoring: bench_quality's counterpart on a FAT5-small checkpoint
# ---------------------------------------------------------------------------

# the card's full-precision perplexity against the CPU's (the plain
# versions), relative: both run bf16 activations through 12 + 12 layers,
# and a value one f32 ulp apart on the two sides may round to another bf16
# value; averaged over 1,024 label tokens that moved the perplexity by
# 6.9e-4 (H100, two runs), and the planted fault (one vocab split of 128
# dropped) moves it by ~0.7%
SCORING_TOL = 2e-3


def flan_base_config():
    """FAT5-flan-base's widths (configs/flan/fat5-flan-base.yaml: d_model
    768, d_kv 64, d_ff 2048, 12 heads, 12 + 12 layers, the flan-t5
    vocabulary of 32128) on FAT5-small's other settings; what the
    checkpoint mode reads back from the file's shapes is the same."""
    from flasht5_tpu_torch import flagship_config
    return flagship_config().replace(d_model=768, num_heads=12,
                                     vocab_size=32128)


def run_scoring(dev, model="FAT5-small"):
    """The scoring path at full width: a FAT5-named safetensors file of
    `init_params(config, seed=0)` (`flagship_config()` for FAT5-small,
    `flan_base_config()` for FAT5-flan-base) written by the port's exporter
    to a temporary directory, then `quality.main([file])` on the card (the
    full-precision perplexity on the fused lm_head+CE forward kernel, the
    four quantized variants on `quant_matmul`), with the launch counts set
    to 0 just before and read just after; the same perplexity on the CPU
    (the plain versions) must agree within SCORING_TOL, and a planted
    fault (the last vocab split dropped from the merge) must not."""
    import tempfile

    from flasht5_tpu_torch import flagship_config, ops, quality
    from flasht5_tpu_torch.convert import (load_fat5_safetensors,
                                           params_to_fat5_state_dict,
                                           safetensors_file)
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.ops import fused_linear_ce as flce

    model_config = {"FAT5-small": flagship_config,
                    "FAT5-flan-base": flan_base_config}[model]()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "checkpoint.safetensors")
        t0 = time.perf_counter()
        params = t5.init_params(model_config, seed=0, device=dev)
        safetensors_file.save_file(params_to_fat5_state_dict(params), path)
        del params
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)

        ops.reset_launch_counts()
        t1 = time.perf_counter()
        lines = quality.main([path])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        missing = [name for name in SCORING if launches[name] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched while scoring: "
                                 f"{missing}")
        # one fused forward a batch, in the full-precision run only (the
        # quantized lm_head takes the unfused path)
        if launches["fused_linear_ce_fwd"] != 4:
            raise AssertionError(f"fused_linear_ce_fwd launched "
                                 f"{launches['fused_linear_ce_fwd']} times, "
                                 f"not once per batch")
        if [ln["metric"] for ln in lines] != [
                f"delta_ppl_{tag}" for tag, *_ in quality.VARIANTS] or \
                not all(np.isfinite([ln["ppl_fp"], ln["ppl_quant"]]).all()
                        for ln in lines):
            raise AssertionError(f"scoring lines {lines}")

        card_params = load_fat5_safetensors(path, device=dev)
        config = quality.checkpoint_config(card_params)
        if (config.d_model, config.num_heads, config.vocab_size) != (
                model_config.d_model, model_config.num_heads,
                model_config.vocab_size):
            raise AssertionError(f"{model}: the checkpoint reads back as "
                                 f"{config}")
        batches = quality.checkpoint_batches(config)
        ppl_card = quality.eval_ppl(config, card_params, batches)
        # the scoring's wall time on the fused and the unfused path, in
        # turns (each ends in a host read of each batch's loss)
        dev_batches = [(torch.from_numpy(i).to(dev), torch.from_numpy(l).to(
            dev)) for i, l in batches]

        def score(cfg):
            with torch.no_grad():
                return [float(t5.forward(cfg, card_params, input_ids=i,
                                         labels=l)["loss"])
                        for i, l in dev_batches]
        ways = {"fused": config.replace(use_fused_lm_head_ce=True),
                "unfused": config.replace(use_fused_lm_head_ce=False)}
        walls = {way: [] for way in ways}
        for _ in range(3):
            for way in ("unfused", "fused", "fused", "unfused"):
                t2 = time.perf_counter()
                score(ways[way])
                walls[way].append((time.perf_counter() - t2) * 1e3)
        # one fused eval's kernels: the forward on TMA + wgmma among them
        eval_kernels = _kernels_by_name(lambda: score(ways["fused"]))
        _require_kernels(eval_kernels, (FLCE_FWD_BODY,),
                         f"one fused scoring eval ({model})")
        real_merge = flce.merge_partials
        with _patched(flce, "merge_partials",
                      lambda part, n: real_merge(part, n - 1)):
            ppl_fault = quality.eval_ppl(config, card_params, batches)
        del card_params
        torch.cuda.empty_cache()

        t3 = time.perf_counter()
        cpu_params = load_fat5_safetensors(path, device="cpu")
        ppl_cpu = quality.eval_ppl(config, cpu_params, batches)
        cpu_s = time.perf_counter() - t3
        del cpu_params
    gap = abs(ppl_card - ppl_cpu) / ppl_cpu
    fault_gap = abs(ppl_fault - ppl_cpu) / ppl_cpu
    print(f"scoring: {model} checkpoint {size} B written in "
          f"{write_s:.3f} s; quality.main on the card {main_s:.3f} s; "
          f"launches {json.dumps({k: launches[k] for k in SCORING})}; "
          f"full-precision ppl card {ppl_card} cpu {ppl_cpu} (cpu "
          f"{cpu_s:.3f} s): relative gap {gap} (tol {SCORING_TOL}); planted "
          f"fault (last vocab split dropped): ppl {ppl_fault}, gap "
          f"{fault_gap}", flush=True)
    print(f"scoring ({model}) wall ms per eval_ppl (4 batches of 4 x (128 "
          f"+ 64)), fused vs unfused lm_head+CE, in turns: "
          + json.dumps(walls), flush=True)
    if not gap <= SCORING_TOL:
        raise AssertionError(f"scoring {model}: card perplexity {ppl_card} "
                             f"vs cpu {ppl_cpu}")
    if not fault_gap > SCORING_TOL:
        raise AssertionError(f"scoring {model}: planted fault within the "
                             f"tolerance ({fault_gap})")
    result = dict(model=model, d_model=config.d_model, lines=lines,
                  ppl_card=ppl_card, ppl_cpu=ppl_cpu,
                  relative_gap=gap, fault_gap=fault_gap,
                  checkpoint_bytes=size, write_s=write_s, main_s=main_s,
                  cpu_s=cpu_s, eval_wall_ms=walls)
    return launches, result


# ---------------------------------------------------------------------------
# pretraining: the driver on configs/fr/fat5-fr-small.yaml at full width
# ---------------------------------------------------------------------------

PRETRAIN_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "fr", "fat5-fr-small.yaml")


class StubTokenizer:
    """The shape of FAT5's French tokenizer without its files (the YAML's
    `tokenizer-flasht5-french` is not in the repository): 32,768 ids, pad 0,
    eos 1, the task prefixes [R], [S] and [X] as ids 2-4, and 100 sentinels
    at the top ids (<extra_id_0> = 32767, descending), as the collator reads
    them."""
    pad_token_id, eos_token_id = 0, 1
    all_special_tokens = ([f"<extra_id_{i}>" for i in range(100)]
                          + ["<pad>", "</s>"])
    all_special_ids = [32767 - i for i in range(100)] + [0, 1]
    _prefix = {"[R]": 2, "[S]": 3, "[X]": 4}

    def __len__(self):
        return 32768

    def encode(self, text):
        return [self._prefix[text], self.eos_token_id]


def _synthetic_corpus(n_rows=2000, lo=300, hi=3000, seed=0):
    """Pretokenized rows from the seed, in place of the YAML's `data/train`:
    lengths uniform in [lo, hi], ids uniform over the ordinary vocabulary
    (5 .. 32667), each row ending in eos."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n_rows)
    flat = rng.integers(5, 32768 - 100, int(lengths.sum()), dtype=np.int32)
    rows = np.split(flat, np.cumsum(lengths)[:-1])
    for row in rows:
        row[-1] = 1
    return [{"input_ids": row} for row in rows]


def _state_tensors(trainer):
    from flasht5_tpu_torch.models import t5
    return ([p for _, p in t5.tree_leaves_with_path(trainer.params)]
            + [t for st in trainer.optimizer.state_dict()["state"]
               for t in st.values()])


def _check_checkpoint(trainer, step_dir):
    """Save and load times of the run's checkpoint, and the state a new
    trainer restores from it: bit-equal to the saved trainer's, which
    differs from the seed's initial parameters."""
    from flasht5_tpu_torch.train import Trainer
    from flasht5_tpu_torch.train.trainer import CHECKPOINT_FILE

    t0 = time.perf_counter()
    trainer.save_checkpoint(trainer.step_num)      # the same state again
    save_s = time.perf_counter() - t0
    fresh = Trainer(trainer.config, trainer.tcfg, device=trainer.device)
    changed = sum(not torch.equal(a, b) for a, b in zip(
        _state_tensors(fresh), _state_tensors(trainer)))
    t0 = time.perf_counter()
    step = fresh.restore_checkpoint(step_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    equal = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        _state_tensors(fresh), _state_tensors(trainer)))
    info = dict(bytes=os.path.getsize(os.path.join(step_dir,
                                                   CHECKPOINT_FILE)),
                save_s=save_s, load_s=load_s, restored_step=step,
                optimizer_step_count=fresh.optimizer.step_count,
                tensors_changed_from_init=changed, restored_bit_equal=equal)
    print(f"checkpoint {step_dir}: {json.dumps(info)}", flush=True)
    if not (equal and changed and step == trainer.step_num
            == fresh.optimizer.step_count):
        raise AssertionError(f"checkpoint round trip: {info}")
    return info


def run_pretraining(dev):
    """The pretraining driver: `train.cli.run` on configs/fr/fat5-fr-small.yaml
    at full width (batch 64 x (1024 + 256), pallas attention on the bias
    kernels), with only max_steps (4, then 8), save_steps (4), logging_steps
    (1) and output_dir (a temporary directory) changed, a stub tokenizer and
    ~2,000 synthetic rows from the seed. The second run must resume from
    step 4 and take steps 5-8; every kernel of the path must launch in each
    run (counts set to 0 just before, read just after), losses be finite,
    and the checkpoint restore bit-equal. Then: tokens/s of each run's
    steps after its first over a wall time read after a synchronize (the
    trainer's logged rate reads its clock before a step's backward is done,
    so it leads the card by up to one step), the collator's time a batch
    and its non-pad share, a step's wall and device time, its kernels by
    name, peak memory."""
    import tempfile

    from flasht5_tpu_torch import ops
    from flasht5_tpu_torch.config import load_run_config
    from flasht5_tpu_torch.train import cli

    tok = StubTokenizer()
    corpus = _synthetic_corpus()
    yaml_cfg = load_run_config(PRETRAIN_YAML)
    runs, total = [], {}
    with tempfile.TemporaryDirectory(prefix="fat5-fr-small-") as out:
        def run_cfg(max_steps):
            return dict(yaml_cfg, training_args=dict(
                yaml_cfg["training_args"], max_steps=max_steps, save_steps=4,
                logging_steps=1, output_dir=out))

        torch.cuda.reset_peak_memory_stats()
        for max_steps in (4, 8):
            first = max_steps - 3
            lines, synced = [], {}

            def log(entry, first=first, max_steps=max_steps, synced=synced):
                # the trainer reads its clock once the step's loss is ready,
                # before the step's backward has run on the card; the synced
                # rate reads the clock after the first and the last step
                # have run to their end (one collation then waits on the
                # card instead of overlapping it)
                if isinstance(entry, dict) and entry["step"] in (first,
                                                                 max_steps):
                    torch.cuda.synchronize()
                    synced[entry["step"]] = time.perf_counter()
                lines.append(entry)

            ops.reset_launch_counts()
            t0 = time.perf_counter()
            trainer, res = cli.run(run_cfg(max_steps), tok, corpus,
                                   device=dev, log_fn=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            logs = [e for e in lines if isinstance(e, dict)]
            said = [e for e in lines if isinstance(e, str)]
            losses = [e["loss"] for e in logs]
            synced_s = synced[max_steps] - synced[first]
            print(f"pretraining run {len(runs) + 1} of 2 (max_steps "
                  f"{max_steps}): {said}; steps {[e['step'] for e in logs]}; "
                  f"losses {json.dumps(losses)}; tokens/s as logged "
                  f"{json.dumps([e['tokens_per_sec'] for e in logs])}; "
                  f"steps {first + 1}-{max_steps} in {synced_s:.4f} s between "
                  f"synchronized clock readings; "
                  f"{wall:.3f} s with set-up, collation and checkpoints; "
                  f"launches {json.dumps(launches)}", flush=True)
            missing = [name for name in PRETRAIN if launches[name] <= 0]
            if missing:
                raise AssertionError(f"kernels not launched while "
                                     f"pretraining: {missing}")
            resumed = [x for x in said if x.startswith("resuming from")]
            if (not all(np.isfinite(losses))
                    or [e["step"] for e in logs] != list(range(first,
                                                               first + 4))
                    or resumed != ([] if max_steps == 4 else [
                        f"resuming from {os.path.join(out, 'step_4')}"])):
                raise AssertionError(f"pretraining run to {max_steps}: "
                                     f"{said} {logs}")
            for name, n in launches.items():
                total[name] = total.get(name, 0) + n
            runs.append(dict(steps=[e["step"] for e in logs], losses=losses,
                             tokens_per_s=[e["tokens_per_sec"] for e in logs],
                             synced_steps=max_steps - first,
                             synced_s=synced_s, seconds=wall,
                             launches=launches))
            if max_steps == 4:
                checkpoint = _check_checkpoint(trainer,
                                               os.path.join(out, "step_4"))
                del trainer
                torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated()

    # the collator alone, and what its batches hold
    collator = cli.make_collator(run_cfg(8), tok, trainer.config)
    batches = cli.batch_iterator(corpus, collator, collator.batch_size,
                                 seed=1)
    t0 = time.perf_counter()
    sample = [next(batches) for _ in range(4)]
    collate_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
    tokens_per_step = collator.batch_size * (collator.max_length
                                             + collator.max_labels_length)
    for r in runs:
        r["tokens_per_s_synced"] = (r["synced_steps"] * tokens_per_step
                                    / r["synced_s"])
    print(f"tokens/s synced (the steps after each run's first, between "
          f"clock readings taken after torch.cuda.synchronize()): "
          f"{json.dumps([r['tokens_per_s_synced'] for r in runs])}",
          flush=True)
    shares = dict(
        input_non_pad=float(np.mean([b["attention_mask"].mean()
                                     for b in sample])),
        label_non_pad=float(np.mean([(b["labels"] != -100).mean()
                                     for b in sample])))
    print(f"collator: {collate_ms:.3f} ms a batch of "
          f"{collator.batch_size} x ({collator.max_length} + "
          f"{collator.max_labels_length}); non-pad shares "
          f"{json.dumps(shares)}", flush=True)

    # one step's wall time (each ended by a synchronize), and its kernels
    # by name, whose sum is its device time
    db = trainer._device_batch(sample[0])
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer._step(db)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step = dict(wall_ms=sorted(walls)[1])
    bodies = (wgmma_bodies(NO_BIAS) + TENSOR_BODIES
              + (RMS_FWD_BODY, RMS_BWD_BODY))
    by_name = _kernels_by_name(lambda: trainer._step(db))
    step["kernels_per_step"] = sum(n for _, n in by_name.values())
    step["device_ms"] = sum(t for t, _ in by_name.values())
    step["device_idle_share"] = 1.0 - step["device_ms"] / step["wall_ms"]
    _require_kernels(by_name, bodies, "one pretrain step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:16]
    print(f"pretrain step: {json.dumps(step)} (wall: median of 3 steps; "
          f"device: the sum of one profiled step's kernel times); peak "
          f"memory {peak} B", flush=True)
    print("profile of one pretrain step: " + json.dumps(
        [{"name": name[:80], "ms": t, "launches": n}
         for name, (t, n) in top]), flush=True)
    result = dict(
        batch=collator.batch_size, tokens_per_step=tokens_per_step,
        runs=runs, checkpoint=checkpoint, collate_ms=collate_ms,
        non_pad_shares=shares, step=step, peak_memory_bytes=peak,
        corpus_rows=len(corpus),
        corpus_tokens=int(sum(len(r["input_ids"]) for r in corpus)))
    return total, result


# ---------------------------------------------------------------------------

KERNELS = {
    "rms_norm": ("cuda", "flasht5_tpu_torch/csrc/rmsnorm.cu",
                 "flasht5_tpu/ops/rmsnorm.py:85"),
    "rms_norm_bwd": ("cuda", "flasht5_tpu_torch/csrc/rmsnorm.cu",
                     "flasht5_tpu/ops/rmsnorm.py:115"),
    "flash_attention_rpe": ("cuda",
                            "flasht5_tpu_torch/csrc/flash_attention_rpe.cu",
                            "flasht5_tpu/ops/flash_attention_rpe.py:489"),
    "flash_attention_bwd": ("cuda",
                            "flasht5_tpu_torch/csrc/flash_attention_bwd.cu",
                            "flasht5_tpu/ops/flash_attention_rpe.py:1191"),
    "cross_entropy_fwd": ("triton", "flasht5_tpu_torch/ops/cross_entropy.py",
                          "flasht5_tpu/ops/cross_entropy.py:352"),
    "cross_entropy_bwd": ("triton", "flasht5_tpu_torch/ops/cross_entropy.py",
                          "flasht5_tpu/ops/cross_entropy.py:417"),
    # the split form's combine over the shards (its forward: :352)
    "cross_entropy_combine": ("triton",
                              "flasht5_tpu_torch/ops/cross_entropy.py",
                              "flasht5_tpu/ops/cross_entropy.py:352"),
    "quant_matmul": ("cuda", "flasht5_tpu_torch/csrc/quant_matmul.cu",
                     "flasht5_tpu/ops/quant.py:196"),
    "decode_attention": ("cuda", "flasht5_tpu_torch/csrc/decode_attention.cu",
                         "flasht5_tpu/ops/decode_attention.py:285"),
    # one kernel for the three paged kernels (:935, :377 and :825, the
    # paged engine's default)
    "paged_decode_attention": ("cuda",
                               "flasht5_tpu_torch/csrc/"
                               "paged_decode_attention.cu",
                               "flasht5_tpu/inference/paged_kv.py:825"),
    "flash_attention_bias": ("cuda",
                             "flasht5_tpu_torch/csrc/flash_attention_bias.cu",
                             "flasht5_tpu/ops/flash_attention.py:325"),
    "flash_attention_bias_dkv": ("cuda", "flasht5_tpu_torch/csrc/"
                                 "flash_attention_bias.cu",
                                 "flasht5_tpu/ops/flash_attention.py:766"),
    "flash_attention_bias_dq": ("cuda", "flasht5_tpu_torch/csrc/"
                                "flash_attention_bias.cu",
                                "flasht5_tpu/ops/flash_attention.py:798"),
    "fused_linear_ce_fwd": ("cuda", "flasht5_tpu_torch/csrc/"
                            "fused_linear_ce.cu",
                            "flasht5_tpu/ops/fused_linear_ce.py:253"),
    "fused_linear_ce_bwd": ("cuda", "flasht5_tpu_torch/csrc/"
                            "fused_linear_ce.cu",
                            "flasht5_tpu/ops/fused_linear_ce.py:320"),
    # no Pallas kernel: the gradient of the bias's `jnp.take`, XLA's
    # scatter-add there
    "t5_bias_grad": ("cuda", "flasht5_tpu_torch/csrc/t5_bias_grad.cu",
                     "flasht5_tpu/positional.py:114"),
}
# the kernels each path runs, and must launch in each of its runs
SERVING = ("rms_norm", "flash_attention_rpe", "quant_matmul",
           "decode_attention")
PAGED = ("rms_norm", "flash_attention_rpe", "quant_matmul",
         "paged_decode_attention")
# greedy `inference.generate`: the encoder, then single-query decode steps
GENERATION = ("rms_norm", "flash_attention_rpe", "quant_matmul",
              "decode_attention")
TRAINING = ("rms_norm", "rms_norm_bwd", "flash_attention_rpe",
            "flash_attention_bwd", "cross_entropy_fwd", "cross_entropy_bwd")
# the pretraining driver on `pallas`: the bias kernels for self-attention,
# the RPE kernels without a table for the cross-attention
PRETRAIN = ("rms_norm", "rms_norm_bwd", "flash_attention_rpe",
            "flash_attention_bwd", "flash_attention_bias",
            "flash_attention_bias_dkv", "flash_attention_bias_dq",
            "cross_entropy_fwd", "cross_entropy_bwd", "t5_bias_grad")
# the scoring path on a checkpoint (`ref` attention, unfused norms): the
# fused forward in full precision, quant_matmul in the quantized variants
SCORING = ("fused_linear_ce_fwd", "quant_matmul")
# the train step with use_fused_lm_head_ce
FUSED_TRAINING = ("rms_norm", "rms_norm_bwd", "flash_attention_rpe",
                  "flash_attention_bwd", "fused_linear_ce_fwd",
                  "fused_linear_ce_bwd")
# fine-tuning a head over the encoder on `pallas_rpe` (the heads' losses
# are plain PyTorch, as the JAX package's are plain XLA)
FINETUNE = ("rms_norm", "rms_norm_bwd", "flash_attention_rpe",
            "flash_attention_bwd")
# the slot engine's speculative windows: the prefill's encoder, then the
# windows' plain attention on quant_matmul and the rms_norm forward
SPEC_SERVING = ("rms_norm", "flash_attention_rpe", "quant_matmul")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from flasht5_tpu_torch import runtime

    import triton
    t_start = time.perf_counter()
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

    check_wgmma_descriptor(dev)
    checks = (check_kernels(dev) + check_paged_kernels(dev)
              + check_training_kernels(dev) + check_bias_kernels(dev)
              + check_bias_grad_kernel(dev) + check_flce_kernels(dev))
    for d_kv in (32, 16):
        check_small_reference(dev, d_kv)
        check_small_paged(dev, d_kv)
    check_small_training(dev)
    check_small_generation(dev)
    small_encodings = check_small_encodings(dev)
    goldens = check_goldens(dev)
    served_launches, served = run_engine(dev)
    paged_launches, paged = run_paged_engine(dev)
    torch.cuda.empty_cache()
    gen_launches, generated = run_generation(dev)
    torch.cuda.empty_cache()
    encoding_launches, encodings = run_encodings(dev)
    torch.cuda.empty_cache()
    serving_ranks_launches, serving_ranks = run_serving_ranks(dev)
    torch.cuda.empty_cache()
    trained_launches, fused_launches, trained = run_training(dev)
    torch.cuda.empty_cache()
    parallel_launches, parallel = run_parallel(dev)
    small_finetune = check_small_finetune(dev)
    finetune_launches, finetuned = run_finetune(dev)
    torch.cuda.empty_cache()
    scored_launches, scored = run_scoring(dev)
    torch.cuda.empty_cache()
    wide_launches, wide_scored = run_scoring(dev, "FAT5-flan-base")
    torch.cuda.empty_cache()
    pretrain_launches, pretrained = run_pretraining(dev)
    torch.cuda.empty_cache()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--library-kernels"], check=True, timeout=600)

    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        main_case = next(r for r in checks
                         if r["name"] == name and r["main"])
        by_path = {}
        if name in SERVING:
            by_path["serving"] = served_launches[name]
        if name in PAGED:
            by_path["paged"] = paged_launches[name]
        if name in GENERATION:
            by_path["generation"] = gen_launches[name]
        if name in TRAINING:
            by_path["training"] = trained_launches[name]
        if name in PRETRAIN:
            by_path["pretraining"] = pretrain_launches[name]
        if name in SCORING:
            by_path["scoring"] = scored_launches[name]
            by_path["scoring_flan_base"] = wide_launches[name]
        if name in FUSED_TRAINING:
            by_path["fused_training"] = fused_launches[name]
        for path, counted in (*parallel_launches.items(),
                              *serving_ranks_launches.items()):
            if counted[name]:
                by_path[path] = counted[name]
        if name in FINETUNE:
            by_path["finetune"] = finetune_launches[name]
        if name in SPEC_SERVING:
            by_path["spec_serving"] = served["spec"]["launches"][name]
        for pe in FULL_ENCODINGS:
            bias = pe != "RoPE"
            if name in (BIAS_TRAINING if bias else TRAINING):
                by_path[f"{pe}_training"] = encoding_launches[
                    f"{pe}_training"][name]
            if name in (BIAS_GENERATION if bias else GENERATION):
                by_path[f"{pe}_generation"] = encoding_launches[
                    f"{pe}_generation"][name]
        # launches_by_path: each path's median run (the slot engine's, the
        # paged engine's, the training loops', unfused and fused), the
        # scoring's one run, greedy generation's one run, each encoding's
        # counted training run and greedy generation, or, for the
        # pretraining driver, its two runs,
        # each counted from 0 just before it;
        # launches: their sum over the paths that run the kernel
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=main_case["max_abs_err"],
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"], shape=main_case["shape"]))
    print(json.dumps({"engine": served}))
    print(json.dumps({"paged_engine": paged}))
    print(json.dumps({"serving_ranks": serving_ranks}))
    print(json.dumps({"generation": generated}))
    print(json.dumps({"training": trained}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"finetune": dict(small=small_finetune,
                                       full_width=finetuned)}))
    print(json.dumps({"scoring": scored}))
    print(json.dumps({"scoring_flan_base": wide_scored}))
    print(json.dumps({"pretraining": pretrained}))
    print(json.dumps({"encodings": dict(small=small_encodings,
                                        goldens=goldens,
                                        full_width=encodings)}))
    print("empty profiles retaken " + json.dumps(EMPTY_PROFILES), flush=True)
    print("short profiles retaken " + json.dumps(SHORT_PROFILES), flush=True)
    print(f"smoke wall {time.perf_counter() - t_start:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# probes: `python3 chip_smoke.py --probe [ROOT]`
# ---------------------------------------------------------------------------

def host_us(fn, args, calls: int = 200) -> float:
    """Host time of one call of `fn` in microseconds: `calls` calls
    enqueued behind a `torch.cuda._sleep`, so none waits on the device."""
    fn(*args)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(_cycles_per_ms() * 100))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def probe(dev) -> int:
    """Measurements the smoke does not make, for `flasht5_tpu_torch`
    as imported (`--probe ROOT` imports it from the checkout at ROOT, so
    two commits can be run in turns in one call):
    - "host-cost": the host's time a `quant_matmul` call takes at the
      decode step's four shapes and a prefill shape, a `decode_attention`
      call at the cross shape, a `paged_attention` call at the paged
      engine's serving shape, an `rms_norm_fwd` call at the decode shape
      and an `rms_norm_bwd` call at the train step's encoder shape
      (median of 5 runs of `host_us`) beside the kernel's device time;
    - "rms-rows": the two `rms_norm` kernels' device ms at the serving,
      train step and pretraining shapes (an fp32 weight);
    - "convert-rows", where the package has `CONVERT_ROWS`: the bf16 fused
      lm_head+CE forward of an f32 lm_head at 256-2048 rows, w rounded
      in shared memory and w rounded once into the scratch, each timed
      as the smoke times kernels."""
    from flasht5_tpu_torch.ops import fused_linear_ce as flce
    from flasht5_tpu_torch.ops import quant
    gen = torch.Generator(device=dev).manual_seed(5)
    for m, k_dim, n in ((8, 512, 512), (8, 512, 2048), (8, 2048, 512),
                        (8, 512, 32768), (4096, 512, 2048)):
        def make():
            x = torch.randn((m, k_dim), generator=gen, device=dev).to(
                torch.bfloat16)
            return x, quant.quantize_int8(torch.randn(
                (k_dim, n), generator=gen, device=dev) * k_dim ** -0.5)
        sets = copies_for(make, k_dim * n + m * k_dim * 2)
        runs = sorted(host_us(quant.quant_matmul, sets[0])
                      for _ in range(5))
        print("host-cost " + json.dumps(dict(
            shape=f"x ({m}, {k_dim}) bf16 @ int8 ({k_dim}, {n})",
            host_us=runs[2], host_us_runs=runs,
            ms=device_ms(quant.quant_matmul, sets, 200))), flush=True)
    from flasht5_tpu_torch.ops import decode_attention as da
    from flasht5_tpu_torch.ops import paged_attention as pa

    def dec_make():
        kq, ks = quant.quantize_kv(torch.randn((8, 8, 512, 64),
                                               generator=gen, device=dev))
        vq, vs = quant.quantize_kv(torch.randn((8, 8, 512, 64),
                                               generator=gen, device=dev))
        q = torch.randn((8, 8, 64), generator=gen, device=dev).to(
            torch.bfloat16)
        lens = torch.full((8,), 512, dtype=torch.int32, device=dev)
        return q, kq, vq, ks, vs, lens

    def dec_call(q, kq, vq, ks, vs, lens):
        return da.decode_attention(q, kq, vq, ks, vs, lengths=lens)

    def paged_make():
        pkv, skv = _paged_pool(dev, gen, 40, 8, 64, 64)
        q = torch.randn((8, 8, 64), generator=gen, device=dev)
        table = torch.randperm(40, device=dev).reshape(8, 5).int()
        lens = torch.tensor([1, 40, 64, 65, 130, 200, 257, 320],
                            dtype=torch.int32, device=dev)
        bias = torch.randn((8, 8, 320), generator=gen, device=dev)
        return q, pkv, skv, table, lens, bias

    def paged_call(q, pkv, skv, table, lens, bias):
        return pa.paged_attention(q, pkv[:, 0], pkv[:, 1], skv[:, 0],
                                  skv[:, 1], table, lens, bias=bias,
                                  return_state=True)
    for label, make, call, n_bytes in (
            ("decode_attention q (8, 8, 64) bf16, int8 K/V (8, 8, 512, 64)",
             dec_make, dec_call, 8 * 8 * 512 * 136),
            ("paged_attention q (8, 8, 64) f32, int8 fused pool (41, 2, 8, "
             "64, 64), table (8, 5), bias, state", paged_make, paged_call,
             41 * 2 * 8 * 64 * 68)):
        sets = copies_for(make, n_bytes)
        runs = sorted(host_us(call, sets[0]) for _ in range(5))
        print("host-cost " + json.dumps(dict(
            shape=label, host_us=runs[2], host_us_runs=runs,
            ms=device_ms(call, sets, 200))), flush=True)
    from flasht5_tpu_torch.ops import rmsnorm

    def rms_make(rows, d=512):
        def make():
            x = torch.randn((rows, d), generator=gen, device=dev).to(
                torch.bfloat16)
            w = 1 + 0.1 * torch.randn((d,), generator=gen, device=dev)
            dy = torch.randn((rows, d), generator=gen, device=dev).to(
                torch.bfloat16)
            return x, w, rmsnorm.rms_norm_fwd(x, w)[1], dy
        return make

    # the model's form: the weight's cast folded in (a package older than
    # the `cast_w` keyword always folds it)
    kw = ({"cast_w": True} if "cast_w" in rmsnorm.rms_norm_fwd.__code__
          .co_varnames else {})

    def rms_fwd(x, w, rstd, dy):
        return rmsnorm.rms_norm_fwd(x, w, **kw)

    def rms_bwd(x, w, rstd, dy):
        return rmsnorm.rms_norm_bwd(x, w, rstd, dy, **kw)
    for label, fn, rows in (
            ("rms_norm_fwd x (8, 512) bf16, w f32", rms_fwd, 8),
            ("rms_norm_bwd x, dy (8192, 512) bf16, w f32", rms_bwd, 8192)):
        sets = copies_for(rms_make(rows), rows * 512 * 4)
        runs = sorted(host_us(fn, sets[0]) for _ in range(5))
        print("host-cost " + json.dumps(dict(
            shape=label, host_us=runs[2], host_us_runs=runs,
            ms=device_ms(fn, sets, 200))), flush=True)
    # device ms at the paths' shapes
    for fn, all_rows in ((rms_fwd, (8, 4096, 16384, 65536)),
                         (rms_bwd, (2048, 8192, 16384, 65536))):
        for rows in all_rows:
            sets = copies_for(rms_make(rows), rows * 512 * 4)
            iters = 200 if rows <= 8192 else 50
            row = dict(kernel=fn.__name__, shape=f"({rows}, 512) bf16, w f32",
                       ms=device_ms(fn, sets, iters))
            print("rms-rows " + json.dumps(row), flush=True)
            del sets
    if not hasattr(flce, "CONVERT_ROWS"):
        return 0
    default = flce.CONVERT_ROWS
    for d, v in ((512, 32768), (768, 32128)):
        for rows in (256, 512, 768, 1024, 1536, 2048):
            def make():
                return (torch.randn((rows, d), generator=gen,
                                    device=dev).to(torch.bfloat16),
                        torch.randn((d, v), generator=gen, device=dev)
                        * d ** -0.5)
            sets = copies_for(make, d * v * 4 + rows * d * 2)
            row = dict(rows=rows, d=d, v=v, convert_rows=default)
            for form, limit in (("smem_ms", 1 << 30), ("scratch_ms", 0)):
                flce.CONVERT_ROWS = limit
                row[form] = device_ms(flce.fused_linear_ce_fwd, sets, 100)
            flce.CONVERT_ROWS = default
            print("convert-rows " + json.dumps(row), flush=True)
    return 0


# the attention rows of the train step (batch 8, 8 heads, d 64, bf16): tag,
# query rows, keys, causal, with the table
ATTN_ROWS = [("encoder, table", 1024, 1024, False, True),
             ("cross, no table", 256, 1024, False, False),
             ("decoder self, causal, table", 256, 256, True, True),
             ("RoPE encoder, no table", 1024, 1024, False, False),
             ("RoPE decoder self, causal, no table", 256, 256, True, False)]


def _grads_f64(q, k, v, bias, lse, delta, do, causal, sm_scale):
    """dq, dk, dv of the backward's function in f64 from the same inputs
    (no rounding anywhere), and the magnitudes its roundings act on, by
    the formula of the plain module's `grad_abs_plain` (|dS'| |k| scale,
    |dS'|^T |q| scale, P'^T |dO|, with D 2^-16 of the f32 sums of
    |products| on P and dS), in f64."""
    from flasht5_tpu_torch.ops import flash_attention_rpe as rpe
    d = q.shape[-1]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.transpose(-1, -2) * sm_scale + bias
    lse4 = lse.double()[..., None]
    ok = rpe._visible(q.shape[2], k.shape[2], causal, q.device) & (
        lse4 > -5e29)
    p = torch.where(ok, torch.exp(s - torch.where(ok, lse4, 0.0)), 0.0)
    del s
    ds = p * (do @ v.transpose(-1, -2) - delta.double()[..., None])
    grads = (ds @ k * sm_scale, ds.transpose(-1, -2) @ q * sm_scale,
             p.transpose(-1, -2) @ do)
    qa, ka, va, doa = (t.abs() for t in (q, k, v, do))
    qk = qa @ ka.transpose(-1, -2) * sm_scale
    ds = ds.abs() + d * 2.0 ** -16 * (p * (doa @ va.transpose(-1, -2))
                                      + ds.abs() * qk)
    p = p + d * 2.0 ** -16 * p * qk
    del qk
    sums = (ds @ ka * sm_scale, ds.transpose(-1, -2) @ qa * sm_scale,
            p.transpose(-1, -2) @ doa)
    return grads, sums


def attn_probe(dev) -> int:
    """The attention kernels alone, for `flasht5_tpu_torch` as imported
    (`--attn-probe ROOT` imports it from the checkout at ROOT, so that two
    commits can run in turns in one call):
    - "dq-limit": the encoder row of `check_training_kernels` (table,
      bidirectional) on the inputs it had when the RoPE rows shared its
      generator, where one dq entry went beyond the old limit (one ulp of
      the entry plus 2e-3 of dq's largest): dq, dk and dv from the kernel,
      from the plain version and in f64 from the same bf16 inputs. Per
      output: each one's largest |error| against f64; the most the
      kernel's error exceeds the plain version's, in units of one rounding
      of the bf16 terms (BF16_ULP of the f64 sum of their magnitudes); the
      entries beyond the old limit and beyond the derived one (the plain
      module's `grad_limits`, here on the f64 sums, since ROOT's package
      may predate it), with the worst share of each; and the same shares
      for the kernel on its keys rolled by one.
    - "attn-row": the forward's and the backward's device ms at ATTN_ROWS,
      timed as the smoke times kernels;
    - "decode-pad": `decode_attention` at the cross shape (8, 8, 512) and
      the paged kernel at the serving shape (8 slots, 8 heads, pages of 64)
      with bf16 caches at d 48, which the wrappers zero-pad to 64, beside
      d 64 (ROOT's package may refuse d 48: then its line says so)."""
    from flasht5_tpu_torch.ops import flash_attention_rpe as rpe
    cases = check_training_kernels(dev, rope_generator=False, run=False)
    for c in cases:    # every earlier case's copies, as run_checks makes
        sets = copies_for(c["make"], c["in_bytes"])
        if c["name"] == "flash_attention_bwd":
            break
    q, k, v, w, lse, delta, do = sets[0][0]
    del sets
    kw = dict(causal=False, bidirectional=True, sm_scale=1.0)
    bias = rpe._bias(w, q.shape[2], k.shape[2], True, 32, 128)
    want, sums = _grads_f64(q, k, v, bias.double(), lse, delta, do, False,
                            1.0)
    got = rpe.flash_attention_bwd(q, k, v, w, lse, delta, do, **kw)[:3]
    plain = rpe.flash_attention_bwd_plain(q, k, v, w, lse, delta, do,
                                          **kw)[:3]
    rolled = rpe.flash_attention_bwd(q, torch.roll(k, 1, 2), v, w, lse,
                                     delta, do, **kw)[:3]
    n = dict(dq=k.shape[2], dk=q.shape[2], dv=q.shape[2])
    for i, name in enumerate(("dq", "dk", "dv")):
        g, p, f64, a = got[i].double(), plain[i].double(), want[i], sums[i]
        err_k, err_p = (g - f64).abs(), (p - f64).abs()
        unit = BF16_ULP * a
        old = 2e-3 * p.abs().max() + BF16_ULP * p.abs()
        new = BF16_ULP * p.abs() + (BF16_ULP + n[name] * 2.0 ** -24) * a
        diff, fdiff = (g - p).abs(), (rolled[i].double() - p).abs()
        at = int((diff / old).argmax())    # the old limit's worst entry
        print("dq-limit " + json.dumps(dict(
            output=name, max_abs_err_kernel_f64=float(err_k.max()),
            max_abs_err_plain_f64=float(err_p.max()),
            kernel_excess_in_roundings=float(
                ((err_k - err_p) / unit.clamp_min(1e-30)).max()),
            old_worst_entry=dict(
                plain=float(p.flatten()[at]), kernel=float(g.flatten()[at]),
                f64=float(f64.flatten()[at]), sum=float(a.flatten()[at]),
                old_limit=float(old.flatten()[at]),
                derived_limit=float(new.flatten()[at])),
            old_beyond=int((diff > old).sum()),
            old_worst_share=float((diff / old).max()),
            derived_beyond=int((diff > new).sum()),
            derived_worst_share=float((diff / new).max()),
            rolled_derived_beyond=int((fdiff > new).sum()),
            rolled_derived_worst_share=float((fdiff / new).max()),
            entries=diff.numel())), flush=True)
    del want, sums, got, plain, rolled
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(8)
    for tag, m_len, n_len, causal, table in ATTN_ROWS:
        kw = dict(causal=causal, bidirectional=not causal, sm_scale=1.0)

        def make():
            q, do = (torch.randn((TRAIN_B, 8, m_len, 64), generator=gen,
                                 device=dev).to(torch.bfloat16)
                     for _ in range(2))
            k, v = (torch.randn((TRAIN_B, 8, n_len, 64), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            w = (torch.randn((32, 8), generator=gen, device=dev) * 0.5
                 if table else None)
            o, lse = rpe.flash_attention_rpe_fwd(q, k, v, w, **kw)
            delta = (do.float() * o.float()).sum(-1)
            return q, k, v, w, lse, delta, do
        sets = copies_for(make, 4 * TRAIN_B * 8 * (m_len + n_len) * 64 * 2)
        fwd = device_ms(lambda q, k, v, w, *rest: rpe.flash_attention_rpe_fwd(
            q, k, v, w, **kw), sets, 200)
        bwd = device_ms(lambda *a: rpe.flash_attention_bwd(*a, **kw), sets,
                        100)
        print("attn-row " + json.dumps(dict(
            shape=f"{tag}: q ({TRAIN_B}, 8, {m_len}, 64), k, v ({TRAIN_B}, "
                  f"8, {n_len}, 64) bf16", forward_ms=fwd,
            backward_ms=bwd)), flush=True)
        del sets
        torch.cuda.empty_cache()

    from flasht5_tpu_torch.ops import decode_attention as da
    from flasht5_tpu_torch.ops import paged_attention as pa
    row = {}
    for d in (64, 48):
        def dec_make(d=d):
            q = torch.randn((8, 8, d), generator=gen, device=dev).to(
                torch.bfloat16)
            k, v = (torch.randn((8, 8, 512, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2))
            return q, k, v

        def paged_make(d=d):
            pool = [torch.randn((72, 8, 64, d), generator=gen,
                                device=dev).to(torch.bfloat16)
                    for _ in range(2)]
            table = torch.arange(72, device=dev, dtype=torch.int32).reshape(
                8, 9)
            lens = torch.full((8,), 500, device=dev, dtype=torch.int32)
            q = torch.randn((8, 8, d), generator=gen, device=dev).to(
                torch.bfloat16)
            return q, pool[0], pool[1], None, None, table, lens
        try:
            row[f"decode_d{d}_ms"] = device_ms(
                da.decode_attention, copies_for(dec_make, 2 * 8 * 8 * 512 *
                                                d * 2), 200)
            row[f"paged_d{d}_ms"] = device_ms(
                pa.paged_attention, copies_for(paged_make, 2 * 72 * 8 * 64 *
                                               d * 2), 200)
        except ValueError as e:
            row[f"d{d}"] = f"refused: {e}"
    print("decode-pad " + json.dumps(row), flush=True)
    return 0


def spec_probe(dev) -> int:
    """`--spec-probe`: the speculative window's attention as one batched
    call a layer ((B, H, Q, N) scores by one einsum, one softmax, one
    einsum) in place of `engine._window_attention`'s Q single-query calls,
    for the self-attention, the cross-attention and both, at
    `run_spec_engine`'s serving settings on `run_engine`'s requests: for
    each way, the requests whose tokens part from the standard engine's
    (plain attention, one query a slot), tokens/s, and one window's
    kernels and device ms a step."""
    import dataclasses

    from flasht5_tpu_torch import flagship_config
    from flasht5_tpu_torch.inference import engine
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.quantize import quantize_params

    cfg = flagship_config()
    params = quantize_params(t5.init_params(cfg, seed=0, device=dev), "int8")
    n_req, enc_len, max_new, slots = 16, 512, 64, 8
    ecfg = engine.EngineConfig(max_slots=slots, max_decode_len=max_new + 2,
                               max_encode_len=enc_len,
                               encode_buckets=(enc_len,), kv_dtype="int8",
                               steps_per_sync=8, use_decode_kernel=False)
    rng = np.random.default_rng(0)
    inputs = [rng.integers(2, cfg.vocab_size, size=(enc_len,)).astype(
        np.int32) for _ in range(n_req)]
    std = engine.InferenceEngine(cfg, params, ecfg, device=dev)
    std.warmup()
    std_tokens, std_run = _serve(std, cfg, inputs, max_new)
    print(f"spec-probe standard engine: {std_run['tokens_per_s']:.3f} "
          f"tokens/s", flush=True)
    del std
    spec_cfg = dataclasses.replace(ecfg, spec_window=SPEC_WINDOW)
    eng = engine.InferenceEngine(cfg, params, spec_cfg, device=dev)
    eng.warmup()
    loop = engine._window_attention

    def batched(q, k, v, bias, valid, scale, dtype):
        s = torch.einsum("bhqd,bhnd->bhqn", q.float(), k) * scale
        if bias is not None:
            s = s + bias
        s = torch.where(valid[:, None], s, engine._NEG_INF)
        return torch.einsum("bhqn,bhnd->bqhd", torch.softmax(s, -1),
                            v).to(dtype)

    def fill():
        st = eng.state
        st.enc_len.fill_(enc_len)
        st.pos = torch.zeros_like(st.pos)
        st.budget = torch.full_like(st.budget, max_new)
        st.active = torch.ones_like(st.active)
        torch.cuda.synchronize()

    for way in ("loop", "self", "cross", "both"):
        def attention(q, k, v, bias, valid, scale, dtype, way=way):
            own = "self" if bias is not None else "cross"
            fn = batched if way in (own, "both") else loop
            return fn(q, k, v, bias, valid, scale, dtype)
        with _patched(engine, "_window_attention", attention):
            tokens, run = _serve(eng, cfg, inputs, max_new)
            by_name = _kernels_by_name(
                lambda: eng._window()[1].synchronize(), setup=fill)
        eng.state.active = torch.zeros_like(eng.state.active)
        k = spec_cfg.steps_per_sync
        differ = [i for i in std_tokens
                  if not np.array_equal(std_tokens[i], tokens[i])]
        print("spec-probe " + json.dumps(dict(
            batched=way, requests=n_req, differ=differ,
            tokens_per_s=run["tokens_per_s"],
            tokens_per_slot_window=run["tokens_per_slot_window"],
            kernels_per_step=sum(n for _, n in by_name.values()) / k,
            device_ms_per_step=sum(t for t, _ in by_name.values()) / k)),
            flush=True)
    return 0


CE_PROBE_CONFIGS = ([(r, bv, w, 3) for r in (1, 2, 4)
                     for bv in (1024, 2048, 4096, 8192) for w in (4, 8, 16)
                     if r * bv <= 16384]
                    + [(r, bv, 4, st) for r, bv in ((1, 2048), (1, 4096),
                                                    (2, 2048))
                       for st in (1, 2, 4)])


def ce_probe(dev) -> int:
    """`python3 chip_smoke.py --ce-probe [ROOT]`: the CE loss forward of
    `flasht5_tpu_torch` as imported (ROOT: the checkout to import it from,
    so parent and change run in turns in one call), as the smoke times
    kernels, with launches counted over one call:
    - "ce-loss" lines: `cross_entropy_loss` at the split shard (2048,
      8192) of 32768, class_start_idx 8192, smoothing 0.1, z-loss 1e-4,
      and unsplit at (2048, 32768) z-loss 1e-4; and the vocab-parallel
      loss's forward (`vocab_parallel_loss`, one NCCL rank) on the
      (2048, 32768) logits, smoothing 0.1 - each beside F.cross_entropy,
      its bound (the logits read once) and the kernels one call launches
      (one profile);
    - "ce-loss" lines for the split form's parts, where the package has
      the fused epilogue: the forward kernel alone, with the combine, and
      four shards combined (the shards sliced out of the whole logits, so
      each is copied first);
    - "ce-tile" lines: the forward kernel at every (rows, vocabulary
      tile, warps, pipeline stages) of CE_PROBE_CONFIGS, the split shard's
      kernel plus `cross_entropy_combine` and the unsplit kernel, each
      checked against its plain version."""
    import socket

    import torch.distributed as dist

    from flasht5_tpu_torch import flagship_config, ops
    from flasht5_tpu_torch.ops import cross_entropy as ce
    from flasht5_tpu_torch.parallel.vocab_parallel import vocab_parallel_loss
    gen = torch.Generator(device=dev).manual_seed(8)
    rows, vocab, sv = 2048, 32768, 8192
    split_kw = dict(total_classes=vocab, class_start_idx=sv, split=True)

    def make(width):
        def fn():
            x = (3.0 * torch.randn((rows, width), generator=gen,
                                   device=dev)).to(torch.bfloat16)
            labels = torch.randint(0, vocab, (rows,), generator=gen,
                                   device=dev)
            labels[::7] = -100
            # the library's labels: other shards' ignored
            return x, labels, torch.where(labels < width, labels, -100)
        return fn

    def launches(fn, args):
        ops.reset_launch_counts()
        fn(*args)
        torch.cuda.synchronize()
        return {k: v for k, v in ops.launch_counts().items() if v}

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    group = dist.new_group([0])
    cfg = flagship_config().replace(label_smoothing=0.1)
    rows_ = [
        ("split shard (2048, 8192) of 32768, smoothing 0.1",
         make(sv), lambda x, y, _: ce.cross_entropy_loss(
             x, y, 1e-4, 0.1, **split_kw), 0.1),
        ("unsplit (2048, 32768), z-loss 1e-4", make(vocab),
         lambda x, y, _: ce.cross_entropy_loss(x, y, 1e-4, 0.0), 0.0),
        ("vocab_parallel_loss forward, one NCCL rank, (2048, 32768), "
         "smoothing 0.1", make(vocab),
         lambda x, y, _: vocab_parallel_loss(cfg, x, y, group), 0.1)]
    with torch.no_grad():
        for label, mk, fn, smoothing in rows_:
            sets = copies_for(mk, rows * mk()[0].shape[1] * 2)
            print("ce-loss " + json.dumps(dict(
                shape=label, ms=device_ms(fn, sets, 16),
                kernels_a_call=sum(n for _, n in _kernels_by_name(
                    lambda: fn(*sets[0])).values()),
                library_ms=device_ms(
                    lambda x, _, y: F.cross_entropy(
                        x, y, reduction="none", label_smoothing=smoothing),
                    sets, 16),
                bound_ms=nbytes(sets[0][0]) / HBM_BYTES_PER_S * 1e3,
                launches=launches(fn, sets[0]))), flush=True)
            del sets
        if not hasattr(ce, "cross_entropy_combine"):
            dist.destroy_process_group()
            return 0

        def split_loss(x, y, _):
            out = ce.cross_entropy_fwd(x, y, lse_square_scale=1e-4,
                                       label_smoothing=0.1, **split_kw)
            return ce.cross_entropy_combine(out[None, :2], y,
                                            lse_square_scale=1e-4)

        def split_plain(x, y, _):
            out = ce.cross_entropy_fwd_plain(
                x, y, lse_square_scale=1e-4, label_smoothing=0.1, **split_kw)
            return ce.cross_entropy_combine_plain(out[None, :2], y,
                                                  lse_square_scale=1e-4)

        def unsplit(x, y, _):
            return ce.cross_entropy_fwd(x, y, lse_square_scale=1e-4)

        def unsplit_plain(x, y, _):
            return ce.cross_entropy_fwd_plain(x, y, lse_square_scale=1e-4)
        def shards4(x, y, _):
            parts = torch.stack([ce.cross_entropy_fwd(
                x[:, i * sv:(i + 1) * sv], y, lse_square_scale=1e-4,
                label_smoothing=0.1, total_classes=vocab,
                class_start_idx=i * sv, split=True)[:2] for i in range(4)])
            return ce.cross_entropy_combine(parts, y, lse_square_scale=1e-4)
        for label, mk, fn in (
                ("split shard: the forward kernel alone", make(sv),
                 lambda x, y, _: ce.cross_entropy_fwd(
                     x, y, lse_square_scale=1e-4, label_smoothing=0.1,
                     **split_kw)),
                ("split shard: kernel + combine", make(sv), split_loss),
                ("4 shards of (2048, 8192) combined, smoothing 0.1 "
                 "(the shards cut from one (2048, 32768))", make(vocab),
                 shards4)):
            sets = copies_for(mk, rows * mk()[0].shape[1] * 2)
            print("ce-loss " + json.dumps(dict(
                shape=label, ms=device_ms(fn, sets, 16),
                kernels_a_call=sum(n for _, n in _kernels_by_name(
                    lambda: fn(*sets[0])).values()),
                bound_ms=nbytes(sets[0][0]) / HBM_BYTES_PER_S * 1e3,
                launches=launches(fn, sets[0]))), flush=True)
            del sets
        saved = (ce._FWD_ROWS, ce._FWD_BLOCK_V, ce._FWD_WARPS,
                 ce._FWD_STAGES)
        cases = [("split shard kernel + combine", make(sv), split_loss,
                  split_plain),
                 ("unsplit (2048, 32768)", make(vocab), unsplit,
                  unsplit_plain)]
        for label, mk, fn, plain in cases:
            sets = copies_for(mk, rows * mk()[0].shape[1] * 2)
            want = plain(*sets[0])
            bound = nbytes(sets[0][0]) / HBM_BYTES_PER_S * 1e3
            for r, bv, w, st in CE_PROBE_CONFIGS:
                (ce._FWD_ROWS, ce._FWD_BLOCK_V, ce._FWD_WARPS,
                 ce._FWD_STAGES) = r, bv, w, st
                err = float((fn(*sets[0]) - want).abs().max())
                ms = device_ms(fn, sets, 64)
                print("ce-tile " + json.dumps(dict(
                    shape=label, rows=r, block_v=bv, warps=w, stages=st,
                    ms=ms,
                    bound_ms=bound, share_of_bound=bound / ms,
                    max_abs_err=err)), flush=True)
            (ce._FWD_ROWS, ce._FWD_BLOCK_V, ce._FWD_WARPS,
             ce._FWD_STAGES) = saved
            del sets
    dist.destroy_process_group()
    return 0


def profile_probe(dev, tries: int) -> int:
    """`python3 chip_smoke.py --profile-probe N`: N rounds of the smoke's
    order around its first kernel gate (a profile of SDPA's forward on a
    bf16 mask at the train encoder's shape, one of its backward, then one
    of the fused lm_head+CE forward at (2048, 512) x (512, 32768) f32), and
    a "profile-probe" line: the rounds whose last profile held no
    `flce_fwd_wgmma_kernel` after its retakes, with the kernels such a
    profile held, and every profile that held no device event at all."""
    from flasht5_tpu_torch.ops import fused_linear_ce as flce
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((2048, 512), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((512, 32768), generator=gen, device=dev)
    q, k, v = (torch.randn((8, 8, 1024, 64), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    mask = torch.randn((1, 8, 1024, 1024), generator=gen,
                       device=dev).to(torch.bfloat16)
    flce.fused_linear_ce_fwd(x, w)
    torch.cuda.synchronize()
    misses = []
    for i in range(tries):
        ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
        _kernels_by_name(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0))
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                             scale=1.0)
        _kernels_by_name(lambda: torch.autograd.grad(
            out, (ql, kl, vl), out, retain_graph=True))
        by_name = _kernels_by_name(lambda: flce.fused_linear_ce_fwd(x, w))
        if not any(FLCE_FWD_BODY in name for name in by_name):
            misses.append(dict(round=i, held=[n[:60] for n in by_name]))
    print("profile-probe " + json.dumps(dict(tries=tries, misses=misses,
                                             empty=EMPTY_PROFILES)),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4]))
    if sys.argv[1:2] == ["--parallel"]:
        sys.exit(parallel_only())
    if sys.argv[1:2] == ["--serving-rank"]:
        sys.exit(serving_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4]))
    if sys.argv[1:2] == ["--serving-ranks"]:
        sys.exit(serving_ranks_only())
    if sys.argv[1:2] == ["--probe"]:
        if len(sys.argv) > 2:
            sys.path.insert(0, os.path.abspath(sys.argv[2]))
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        print(sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0], flush=True)
        sys.exit(probe(torch.device("cuda", 0)))
    if sys.argv[1:2] == ["--attn-probe"]:
        if len(sys.argv) > 2:
            sys.path.insert(0, os.path.abspath(sys.argv[2]))
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        print(sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0], flush=True)
        from flasht5_tpu_torch import runtime
        runtime.build_kernels(["flash_attention_rpe", "flash_attention_bwd"])
        sys.exit(attn_probe(torch.device("cuda", 0)))
    if sys.argv[1:2] == ["--bias-grad-probe"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        print(sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0], flush=True)
        from flasht5_tpu_torch import runtime
        print(runtime.build_kernels(["t5_bias_grad"]), flush=True)
        check_bias_grad_kernel(torch.device("cuda", 0))
        sys.exit(0)
    if sys.argv[1:2] == ["--library-kernels"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        sys.exit(library_kernels(torch.device("cuda", 0)))
    if sys.argv[1:2] == ["--spec-probe"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        print(sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0], flush=True)
        sys.exit(spec_probe(torch.device("cuda", 0)))
    if sys.argv[1:2] == ["--ce-probe"]:
        if len(sys.argv) > 2:
            sys.path.insert(0, os.path.abspath(sys.argv[2]))
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        print(sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0], flush=True)
        sys.exit(ce_probe(torch.device("cuda", 0)))
    if sys.argv[1:2] == ["--profile-probe"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        sys.exit(profile_probe(torch.device("cuda", 0), int(sys.argv[2])))
    sys.exit(main())
