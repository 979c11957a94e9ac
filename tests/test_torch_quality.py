"""The port's scoring path (`flasht5_tpu_torch/quality.py`) against the root
`bench_quality.py` and `flasht5_tpu.quantize`, on the CPU.

The same weights (made by the JAX package, carried across as numpy) and
the same token batches go to both `eval_ppl`s, in full precision and in
the four quantized variants. Tolerances, with their reasons:
- f32 activations: perplexity to 1e-5 relative in full precision (sums in
  another order); the quantized variants round x to bf16 before each
  dequant matmul on both sides, a value one f32 ulp apart may round to the
  neighbouring bf16 value (2^-8 relative), and such flips compound through
  the layers: 1e-3 relative (1.1e-4 seen);
- `count_group_fallbacks`, `dequantize_params`, `quantized_bytes`: exact;
- `quality.main` on a FAT5-named file: the same JSON keys as
  `bench_quality.main` on the same file, and its `ppl_fp` to 1e-2 relative
  (bf16 activations, rounded at other places in the two frameworks).
"""

import io
import json
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import bench_quality
from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.quantize import count_group_fallbacks as jax_fallbacks
from flasht5_tpu.quantize import dequantize_params as jax_dequantize
from flasht5_tpu.quantize import quantized_bytes as jax_bytes
from flasht5_tpu.quantize import quantize_params as jax_quantize
from flasht5_tpu_torch import quality, quantize
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import (params_from_numpy,
                                       params_to_fat5_state_dict,
                                       safetensors_file)
from flasht5_tpu_torch.models import t5

TINY = dict(vocab_size=256, d_model=64, d_kv=32, num_heads=2, d_ff=128,
            num_layers=2, dropout_rate=0.0, attention_scale=1.0,
            pad_token_id=0, dtype="float32")


@pytest.fixture(scope="module")
def tiny():
    jcfg = JaxConfig(**TINY)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.default_rng(0)
    batches = [(rng.integers(2, 256, (4, 32)).astype(np.int32),
                rng.integers(2, 256, (4, 16)).astype(np.int32))
               for _ in range(2)]
    return jcfg, jparams, FlashT5Config(**TINY), params, batches


@pytest.mark.parametrize("variant", [None] + [v[1:] for v in
                                              quality.VARIANTS],
                         ids=["fp"] + [v[0] for v in quality.VARIANTS])
def test_eval_ppl_matches_bench_quality(tiny, variant):
    jcfg, jparams, cfg, params, batches = tiny
    if variant is not None:
        fmt, group = variant
        jparams = jax_quantize(jparams, fmt, group)
        params = quantize.quantize_params(params, fmt, group)
    got = quality.eval_ppl(cfg, params, batches)
    want = bench_quality.eval_ppl(jcfg, jparams, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5 if variant is None
                               else 1e-3)


def test_eval_ppl_matches_bench_quality_at_d_768():
    """FAT5-flan-base's width (d 768, 12 heads of 64, d_ff 2048), cut to
    2 + 2 layers and a vocabulary of 256: on the card this width runs the
    fused lm_head+CE kernels in chunks of d; here their plain versions."""
    kw = dict(TINY, d_model=768, d_kv=64, num_heads=12, d_ff=2048)
    jcfg = JaxConfig(**kw)
    jparams = jt5.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    rng = np.random.default_rng(1)
    batches = [(rng.integers(2, 256, (2, 32)).astype(np.int32),
                rng.integers(2, 256, (2, 16)).astype(np.int32))]
    got = quality.eval_ppl(FlashT5Config(**kw), params, batches)
    want = bench_quality.eval_ppl(jcfg, jparams, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("group", [64, 48, 32])
def test_count_group_fallbacks_matches_jax(tiny, group):
    _, jparams, _, params, _ = tiny
    n = quantize.count_group_fallbacks(params, group)
    assert n == jax_fallbacks(jparams, group)
    assert (n > 0) == (group == 48)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dequantize_params_and_bytes_match_jax(tiny, fmt):
    """Exact: both dequantize the same stored values with the same f32
    scales, and count the same bytes."""
    _, jparams, _, params, _ = tiny
    jq = jax_quantize(jparams, fmt, 64)
    q = quantize.quantize_params(params, fmt, 64)
    assert quantize.quantized_bytes(params) == jax_bytes(jparams)
    assert quantize.quantized_bytes(q) == jax_bytes(jq)
    got = t5.tree_leaves_with_path(quantize.dequantize_params(q))
    want = jax.tree_util.tree_leaves_with_path(jax_dequantize(jq))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=path)


def test_main_on_a_checkpoint_prints_bench_quality_keys(tmp_path):
    """Checkpoint mode: config from the file's shapes (d_kv 64 and d_ff
    2048 are FlashT5Config's defaults, as `bench_quality.py` assumes)."""
    cfg = FlashT5Config(vocab_size=128, d_model=64, num_heads=2,
                        num_layers=1, dropout_rate=0.0)

    path = str(tmp_path / "tiny.safetensors")
    safetensors_file.save_file(
        params_to_fat5_state_dict(t5.init_params(cfg, seed=3,
                                                 device="cpu")), path)
    mine = quality.main([path, "--device", "cpu"])
    out = io.StringIO()
    argv = sys.argv
    try:
        sys.argv = ["bench_quality.py", path]
        with redirect_stdout(out):
            bench_quality.main()
    finally:
        sys.argv = argv
    theirs = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [sorted(m) for m in mine] == [sorted(t) for t in theirs]
    assert [m["metric"] for m in mine] == [t["metric"] for t in theirs]
    for m, t in zip(mine, theirs):
        np.testing.assert_allclose(m["ppl_fp"], t["ppl_fp"], rtol=1e-2)
        assert m.get("g64_fallbacks") == t.get("g64_fallbacks")
