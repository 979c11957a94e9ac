"""The port's positional encodings against the JAX package's, and the five
original PyTorch FAT5 goldens of the encodings other than T5 through the
port alone.

- each function of `flasht5_tpu_torch/positional.py` against its JAX
  counterpart on seeded numpy inputs, explicit positions included;
- `ref_alibi_sym`, `ref_alibi_asym_heads6`, `ref_rope`,
  `ref_rope_frac_interleaved_xpos` and `ref_fire` imported by the port's
  own `convert.hf_import` (no JAX on the path) and run on `ref` and on
  `pallas` (the plain versions of the kernels), and `ref_rope`'s token
  stream through the reference's loop and through the KV-cached one;
- the T5 bias as `_BucketGather` and its table gradient against the old
  gather and `jax.grad`, with the backward's `t5_bias.grad` span;
- FIRE's 0-d leaves through the conversions and the optimizer;
- both engines refuse the encodings they do not serve.

Tolerances stand beside the assertions.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flasht5_tpu import positional as jpos
from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.optim import adamw_scale, no_decay_mask as jno_decay_mask
from flasht5_tpu_torch import positional
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import (params_from_numpy, params_to_numpy,
                                       safetensors_file)
from flasht5_tpu_torch.convert.hf_import import (load_fat5_safetensors,
                                                 params_to_fat5_state_dict,
                                                 state_dict_to_params)
from flasht5_tpu_torch.inference import engine, generate, paged_engine
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.optim import AdamWScale, no_decay_mask
from flasht5_tpu_torch.utils import profiling

# f32 functions computed by the same formulas in the same order; cos, sin,
# log and pow of the two libraries may differ by an ulp: 1e-6
FN_TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", [1, 4, 6, 8, 12, 16])
def test_alibi_slopes_match_jax(heads):
    np.testing.assert_array_equal(positional.alibi_slopes(heads),
                                  jpos.alibi_slopes(heads))


@pytest.mark.parametrize("mode", ["symetric", "asymetric"])
@pytest.mark.parametrize("explicit", [False, True])
def test_alibi_bias_matches_jax(mode, explicit):
    rng = np.random.default_rng(0)
    kw = {}
    if explicit:
        kw = dict(q_positions=np.sort(rng.choice(64, 7, replace=False)),
                  k_positions=np.sort(rng.choice(64, 9, replace=False)))
    want = jpos.alibi_bias(6, 7, 9, mode=mode, **{
        k: jnp.asarray(v) for k, v in kw.items()})
    got = positional.alibi_bias(6, 7, 9, mode=mode, **{
        k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (1, 6, 7, 9)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("scale_base", [None, 512.0])
@pytest.mark.parametrize("offset", [0, 5])
def test_rope_tables_match_jax(scale_base, offset):
    want = jpos.rope_cos_sin(40, 12, base=500.0, scale_base=scale_base,
                             offset=offset)
    got = positional.rope_cos_sin(40, 12, base=500.0, scale_base=scale_base,
                                  offset=offset)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(_np(g), np.asarray(w), **FN_TOL)
    pos = np.array([0, 3, 7, 20, 39])
    for g, w in zip(positional.gather_rope_tables(got, torch.from_numpy(pos)),
                    jpos.gather_rope_tables(want, jnp.asarray(pos))):
        if g is not None:
            np.testing.assert_allclose(_np(g), np.asarray(w), **FN_TOL)


@pytest.mark.parametrize("interleaved", [False, True])
@pytest.mark.parametrize("rotary_dim", [16, 8])
def test_apply_rotary_matches_jax(interleaved, rotary_dim):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 3, 16)).astype(np.float32)
    cos, sin, _, _ = jpos.rope_cos_sin(10, rotary_dim)
    want = jpos.apply_rotary(jnp.asarray(x), cos, sin,
                             interleaved=interleaved)
    got = positional.apply_rotary(
        torch.from_numpy(x), torch.from_numpy(np.array(cos)),
        torch.from_numpy(np.array(sin)), interleaved=interleaved)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FN_TOL)
    if rotary_dim < 16:      # the features past the rotary dim pass through
        np.testing.assert_array_equal(_np(got)[..., rotary_dim:],
                                      x[..., rotary_dim:])


def test_fire_init_and_bias_match_jax():
    """The port's init has JAX's shapes, dtypes and scalars (its draws are
    a torch generator's); on one set of parameters the bias is JAX's,
    and its rows at explicit query positions are the full square's."""
    jp = jpos.init_fire_params(jax.random.PRNGKey(0), 6, 32, init_L=128.0)
    p = positional.init_fire_params(torch.Generator().manual_seed(0), 6, 32,
                                    init_L=128.0)
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(params_to_numpy(p)))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree_util.tree_leaves(params_to_numpy(p))):
        assert a.shape == b.shape and b.dtype == np.float32, path
    assert float(p["c"]) == pytest.approx(0.1)
    assert float(p["init_L"]) == 128.0 and float(p["L_multiplier"]) == 1.0
    assert p["mlp"]["w1"].abs().max() <= 1.0
    assert p["mlp"]["w2"].abs().max() <= 32 ** -0.5
    # a threshold inside the sequence, and nonzero MLP biases
    rng = np.random.default_rng(2)
    tree = params_to_numpy(p)
    tree["init_L"] = np.asarray(20.0, np.float32)
    tree["mlp"]["b1"] = rng.standard_normal(32).astype(np.float32)
    tree["mlp"]["b2"] = rng.standard_normal(6).astype(np.float32)
    want = jpos.fire_bias(jax.tree_util.tree_map(jnp.asarray, tree), 48)
    mine = params_from_numpy(tree, device="cpu")
    got = positional.fire_bias(mine, 48)
    np.testing.assert_allclose(_np(got), np.asarray(want), **FN_TOL)
    rows = positional.fire_bias(mine, 48, q_positions=torch.arange(30, 33))
    np.testing.assert_array_equal(_np(rows), _np(got)[:, :, 30:33])


@pytest.mark.parametrize("bidirectional", [True, False])
def test_t5_bias_at_explicit_positions_matches_jax(bidirectional):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((32, 4)).astype(np.float32)
    q = np.sort(rng.choice(300, 9, replace=False))
    k = np.sort(rng.choice(300, 11, replace=False))
    want = jpos.t5_relative_bias(
        {"relative_attention_bias": jnp.asarray(table)}, 9, 11,
        bidirectional=bidirectional, q_positions=jnp.asarray(q),
        k_positions=jnp.asarray(k))
    got = positional.t5_relative_bias(
        {"relative_attention_bias": torch.from_numpy(table)}, 9, 11,
        bidirectional=bidirectional, q_positions=torch.from_numpy(q),
        k_positions=torch.from_numpy(k), max_len=300)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_t5_bias_at_explicit_positions_takes_one_table_for_every_draw():
    """The bucket table of explicit positions spans +-(max_len - 1),
    whatever the draw: two draws under one bound share it, and positions
    without a bound are refused."""
    table = {"relative_attention_bias": torch.randn((32, 4))}
    gen = torch.Generator().manual_seed(0)
    positional.bucket_lut.cache_clear()
    for _ in range(2):
        pos = positional._randomized_positions(gen, 16, 64)
        positional.t5_relative_bias(table, 16, 16, q_positions=pos,
                                    k_positions=pos, max_len=64)
    assert positional.bucket_lut.cache_info().currsize == 1
    with pytest.raises(ValueError, match="max_len"):
        positional.t5_relative_bias(table, 16, 16, q_positions=pos)


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["default", "explicit"])
@pytest.mark.parametrize("bidirectional", [True, False],
                         ids=["encoder", "decoder"])
def test_t5_bias_gather_and_its_gradient(bidirectional, explicit):
    """The bias as the gather of `_BucketGather` equals the old
    `table[lut[rel - lo]].permute(2, 0, 1)` bit for bit (and is
    contiguous); its table gradient matches `jax.grad` of the JAX
    package's function, M != N; a recorded backward opens one
    `t5_bias.grad` span, on the CPU's route "plain"."""
    rng = np.random.default_rng(11)
    m, n, heads, max_len = 24, 40, 4, 300
    table = rng.standard_normal((32, heads)).astype(np.float32)
    cot = rng.standard_normal((1, heads, m, n)).astype(np.float32)
    pos = {}
    if explicit:
        pos = dict(q_positions=np.sort(rng.choice(max_len, m, replace=False)),
                   k_positions=np.sort(rng.choice(max_len, n, replace=False)))

    t = torch.from_numpy(table).requires_grad_(True)
    bias = positional.t5_relative_bias(
        {"relative_attention_bias": t}, m, n, bidirectional=bidirectional,
        max_len=max_len, **{k: torch.from_numpy(v) for k, v in pos.items()})
    qp = torch.from_numpy(pos["q_positions"]) if explicit else \
        torch.arange(m)
    kp = torch.from_numpy(pos["k_positions"]) if explicit else \
        torch.arange(n)
    lo = -(max_len - 1) if explicit else -(m - 1)
    hi = max_len - 1 if explicit else n - 1
    lut = positional.bucket_lut(lo, hi, bidirectional=bidirectional,
                                num_buckets=32, max_distance=128,
                                device=torch.device("cpu"))
    old = torch.from_numpy(table)[
        lut[kp[None, :] - qp[:, None] - lo].long()].permute(2, 0, 1)[None]
    assert bias.is_contiguous()
    torch.testing.assert_close(bias.detach(), old, rtol=0, atol=0)

    with profiling.recording() as rec:
        (bias * torch.from_numpy(cot)).sum().backward()
    spans = [s for s in rec.spans if s.name == "t5_bias.grad"]
    assert [s.attrs for s in spans] == [
        {"route": "plain", "elements": heads * m * n, "buckets": 32}]

    def loss(w):
        b = jpos.t5_relative_bias(
            {"relative_attention_bias": w}, m, n,
            bidirectional=bidirectional,
            **{k: jnp.asarray(v) for k, v in pos.items()})
        return jnp.sum(b * jnp.asarray(cot))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    # f32 sums of the same terms in another order: 1e-5 relative, against
    # the largest entry for the entries whose terms nearly cancel
    np.testing.assert_allclose(_np(t.grad), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_randomized_positions_are_a_sorted_draw_from_zero():
    gen = torch.Generator().manual_seed(0)
    draws = [positional._randomized_positions(gen, 16, 64) for _ in range(3)]
    for pos in draws:
        assert pos.shape == (16,) and int(pos[0]) == 0
        assert bool((pos[1:] > pos[:-1]).all()) and int(pos.max()) < 64
    assert not torch.equal(draws[0], draws[1])
    again = positional._randomized_positions(
        torch.Generator().manual_seed(0), 16, 64)
    assert torch.equal(again, draws[0])
    # at the training length the draw is the identity
    full = positional._randomized_positions(gen, 64, 64)
    assert torch.equal(full, torch.arange(64))


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

PE_GOLDENS = [os.path.join(os.path.dirname(__file__), "golden", f"ref_{n}.npz")
              for n in ("alibi_sym", "alibi_asym_heads6", "rope",
                        "rope_frac_interleaved_xpos", "fire")]
PE_IDS = [os.path.basename(p)[4:-4] for p in PE_GOLDENS]


def _golden(path, attention):
    """(config, the port's params, arrays) of a golden: read as
    tests/test_golden_reference.py reads it, imported by the port."""
    z = np.load(path)
    cfg_json = json.loads(bytes(z["config_json"]).decode())
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")
          and not k.endswith("embed_tokens.weight")}
    cfg = FlashT5Config.from_dict(dict(cfg_json, dtype="float32",
                                       param_dtype="float32",
                                       attention_type=attention))
    return cfg, state_dict_to_params(sd, device="cpu"), z


# the tolerances of tests/test_golden_reference.py: ref 1e-4 on the hidden
# states and the logits, 2e-5 on the loss; the kernels' path 5e-4 and 1e-4
@pytest.mark.parametrize("attention", ["ref", "pallas"])
@pytest.mark.parametrize("path", PE_GOLDENS, ids=PE_IDS)
def test_pe_goldens_through_the_port(path, attention):
    cfg, params, z = _golden(path, attention)
    with torch.no_grad():
        out = t5.forward(cfg, params,
                         input_ids=torch.from_numpy(z["input_ids"]),
                         attention_mask=torch.from_numpy(z["attention_mask"]),
                         labels=torch.from_numpy(z["labels"]))
    tol, loss_tol = (1e-4, 2e-5) if attention == "ref" else (5e-4, 1e-4)
    if attention == "ref":
        np.testing.assert_allclose(_np(out["encoder_hidden_states"]),
                                   z["encoder_hidden_states"], atol=tol,
                                   rtol=tol)
    np.testing.assert_allclose(_np(out["logits"]), z["logits"], atol=tol,
                               rtol=tol)
    assert abs(float(out["loss"]) - float(z["loss"])) < loss_tol


@pytest.mark.parametrize("loop", ["reference", "kv_cache"])
def test_rope_golden_stream_through_the_port(loop):
    cfg, params, z = _golden(PE_GOLDENS[2], "ref")
    assert "generated" in z.files
    ids = torch.from_numpy(z["input_ids"])
    mask = torch.from_numpy(z["attention_mask"])
    n = int(z["generate_max_length"])
    if loop == "reference":
        mine = t5.greedy_generate(cfg, params, ids, mask, max_length=n)
    else:
        mine = generate(cfg, params, ids, mask, max_length=n)
    ref = z["generated"]
    width = max(mine.shape[1], ref.shape[1])

    def pad(a):
        return np.pad(np.asarray(a), ((0, 0), (0, width - a.shape[1])))

    np.testing.assert_array_equal(pad(mine.numpy()), pad(ref))


# ---------------------------------------------------------------------------
# FIRE's 0-d leaves: conversion and the optimizer
# ---------------------------------------------------------------------------

FIRE_TINY = dict(vocab_size=64, d_model=32, d_kv=16, num_heads=4, d_ff=64,
                 num_layers=1, num_decoder_layers=1, dropout_rate=0.0,
                 position_encoding_type="FIRE", dtype="float32")


def test_fire_leaves_convert_without_loss(tmp_path):
    cfg = FlashT5Config(**FIRE_TINY)
    params = t5.init_params(cfg, seed=0, device="cpu")
    pe = params["encoder"]["block"][0]["self_attention_layer"][
        "self_attention"]["pe_encoding"]
    assert pe["c"].dim() == pe["init_L"].dim() == pe["L_multiplier"].dim() == 0
    leaves = t5.tree_leaves_with_path(params)
    back = t5.tree_leaves_with_path(params_from_numpy(
        params_to_numpy(params), device="cpu"))
    file = str(tmp_path / "fire.safetensors")
    safetensors_file.save_file(params_to_fat5_state_dict(params), file)
    loaded = t5.tree_leaves_with_path(load_fat5_safetensors(file,
                                                            device="cpu"))
    for other in (back, loaded):
        assert [p for p, _ in other] == [p for p, _ in leaves]
        for (path, a), (_, b) in zip(leaves, other):
            assert a.shape == b.shape and torch.equal(a, b), path


def test_fire_leaves_take_the_optimizer_step_of_jax():
    """The 0-d scalars take the RMS-scaled step (rms = |p|) and the same
    decay rule by path as the JAX package's `adamw_scale`: three steps on
    one tree and one set of gradients, to 1e-5 (the same f32 arithmetic in
    another association)."""
    jcfg = JaxConfig(**FIRE_TINY)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    named = t5.tree_leaves_with_path(params)
    decay = no_decay_mask(path for path, _ in named)
    assert decay == jax.tree_util.tree_leaves(jno_decay_mask(jparams))
    assert any("['init_L']" in p for p, _ in named)
    tx = adamw_scale(1e-2, weight_decay=0.1, mask=jno_decay_mask)
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    opt = AdamWScale(
        [{"params": [p for (_, p), d in zip(named, decay) if d]},
         {"params": [p for (_, p), d in zip(named, decay) if not d],
          "weight_decay": 0.0}], lr=1e-2, weight_decay=0.1)
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            jparams)
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, p), g in zip(named, jax.tree_util.tree_leaves(grads)):
            p.grad = torch.from_numpy(np.array(g))
        opt.step()
    for (path, p), w in zip(named, jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(_np(p), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# the engines serve the T5 bias only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pe", ["ALiBi", "RoPE", "FIRE"])
def test_engines_refuse_other_encodings(pe):
    cfg = FlashT5Config(**dict(FIRE_TINY, position_encoding_type=pe))
    t5.check_supported(cfg)
    params = t5.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match=pe):
        engine.InferenceEngine(cfg, params, engine.EngineConfig(),
                               device="cpu")
    with pytest.raises(NotImplementedError, match=pe):
        paged_engine.PagedInferenceEngine(
            cfg, params, paged_engine.PagedEngineConfig(), device="cpu")
