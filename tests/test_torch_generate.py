"""The generation slice against the JAX package: the decode state and its
steps, greedy and sampled `generate`, the no-cache references, the
sampling filters and draw, beam search, speculative decoding, the slot
engine's sampling, and the original PyTorch FAT5 goldens' token streams.

Tiny models (2+2 layers, d_model 64, vocab 128, f32) with weights made by
the JAX package's `init_params` and carried across with
`params_from_numpy`; inputs from a numpy seed. The JAX side runs as its own
tests run it on the CPU (tests/conftest.py: Pallas in interpret mode,
matmuls at "highest" precision); the port runs on the CPU, the plain
version of each kernel.

Tolerances: logits to 1e-5 (both sides compute in f32 and differ only in
the order of their sums); beam scores to 1e-5 (sums of the same f32
log-probabilities); tokens exactly (the arg-max margins of these models and
inputs are far wider than 1e-5); the sampling filters exactly (the same
f32 operations on the same logits).
"""

import glob
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.convert.hf_import import state_dict_to_params
from flasht5_tpu.inference import beam_search as jbeam
from flasht5_tpu.inference import generate as jgenerate
from flasht5_tpu.inference import kv_cache as jkv
from flasht5_tpu.inference import sampling as jsampling
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.inference import (beam_generate, decode_step,
                                         decode_window_step, engine,
                                         generate, init_decode_state,
                                         sampling, speculative_generate)
from flasht5_tpu_torch.models import t5

generate_module = importlib.import_module("flasht5_tpu_torch.inference."
                                          "generate")
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BASE = dict(vocab_size=128, d_model=64, num_heads=4, d_ff=128, num_layers=2,
            num_decoder_layers=2, dropout_rate=0.0, dtype="float32",
            pad_token_id=0)
# d_kv 16 on the plain paths; d_kv 32 on the flagship's kernels (the
# card's single-query kernel takes d 32, 64 and 128)
CONFIGS = {
    "ref": dict(BASE, d_kv=16, attention_type="ref"),
    "rpe": dict(BASE, d_kv=32, attention_type="pallas_rpe",
                use_fused_layernorm=True),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    kw = CONFIGS[request.param]
    jcfg = JaxConfig(**kw)
    jparams = jt5.init_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    return jcfg, jparams, FlashT5Config(**kw), params


def _inputs(seed=0, b=3, n=12, vocab=128):
    rng = np.random.default_rng(seed)
    return rng.integers(2, vocab, size=(b, n)).astype(np.int32)


def _np(x):
    return np.array(jax.device_get(x))


# jitted: one compile, where op-by-op dispatch of the JAX steps costs
# seconds a step on the CPU
_jax_decode_step = jax.jit(jkv.decode_step, static_argnums=0)
_jax_window_step = jax.jit(jkv.decode_window_step, static_argnums=0)


# ---------------------------------------------------------------------------
# the decode state and its steps
# ---------------------------------------------------------------------------

def test_decode_step_matches_jax(model):
    """Six teacher-forced steps: each step's logits against JAX's
    `decode_step` on the same tokens (the port's Q = 1 route, the single-
    query kernel's plain version)."""
    jcfg, jparams, cfg, params = model
    ids = _inputs(1)
    enc_j = jt5.encode(jcfg, jparams, jnp.asarray(ids))
    enc = t5.encode(cfg, params, torch.from_numpy(ids))
    np.testing.assert_allclose(enc.numpy(), _np(enc_j), **LOGIT_TOL)
    st_j = jkv.init_decode_state(jcfg, jparams, enc_j, 8)
    st = init_decode_state(cfg, params, enc, 8)
    forced = np.random.default_rng(2).integers(0, 128, size=(6, 3))
    for step in range(6):
        tok = forced[step].astype(np.int32)
        lj, st_j = _jax_decode_step(jcfg, jparams, st_j, jnp.asarray(tok))
        lg, st = decode_step(cfg, params, st, torch.from_numpy(tok))
        assert st.t == int(st_j.t) == step + 1
        np.testing.assert_allclose(lg.numpy(), _np(lj), **LOGIT_TOL)


def test_decode_window_step_matches_jax(model):
    """Two single steps, then a window of Q = 3 (the plain-PyTorch route,
    causal within the window), then one more step that reads the window's
    cache rows: logits against JAX's `decode_window_step`."""
    jcfg, jparams, cfg, params = model
    ids = _inputs(3)
    enc_j = jt5.encode(jcfg, jparams, jnp.asarray(ids))
    enc = t5.encode(cfg, params, torch.from_numpy(ids))
    st_j = jkv.init_decode_state(jcfg, jparams, enc_j, 10)
    st = init_decode_state(cfg, params, enc, 10)
    toks = np.random.default_rng(4).integers(0, 128, size=(3, 6)).astype(
        np.int32)
    for lo, hi in ((0, 1), (1, 2), (2, 5), (5, 6)):
        lj, st_j = _jax_window_step(jcfg, jparams, st_j,
                                    jnp.asarray(toks[:, lo:hi]))
        lg, st = decode_window_step(cfg, params, st,
                                    torch.from_numpy(toks[:, lo:hi]))
        assert lg.shape == (3, hi - lo, 128) and st.t == hi
        np.testing.assert_allclose(lg.numpy(), _np(lj), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# greedy generation, with and without the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_length", [5, 12])
def test_generate_greedy_matches_jax(model, max_length):
    jcfg, jparams, cfg, params = model
    ids = _inputs(5)
    want = _np(jgenerate(jcfg, jparams, jnp.asarray(ids),
                         max_length=max_length))
    got = generate(cfg, params, torch.from_numpy(ids), max_length=max_length)
    assert got.shape == (3, max_length + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_matches_generate(model):
    """The no-cache reference loop against the KV-cached one (the pair
    tests/test_inference.py pins in the JAX package)."""
    _, _, cfg, params = model
    ids = torch.from_numpy(_inputs(6))
    np.testing.assert_array_equal(
        t5.greedy_generate(cfg, params, ids, max_length=10).numpy(),
        generate(cfg, params, ids, max_length=10).numpy())


def test_generate_stop_flag_read_every_few_steps(model, monkeypatch):
    """Reading the stop flag every step or every 8 gives the same tokens,
    with rows that end early (the EOS logit raised) and rows that run to
    the boundary."""
    _, _, cfg, params = model
    params = dict(params, lm_head=params["lm_head"].clone())
    params["lm_head"][:, cfg.eos_token_id] += 0.5
    ids = torch.from_numpy(_inputs(7, b=4))
    outs = []
    for k in (1, 3, 8):
        monkeypatch.setattr(generate_module, "SYNC_EVERY", k)
        outs.append(generate(cfg, params, ids, max_length=20))
    for out in outs[1:]:
        np.testing.assert_array_equal(out.numpy(), outs[0].numpy())
    ends = (outs[0] == cfg.eos_token_id).int().argmax(dim=-1)
    assert (ends < 20).any()


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,p", [(0, 1.0), (5, 1.0), (0, 0.9), (7, 0.5),
                                 (1, 0.3)])
def test_sampling_filters_and_draw_match_jax(k, p):
    """`apply_top_k` and `apply_top_p` exactly as JAX's on the same logits,
    and the draw fed `jax.random.gumbel(key, shape)` equal to
    `jax.random.categorical(key, ...)` on the same key, for 200 rows."""
    rng = np.random.default_rng(8)
    logits = (2.0 * rng.standard_normal((200, 64))).astype(np.float32)
    got = sampling.apply_top_p(sampling.apply_top_k(
        torch.from_numpy(logits), k), p)
    want = jsampling.apply_top_p(jsampling.apply_top_k(
        jnp.asarray(logits), k), p)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    key = jax.random.PRNGKey(11)
    noise = torch.from_numpy(_np(jax.random.gumbel(key, want.shape,
                                                   jnp.float32)))
    np.testing.assert_array_equal(
        sampling.draw(got, noise).numpy(),
        _np(jax.random.categorical(key, want, axis=-1)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sampling, "gumbel", lambda *args: noise)
        np.testing.assert_array_equal(
            sampling.sample_token(torch.from_numpy(logits), temperature=0.7,
                                  top_k=k, top_p=p).numpy(),
            _np(jsampling.sample_token(key, jnp.asarray(logits),
                                       temperature=0.7, top_k=k, top_p=p)))


def _jax_step_noise(seed, shape):
    """The Gumbel noise of each step of JAX's `generate` loop, step after
    step: the key split as the loop splits it, one `jax.random.gumbel` a
    step."""
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, sub = jax.random.split(rng)
        yield torch.from_numpy(_np(jax.random.gumbel(sub, shape,
                                                     jnp.float32)))


@pytest.mark.parametrize("kw", [dict(temperature=1.0),
                                dict(temperature=0.8, top_k=5),
                                dict(temperature=1.3, top_p=0.8),
                                dict(temperature=0.9, top_k=20, top_p=0.9)])
def test_generate_sampled_with_jax_noise_matches_jax(model, kw,
                                                     monkeypatch):
    """Sampled `generate` fed JAX's per-step noise draws JAX's tokens."""
    jcfg, jparams, cfg, params = model
    ids = _inputs(9)
    want = _np(jgenerate(jcfg, jparams, jnp.asarray(ids), max_length=10,
                         rng=jax.random.PRNGKey(4), **kw))
    noise = _jax_step_noise(4, (3, 128))
    monkeypatch.setattr(generate_module, "gumbel",
                        lambda *args: next(noise))
    got = generate(cfg, params, torch.from_numpy(ids), max_length=10, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_seeded(model):
    """One generator seed, one stream; top_k=1 is greedy; the no-cache
    `sample_generate` follows the same contract."""
    _, _, cfg, params = model
    ids = torch.from_numpy(_inputs(10))

    def sampled(seed, **kw):
        return generate(cfg, params, ids, max_length=10, temperature=1.0,
                        generator=torch.Generator().manual_seed(seed), **kw)
    np.testing.assert_array_equal(sampled(1).numpy(), sampled(1).numpy())
    np.testing.assert_array_equal(
        sampled(2, top_k=1).numpy(),
        generate(cfg, params, ids, max_length=10).numpy())
    out = t5.sample_generate(cfg, params, ids, max_length=10,
                             generator=torch.Generator().manual_seed(3),
                             temperature=1.0, top_k=5)
    assert out.shape == (3, 11) and (out[:, 0] == 0).all()
    assert ((out == cfg.eos_token_id).sum(dim=-1) == 1).all()


# ---------------------------------------------------------------------------
# beam search and speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beams,early", [(2, True), (4, True), (4, False)])
def test_beam_generate_matches_jax(model, beams, early):
    jcfg, jparams, cfg, params = model
    ids = _inputs(11, b=2)
    wt, ws = jbeam.beam_generate(jcfg, jparams, jnp.asarray(ids),
                                 num_beams=beams, max_length=9,
                                 early_stopping=early)
    gt, gs = beam_generate(cfg, params, torch.from_numpy(ids),
                           num_beams=beams, max_length=9,
                           early_stopping=early)
    np.testing.assert_array_equal(gt.numpy(), _np(wt))
    np.testing.assert_allclose(gs.numpy(), _np(ws), **LOGIT_TOL)


@pytest.mark.parametrize("window", [2, 4])
def test_speculative_generate_matches_greedy(model, window):
    """Token-exact against the port's greedy `generate`, with drafts from the
    input (few accepted) and from the greedy output itself (most accepted:
    windows that advance by several tokens)."""
    _, _, cfg, params = model
    ids = torch.from_numpy(_inputs(12))
    greedy = generate(cfg, params, ids, max_length=12)
    got, stats = speculative_generate(cfg, params, ids, max_length=12,
                                      window=window, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    assert stats["windows"] <= stats["generated"]
    # one row at a time: the batch advances at its least acceptance
    passes = []
    for r in range(ids.shape[0]):
        fed, fed_stats = speculative_generate(
            cfg, params, ids[r:r + 1], max_length=12, window=window,
            draft_source=greedy[r:r + 1], return_stats=True)
        np.testing.assert_array_equal(fed.numpy(), greedy[r:r + 1].numpy())
        passes.append(fed_stats["windows"] < fed_stats["generated"])
    assert any(passes)


# ---------------------------------------------------------------------------
# the slot engine's sampling
# ---------------------------------------------------------------------------

def _serve(cfg, params, **kw):
    eng = engine.InferenceEngine(
        cfg, params, engine.EngineConfig(
            max_slots=2, max_decode_len=10, max_encode_len=16,
            encode_buckets=(16,), steps_per_sync=3, **kw), device="cpu")
    reqs = [engine.Request(uid=i, input_ids=x, max_new_tokens=8)
            for i, x in enumerate(_inputs(13, b=3))]
    return [r.result.tolist() for r in eng.run(reqs)]


def test_engine_sampling_seeded(model):
    """Sampling in the slot engine: one seed serves one set of streams, each
    ending in EOS; top_k=1 serves the greedy engine's tokens."""
    _, _, cfg, params = model
    kw = dict(temperature=1.0, top_p=0.9, sample_seed=5)
    a, b = _serve(cfg, params, **kw), _serve(cfg, params, **kw)
    assert a == b
    assert all(r[-1] == cfg.eos_token_id and len(r) <= 8 for r in a)
    assert _serve(cfg, params, temperature=1.0, top_k=1) == _serve(cfg,
                                                                  params)


# ---------------------------------------------------------------------------
# the original PyTorch FAT5 goldens' generate() streams
# ---------------------------------------------------------------------------

GEN_GOLDENS = [p for p in sorted(glob.glob(os.path.join(
    os.path.dirname(__file__), "golden", "ref_t5_*.npz")))
    if "generated" in np.load(p).files]


@pytest.mark.parametrize("path", GEN_GOLDENS,
                         ids=[os.path.basename(p)[4:-4] for p in GEN_GOLDENS])
def test_golden_generate_streams_through_the_port(path):
    """The reference's greedy streams (`generated`) through the port's
    no-cache `greedy_generate` and its KV-cached `generate`, as
    tests/test_golden_reference.py reads them."""
    z = np.load(path)
    cfg_json = json.loads(bytes(z["config_json"]).decode())
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")
          and not k.endswith("embed_tokens.weight")}
    cfg = FlashT5Config.from_dict(dict(cfg_json, dtype="float32",
                                       param_dtype="float32"))
    params = params_from_numpy(
        _numpy_tree(state_dict_to_params(sd, dtype=jnp.float32)),
        device="cpu")
    ids = torch.from_numpy(z["input_ids"])
    mask = torch.from_numpy(z["attention_mask"])
    ref = z["generated"]
    n = int(z["generate_max_length"])
    for fn in (t5.greedy_generate, generate):
        mine = fn(cfg, params, ids, mask, max_length=n).numpy()
        width = max(mine.shape[1], ref.shape[1])
        np.testing.assert_array_equal(
            np.pad(mine, ((0, 0), (0, width - mine.shape[1]))),
            np.pad(ref, ((0, 0), (0, width - ref.shape[1]))))
