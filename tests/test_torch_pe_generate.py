"""KV-cached generation with ALiBi, RoPE and FIRE: the port's greedy tokens
against the JAX package's `generate`, its decode steps against its own
forward, and its verify windows (Q > 1) against its single-token steps.

Tiny f32 models (2+2 layers, d_model 32, vocab 64) whose weights the JAX
package's `init_params` makes and `params_from_numpy` carries across;
inputs from a numpy seed. The JAX side runs on `ref`, the port on the CPU
(the plain version of each kernel). Tokens are held exactly (the arg-max
margins of these models and inputs are far wider than the f32 differences
of the two sides); logits to 1e-5 (the same f32 arithmetic summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.inference.generate import generate as jax_generate
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.inference import (decode_step, generate,
                                         init_decode_state,
                                         speculative_generate)
from flasht5_tpu_torch.models import t5

TINY = dict(vocab_size=64, d_model=32, d_kv=16, num_heads=4, d_ff=64,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            pad_token_id=0, dtype="float32", max_sequence_length=64)
ENCODINGS = {
    "alibi_asym_h6": dict(position_encoding_type="ALiBi",
                          alibi_mode="asymetric", num_heads=6),
    "rope_frac_inter_xpos": dict(position_encoding_type="RoPE",
                                 rotary_emb_fraction=0.5,
                                 rotary_interleaved=True,
                                 rotary_scale_base=32.0),
    "fire": dict(position_encoding_type="FIRE"),
}
MAX_LENGTH = 10


@pytest.fixture(scope="module", params=sorted(ENCODINGS))
def model(request):
    kw = dict(TINY, **ENCODINGS[request.param])
    jcfg = JaxConfig(**kw)
    jparams = jt5.init_params(jax.random.PRNGKey(5), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    ids = np.random.default_rng(0).integers(2, 64, size=(3, 12)).astype(
        np.int32)
    return jcfg, jparams, FlashT5Config(**kw), params, ids


def test_greedy_tokens_match_jax(model):
    jcfg, jparams, cfg, params, ids = model
    want = np.asarray(jax_generate(jcfg, jparams, jnp.asarray(ids),
                                   max_length=MAX_LENGTH))
    got = generate(cfg, params, torch.from_numpy(ids), max_length=MAX_LENGTH)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the reference's own loop, the decoder rerun over the prefix
    np.testing.assert_array_equal(
        t5.greedy_generate(cfg, params, torch.from_numpy(ids),
                           max_length=MAX_LENGTH).numpy(), want)


def test_decode_steps_match_the_forward(model):
    """Each decode step's logits are the no-cache forward's at that
    position: the bias rows (ALiBi's -inf clamped, FIRE's rows t..t) and
    the rotations at position t."""
    *_, cfg, params, ids = model
    ids_t = torch.from_numpy(ids)
    dec = torch.from_numpy(np.random.default_rng(1).integers(
        2, 64, size=(3, 6)))
    with torch.no_grad():
        full = t5.forward(cfg, params, input_ids=ids_t,
                          decoder_input_ids=dec)
        state = init_decode_state(cfg, params, full["encoder_hidden_states"],
                                  8)
        for t in range(dec.shape[1]):
            logits, state = decode_step(cfg, params, state, dec[:, t])
            torch.testing.assert_close(logits, full["logits"][:, t],
                                       rtol=1e-5, atol=1e-5)


def test_verify_windows_match_greedy(model):
    """Speculative decoding with windows of 4 (`decode_window_step` at
    Q = 4: the bias rows of four positions, four rotations) gives the
    greedy tokens."""
    *_, cfg, params, ids = model
    ids_t = torch.from_numpy(ids)
    np.testing.assert_array_equal(
        speculative_generate(cfg, params, ids_t, max_length=MAX_LENGTH,
                             window=4).numpy(),
        generate(cfg, params, ids_t, max_length=MAX_LENGTH).numpy())


def test_int8_weights_generate_as_the_reference_loop(model):
    """With int8 weights (`quantize_params`; FIRE's leaves stay f32) the
    KV-cached tokens are those of the reference's own loop on the same
    weights."""
    from flasht5_tpu_torch.quantize import quantize_params
    *_, cfg, params, ids = model
    qparams = quantize_params(params, "int8")
    ids_t = torch.from_numpy(ids)
    np.testing.assert_array_equal(
        generate(cfg, qparams, ids_t, max_length=MAX_LENGTH).numpy(),
        t5.greedy_generate(cfg, qparams, ids_t,
                           max_length=MAX_LENGTH).numpy())
