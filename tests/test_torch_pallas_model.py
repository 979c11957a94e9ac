"""The `pallas` model through the port against the JAX package: the loss
and the gradient of every parameter, with and without `use_masking`, and
`use_masking` on `ref` and `pallas_rpe`.

Weights are made by the JAX package and carried across with
`params_from_numpy`; the batch comes from a numpy seed, its second row
padded (`attention_mask` False there). The JAX side runs its Pallas kernels
in interpret mode (tests/conftest.py), the port runs on the CPU (the plain
versions of its kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.models import t5

TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            pad_token_id=0, z_loss=1e-4, dtype="float32",
            use_fused_layernorm=True, use_fused_crossentropy=True)
MASKING = dict(use_masking=True, use_full_bias_size=True)
# one encoder and one decoder block where a case only needs the attention
# path once: the JAX side's interpret-mode kernels dominate the file's time
ONE_LAYER = dict(num_layers=1, num_decoder_layers=1)

# `pallas` keeps two blocks a side: block 1 reuses block 0's bias, so the
# bucket table's gradient is the sum of both blocks' dbias
MODEL_CASES = {
    "pallas": dict(attention_type="pallas"),
    "pallas_masking": dict(attention_type="pallas", **MASKING, **ONE_LAYER),
    "ref_masking": dict(attention_type="ref", **MASKING, **ONE_LAYER),
    "pallas_rpe_masking": dict(attention_type="pallas_rpe", **MASKING,
                               **ONE_LAYER),
}


def _configs(**kw):
    d = dict(TINY, **kw)
    return JaxConfig(**d), FlashT5Config(**d)


def _batch(seed, b=2, enc=24, dec=16, vocab=256):
    """Random ids with the second row padded from position 17 on (pad 0,
    attention_mask False there) and the last labels ignored."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(b, enc)).astype(np.int32)
    mask = np.ones((b, enc), bool)
    mask[1, 17:] = False
    ids[~mask] = 0
    labels = rng.integers(2, vocab, size=(b, dec)).astype(np.int32)
    labels[:, -3:] = -100
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_loss_and_grads(cfg, params, batch):
    leaves = t5.tree_leaves_with_path(params)
    for _, p in leaves:
        p.requires_grad_(True)
    loss = t5.forward(cfg, params, **{k: torch.from_numpy(v)
                                      for k, v in batch.items()})["loss"]
    loss.backward()
    return float(loss.detach()), [(path, p.grad.numpy())
                                  for path, p in leaves]


# f32 on both sides, the same arithmetic in another summation order, through
# two encoder and two decoder layers: 1e-5 on the loss, 1e-4 on every
# gradient leaf (as tests/test_torch_train.py holds the other paths).
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_loss_and_gradients_match_jax(case):
    jcfg, cfg = _configs(**MODEL_CASES[case])
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(1)

    def loss_fn(p):
        return jt5.forward(jcfg, p, **{k: jnp.asarray(v)
                                       for k, v in batch.items()})["loss"]

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    loss, grads = _port_loss_and_grads(cfg, params, batch)
    np.testing.assert_allclose(loss, float(loss_j), rtol=1e-5)
    want = jax.tree_util.tree_leaves_with_path(grads_j)
    assert [p for p, _ in grads] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(grads, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=path)
    if case == "pallas_rpe_masking":
        # the difference ROADMAP Queue 3 records: the post-kernel select
        # zeroes the masked rows' q/k gradient that `ref` propagates
        ref_params = params_from_numpy(_numpy_tree(jparams), device="cpu")
        _, ref_grads = _port_loss_and_grads(
            cfg.replace(attention_type="ref"), ref_params, batch)
        wq = [i for i, (p, _) in enumerate(grads)
              if p.startswith("['encoder']['block'][0]") and "Wq" in p][0]
        assert np.abs(grads[wq][1] - ref_grads[wq][1]).max() > 1e-8


