"""The port's task heads and classification fine-tuning against the JAX
package's (`flasht5_tpu/models/heads.py`, `examples/finetune_classification.py`).

The same numpy weights (the JAX initializers' draws, carried across by
`params_from_numpy`) and the same numpy inputs go through both packages:
each head's logits, loss and every gradient leaf (`jax.value_and_grad`
against autograd), on `ref` attention, and once on `pallas_rpe` with the
fused `rms_norm` (the JAX kernels in interpret mode, the port's plain
versions on the CPU). Then three steps of the port's fine-tuning step
function against the JAX example's step (AdamWScale, weight decay 0.01 on
`no_decay_mask`): the loss and every parameter after each.

Tolerances: f32 on both sides, the same arithmetic in another summation
order: 1e-5 relative and absolute on losses and logits (values up to
~15 from sums over d_model), 1e-4 on gradients (as
tests/test_torch_pallas_model.py), and on the parameters after each
fine-tuning step 1e-5 relative with 1e-6 absolute (as
tests/test_torch_train.py holds AdamWScale's steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import heads as jheads
from flasht5_tpu.optim import adamw_scale, no_decay_mask as jax_no_decay
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.models import heads, t5
from flasht5_tpu_torch.train import finetune_classification as ft

TINY = dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4, d_ff=64,
            num_layers=2, dropout_rate=0.0, attention_scale=1.0,
            pad_token_id=0, dtype="float32")
RTOL = dict(rtol=1e-5, atol=1e-6)
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 3, 12


def _configs(**kw):
    d = dict(TINY, **kw)
    return JaxConfig(**d), FlashT5Config(**d)


def _ids(seed=0):
    """Row 0 holds two EOS (the last is pooled), row 1 one, row 2 none
    (its last position is pooled)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, TINY["vocab_size"], size=(B, S)).astype(np.int32)
    ids[0, 4] = ids[0, 9] = 1
    ids[1, S - 1] = 1
    return ids


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _compare(jax_fn, port_fn, jparams, out_keys):
    """Outputs and gradients of `loss` of both sides (JAX jitted)."""
    def loss_fn(p):
        out = jax_fn(p)
        return out["loss"], out
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    leaves = t5.tree_leaves_with_path(params)
    for _, p in leaves:
        p.requires_grad_(True)
    out = port_fn(params)
    out["loss"].backward()
    for key in out_keys + ["loss"]:
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(out_j[key]), **OUT_TOL,
                                   err_msg=key)
    want = jax.tree_util.tree_leaves_with_path(grads_j)
    assert [p for p, _ in leaves] == [jax.tree_util.keystr(p)
                                      for p, _ in want]
    for (path, p), (_, w) in zip(leaves, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                   **GRAD_TOL, err_msg=path)
    return out


def test_token_classification_matches_jax():
    jcfg, cfg = _configs()
    jparams = jheads.init_token_classification_params(
        jax.random.PRNGKey(0), jcfg, 5)
    ids = _ids()
    labels = np.random.default_rng(1).integers(0, 5, (B, S)).astype(np.int32)
    labels[2, 3:7] = -100
    _compare(lambda p: jheads.token_classification_forward(
                 jcfg, p, jnp.asarray(ids), labels=jnp.asarray(labels)),
             lambda p: heads.token_classification_forward(
                 cfg, p, torch.from_numpy(ids),
                 labels=torch.from_numpy(labels)),
             jparams, ["logits"])


@pytest.mark.parametrize("problem", ["regression",
                                     "single_label_classification",
                                     "multi_label_classification"])
def test_sequence_classification_matches_jax(problem):
    """Every problem type, each inferred from the labels (no
    `problem_type` given) as the JAX package infers it."""
    jcfg, cfg = _configs()
    nl = 1 if problem == "regression" else 3
    jparams = jheads.init_sequence_classification_params(
        jax.random.PRNGKey(0), jcfg, nl)
    ids = _ids()
    rng = np.random.default_rng(2)
    labels = {"regression": rng.standard_normal((B, 1)).astype(np.float32),
              "single_label_classification":
                  rng.integers(0, nl, (B,)).astype(np.int32),
              "multi_label_classification":
                  (rng.random((B, nl)) > 0.5).astype(np.float32)}[problem]
    assert heads.infer_problem_type(nl, torch.from_numpy(labels)) == problem
    _compare(lambda p: jheads.sequence_classification_forward(
                 jcfg, p, jnp.asarray(ids), labels=jnp.asarray(labels),
                 num_labels=nl),
             lambda p: heads.sequence_classification_forward(
                 cfg, p, torch.from_numpy(ids),
                 labels=torch.from_numpy(labels), num_labels=nl),
             jparams, ["logits"])


def test_question_answering_matches_jax():
    """Start and end positions with one outside the sequence on each side
    (ignored) and one at the last position."""
    jcfg, cfg = _configs()
    jparams = jheads.init_question_answering_params(jax.random.PRNGKey(0),
                                                    jcfg)
    ids = _ids()
    sp = np.array([2, S + 5, S - 1], np.int32)
    ep = np.array([-3, 7, S], np.int32)
    _compare(lambda p: jheads.question_answering_forward(
                 jcfg, p, jnp.asarray(ids), start_positions=jnp.asarray(sp),
                 end_positions=jnp.asarray(ep)),
             lambda p: heads.question_answering_forward(
                 cfg, p, torch.from_numpy(ids),
                 start_positions=torch.from_numpy(sp),
                 end_positions=torch.from_numpy(ep)),
             jparams, ["start_logits", "end_logits"])


def test_sequence_classification_on_pallas_rpe_matches_jax():
    """The trunk on `pallas_rpe` with the fused `rms_norm`: the JAX kernels
    in interpret mode against the port's plain versions, one layer."""
    jcfg, cfg = _configs(attention_type="pallas_rpe",
                         use_fused_layernorm=True, num_layers=1)
    jparams = jheads.init_sequence_classification_params(
        jax.random.PRNGKey(3), jcfg, 2)
    ids = _ids(4)
    labels = np.array([1, 0, 1], np.int32)
    _compare(lambda p: jheads.sequence_classification_forward(
                 jcfg, p, jnp.asarray(ids), labels=jnp.asarray(labels)),
             lambda p: heads.sequence_classification_forward(
                 cfg, p, torch.from_numpy(ids),
                 labels=torch.from_numpy(labels)),
             jparams, ["logits"])


def test_pooling_takes_each_rows_last_eos():
    ids = torch.from_numpy(_ids())
    assert heads.last_eos_positions(ids, 1).tolist() == [9, S - 1, S - 1]
    _, cfg = _configs()
    params = heads.init_sequence_classification_params(cfg, 2, seed=0,
                                                       device="cpu")
    h = t5.encode(cfg, params, ids)
    want = heads._classification_head(
        params["classification_head"], h[torch.arange(B), [9, S - 1, S - 1]],
        dropout=0.0, generator=None, deterministic=True)
    got = heads.sequence_classification_forward(cfg, params, ids)["logits"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    first = heads._classification_head(
        params["classification_head"], h[torch.arange(B), [4, S - 1, S - 1]],
        dropout=0.0, generator=None, deterministic=True)
    assert (got[0] - first[0]).abs().max() > 1e-4


def test_problem_type_inference_and_refusal():
    assert heads.infer_problem_type(1, torch.zeros(2, dtype=torch.long)) \
        == "regression"
    assert heads.infer_problem_type(3, torch.zeros(2, dtype=torch.int32)) \
        == "single_label_classification"
    assert heads.infer_problem_type(3, torch.zeros(2, 3)) \
        == "multi_label_classification"
    _, cfg = _configs(num_layers=1)
    params = heads.init_sequence_classification_params(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown problem_type"):
        heads.sequence_classification_forward(
            cfg, params, torch.from_numpy(_ids()),
            labels=torch.zeros(B, dtype=torch.long), problem_type="ranking")


def test_encoder_params_and_dropout_draw_from_their_seeds():
    _, cfg = _configs(num_layers=1)
    p = t5.init_encoder_params(cfg, seed=5, device="cpu")
    assert set(p) == {"shared", "encoder"}
    again = t5.init_encoder_params(cfg, seed=5, device="cpu")
    for (path, a), (_, b) in zip(t5.tree_leaves_with_path(p),
                                 t5.tree_leaves_with_path(again)):
        assert torch.equal(a, b), path
    params = heads.init_token_classification_params(cfg, 4, device="cpu")
    ids = torch.from_numpy(_ids())

    def run(seed):
        return heads.token_classification_forward(
            cfg, params, ids, classifier_dropout=0.5,
            generator=torch.Generator().manual_seed(seed),
            deterministic=False)["logits"]
    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))


def test_finetune_steps_match_the_jax_example():
    """Three steps of `train_step` on the demo's toy batches against the
    JAX example's jitted step, from the same trunk and head."""
    lr, num_labels = 1e-3, 2
    cfg = ft.demo_config()
    jcfg = JaxConfig(**{f: getattr(cfg, f) for f in (
        "vocab_size", "d_model", "d_kv", "num_heads", "d_ff", "num_layers",
        "dropout_rate", "attention_scale", "pad_token_id", "dtype")})
    jparams = jheads.init_sequence_classification_params(
        jax.random.PRNGKey(1), jcfg, num_labels)
    tx = adamw_scale(lr, weight_decay=0.01, mask=jax_no_decay)
    opt = tx.init(jparams)

    @jax.jit
    def step(params, opt, ids, y):
        def loss_fn(p):
            out = jheads.sequence_classification_forward(
                jcfg, p, ids, labels=y,
                problem_type="single_label_classification",
                num_labels=num_labels)
            return out["loss"], out["logits"]
        (loss, logits), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt, loss

    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    optimizer = ft.make_optimizer(params, lr)
    pool = ft.toy_pool(cfg)
    for i in range(3):
        ids, y = pool[i]
        jparams, opt, loss_j = step(jparams, opt, jnp.asarray(ids),
                                    jnp.asarray(y))
        loss, acc = ft.train_step(cfg, params, optimizer,
                                  torch.from_numpy(ids),
                                  torch.from_numpy(y), num_labels)
        assert 0.0 <= float(acc) <= 1.0
        np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
        want = jax.tree_util.tree_leaves_with_path(jparams)
        for (path, p), (_, w) in zip(t5.tree_leaves_with_path(params), want):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       **RTOL, err_msg=f"step {i} {path}")


def test_finetune_entry_point_on_an_exported_trunk(tmp_path, capsys):
    """The entry point on a trunk the port's exporter wrote: the trunk's
    shapes give the configuration, `validate_params` takes the
    encoder-only tree, and the loop prints its steps."""
    from flasht5_tpu_torch.convert import (load_fat5_safetensors,
                                           params_to_fat5_state_dict,
                                           safetensors_file, validate_params)
    cfg = FlashT5Config(vocab_size=96, d_model=128, d_kv=64, num_heads=2,
                        d_ff=96, num_layers=1, dtype="float32")
    path = str(tmp_path / "trunk.safetensors")
    safetensors_file.save_file(params_to_fat5_state_dict(
        t5.init_encoder_params(cfg, seed=2, device="cpu")), path)
    trunk = load_fat5_safetensors(path, device="cpu")
    assert set(trunk) == {"shared", "encoder"}
    got = ft.config_for_trunk(trunk)
    assert (got.vocab_size, got.d_model, got.num_layers, got.num_heads,
            got.d_ff) == (96, 128, 1, 2, 96)
    validate_params(trunk, got)
    with pytest.raises(ValueError):
        validate_params(trunk, got.replace(num_layers=2))
    logged = ft.main([path, "--steps", "2", "--device", "cpu"])
    assert [i for i, _, _ in logged] == [0, 1]
    assert all(np.isfinite(loss) for _, loss, _ in logged)
    assert "step 1: loss" in capsys.readouterr().out
