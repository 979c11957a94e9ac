"""Training with ALiBi, RoPE and FIRE, randomized positions, attention
dropout and gradient accumulation: the port against the JAX package.

Tiny f32 models (2+2 layers, d_model 32, vocab 64; 1+1 layers where the
JAX trainer's compile dominates) whose weights the JAX package's
`init_params` makes and `params_from_numpy` carries across; batches from
numpy seeds. The JAX side runs only on `ref` (no Pallas
interpret mode); the port runs on the CPU, on `ref` and on `pallas` (the
plain versions of its kernels). Tolerances stand beside the assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flasht5_tpu.positional as jpositional
from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.train import Trainer as JaxTrainer
from flasht5_tpu.train import TrainerConfig as JaxTrainerConfig
from flasht5_tpu_torch import positional
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy, params_to_numpy
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.ops.attn_ref import attn_ref
from flasht5_tpu_torch.train import Trainer, TrainerConfig

TINY = dict(vocab_size=64, d_model=32, d_kv=16, num_heads=4, d_ff=64,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            pad_token_id=0, z_loss=1e-4, dtype="float32",
            max_sequence_length=64)
ENCODINGS = {
    "alibi": dict(position_encoding_type="ALiBi"),
    "alibi_asym_h6": dict(position_encoding_type="ALiBi",
                          alibi_mode="asymetric", num_heads=6),
    "rope": dict(position_encoding_type="RoPE"),
    "rope_frac_inter_xpos": dict(position_encoding_type="RoPE",
                                 rotary_emb_fraction=0.5,
                                 rotary_interleaved=True,
                                 rotary_scale_base=32.0),
    "fire": dict(position_encoding_type="FIRE"),
}
# the trainer parities: one encoder and one decoder block (block 0 builds
# the bias and the loop threads it; the two-block threading is held on the
# kernels' path below)
ONE_LAYER = dict(num_layers=1, num_decoder_layers=1)
TRAIN = dict(learning_rate=5e-3, max_steps=3, warmup_steps=1,
             lr_scheduler="cosine", gradient_clip_norm=1.0,
             weight_decay=0.01, logging_steps=1)


def _configs(**kw):
    d = dict(TINY, **kw)
    return JaxConfig(**d), FlashT5Config(**d)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, b=2, enc=20, dec=12, vocab=64):
    rng = np.random.default_rng(seed)
    labels = rng.integers(2, vocab, size=(b, dec)).astype(np.int32)
    labels[:, -2:] = -100
    return {"input_ids": rng.integers(2, vocab, size=(b, enc)).astype(
        np.int32), "labels": labels}


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _jax_grads(jcfg, jparams, batch, rng=None):
    def loss_fn(p):
        return jt5.forward(jcfg, p, input_ids=jnp.asarray(batch["input_ids"]),
                           labels=jnp.asarray(batch["labels"]), rng=rng,
                           deterministic=rng is None)["loss"]
    return jax.jit(jax.value_and_grad(loss_fn))(jparams)


def _port_grads(cfg, params, batch, generator=None):
    leaves = t5.tree_leaves_with_path(params)
    for _, p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = t5.forward(cfg, params,
                      input_ids=torch.from_numpy(batch["input_ids"]),
                      labels=torch.from_numpy(batch["labels"]),
                      generator=generator,
                      deterministic=generator is None)["loss"]
    loss.backward()
    return float(loss.detach()), [(path, p.grad.numpy())
                                  for path, p in leaves]


def _assert_grads(got, grads_j, rtol, atol):
    want = jax.tree_util.tree_leaves_with_path(grads_j)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        _close(g, w, rtol, atol, path)


# ---------------------------------------------------------------------------
# three trainer steps per encoding on `ref`, and the kernels' path
# ---------------------------------------------------------------------------

# f32 on both sides, the same arithmetic summed in another order, through
# two layers, three AdamWScale updates and the clip (which the 1.0 limit
# triggers): 1e-5 on the losses, 1e-4 on the gradient norms and the params
@pytest.mark.parametrize("pe", ["alibi_asym_h6", "rope_frac_inter_xpos",
                                "fire"])
def test_trainer_steps_match_jax(pe):
    jcfg, cfg = _configs(**ENCODINGS[pe], **ONE_LAYER)
    jparams = jt5.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    batches = [_batch(10 + i) for i in range(3)]
    jtr = JaxTrainer(jcfg, JaxTrainerConfig(**TRAIN), params=jparams)
    jres = jtr.train(iter(batches))
    tr = Trainer(cfg, TrainerConfig(**TRAIN), params=params, device="cpu")
    res = tr.train(iter(batches))
    assert res["final_step"] == jres["final_step"] == 3
    for got, want in zip(res["logs"], jres["logs"]):
        _close(got["loss"], want["loss"], 1e-5, 0, "loss")
        _close(got["grad_norm"], want["grad_norm"], 1e-4, 0, "grad_norm")
    got = t5.tree_leaves_with_path(params_to_numpy(tr.params))
    _assert_grads(got, jax.device_get(jtr.params), 1e-4, 1e-5)


# the port's `pallas` path runs the plain versions of the bias kernels
# (ALiBi's -inf clamped at -1e29, FIRE's dbias into its MLP) and of the
# kernels without a bias (RoPE), in f32: 1e-4 on the loss, the logits and
# every gradient leaf, FIRE's MLP and scalars included (plain RoPE's
# gradients: the accumulation test below)
@pytest.mark.parametrize("pe", ["alibi", "alibi_asym_h6",
                                "rope_frac_inter_xpos", "fire"])
def test_pallas_loss_and_gradients_match_jax_ref(pe):
    jcfg, cfg = _configs(**ENCODINGS[pe])
    jparams = jt5.init_params(jax.random.PRNGKey(2), jcfg)
    batch = _batch(3)
    loss_j, grads_j = _jax_grads(jcfg, jparams, batch)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    loss, got = _port_grads(cfg.replace(attention_type="pallas"), params,
                            batch)
    _close(loss, loss_j, 1e-5, 0)
    _assert_grads(got, grads_j, 1e-4, 1e-4)
    if pe == "fire":
        assert any("['init_L']" in p and abs(g) > 0 for p, g in got)


# ---------------------------------------------------------------------------
# randomized positions
# ---------------------------------------------------------------------------

def _every_third(_, length, max_length):
    """One deterministic draw that is not the identity: 0, 3, 6, ..."""
    assert 3 * (length - 1) < max_length
    return np.arange(length) * 3


@pytest.fixture
def every_third(monkeypatch):
    monkeypatch.setattr(jpositional, "_randomized_positions",
                        lambda r, n, m: jnp.asarray(_every_third(r, n, m)))
    monkeypatch.setattr(positional, "_randomized_positions",
                        lambda g, n, m: torch.from_numpy(
                            _every_third(g, n, m)))


# with both packages' draw patched to 0, 3, 6, ...: the T5 and ALiBi bias
# at those positions (drawn once at block 0), RoPE's tables gathered at them
# in every layer, FIRE on its plain positions (both packages ignore the
# draw); the training loss and gradients against JAX's forward with an rng,
# f32: 1e-5 on the loss, 1e-4 on the gradients. The draw moves the loss
# away from the port's plain forward, except FIRE's.
@pytest.mark.parametrize("case", ["alibi-pallas", "alibi_asym_h6-ref",
                                  "rope_frac_inter_xpos-pallas",
                                  "fire-pallas"])
def test_randomized_positions_match_jax(every_third, case):
    pe, attention = case.split("-")
    jcfg, cfg = _configs(use_randomized_position_encoding=True,
                         **ENCODINGS[pe])
    cfg = cfg.replace(attention_type=attention)
    jparams = jt5.init_params(jax.random.PRNGKey(4), jcfg)
    batch = _batch(5)
    loss_j, grads_j = _jax_grads(jcfg, jparams, batch,
                                 rng=jax.random.PRNGKey(0))
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    loss, got = _port_grads(cfg, params, batch, generator=torch.Generator())
    _close(loss, loss_j, 1e-5, 0)
    _assert_grads(got, grads_j, 1e-4, 1e-4)
    with torch.no_grad():
        plain = float(t5.forward(
            cfg, params, input_ids=torch.from_numpy(batch["input_ids"]),
            labels=torch.from_numpy(batch["labels"]))["loss"])
    if pe == "fire":
        _close(loss, plain, 1e-6, 0)
    else:
        assert abs(loss - plain) > 1e-4


def test_randomized_positions_draw_from_the_trainer_generator():
    """Unpatched, the port's training forward draws new positions each
    step from the trainer's generator: two trainers of one seed give one
    loss, a forward without a generator another."""
    _, cfg = _configs(use_randomized_position_encoding=True,
                      **ENCODINGS["alibi"])
    batch = _batch(6)
    losses = []
    for _ in range(2):
        tr = Trainer(cfg, TrainerConfig(**dict(TRAIN, max_steps=1)),
                     device="cpu")
        losses.append(tr.train(iter([batch]))["logs"][0]["loss"])
    assert losses[0] == losses[1]
    params = t5.init_params(cfg, seed=0, device="cpu")
    plain = float(t5.forward(cfg, params,
                             input_ids=torch.from_numpy(batch["input_ids"]),
                             labels=torch.from_numpy(batch["labels"]))
                  ["loss"])
    assert abs(plain - losses[0]) > 1e-4


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def test_gradient_accumulation_matches_jax():
    """4 micro-batches at k = 2 against JAX's `optax.MultiSteps` trainer:
    each micro-batch's logged loss and gradient norm, the step count in
    micro-batches, the params after the two updates (the clip applied to
    the mean gradient, the warm-up counting updates), and a checkpoint
    taken between two micro-batches that resumes to the same params. f32,
    the same arithmetic: 1e-5 on the losses, 1e-4 on the norms and the
    params."""
    jcfg, cfg = _configs(**ENCODINGS["rope"], **ONE_LAYER)
    jparams = jt5.init_params(jax.random.PRNGKey(6), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    kw = dict(TRAIN, max_steps=4, warmup_steps=2, gradient_accumulation_steps=2)
    batches = [_batch(20 + i) for i in range(4)]
    jtr = JaxTrainer(jcfg, JaxTrainerConfig(**kw), params=jparams)
    jres = jtr.train(iter(batches))
    tr = Trainer(cfg, TrainerConfig(**kw), params=params, device="cpu")
    res = tr.train(iter(batches))
    assert res["final_step"] == jres["final_step"] == 4
    assert [e["step"] for e in res["logs"]] == [1, 2, 3, 4]
    for got, want in zip(res["logs"], jres["logs"]):
        _close(got["loss"], want["loss"], 1e-5, 0, "loss")
        _close(got["grad_norm"], want["grad_norm"], 1e-4, 0, "grad_norm")
    assert tr.optimizer.step_count == 2
    final = params_to_numpy(tr.params)
    _assert_grads(t5.tree_leaves_with_path(final),
                  jax.device_get(jtr.params), 1e-4, 1e-5)


def test_gradient_accumulation_resumes_mid_window(tmp_path):
    _, cfg = _configs(**ENCODINGS["alibi"])
    kw = dict(TRAIN, max_steps=4, gradient_accumulation_steps=2,
              output_dir=str(tmp_path))
    batches = [_batch(30 + i) for i in range(4)]
    whole = Trainer(cfg, TrainerConfig(**kw), device="cpu")
    whole.train(iter(batches))
    first = Trainer(cfg, TrainerConfig(**dict(kw, max_steps=3)), device="cpu")
    first.train(iter(batches[:3]))
    path = first.save_checkpoint(3)
    resumed = Trainer(cfg, TrainerConfig(**kw), device="cpu")
    assert resumed.restore_checkpoint(path) == 3
    resumed.train(iter(batches[3:]))
    for (p, a), (_, b) in zip(t5.tree_leaves_with_path(whole.params),
                              t5.tree_leaves_with_path(resumed.params)):
        assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# attention dropout
# ---------------------------------------------------------------------------

def test_attention_dropout():
    """On `attn_ref`: rate 0 is the plain attention exactly; one generator
    seed gives one result; a kept entry of P is P / (1 - p) and the share
    dropped is p to 0.01 (16,384 entries: four standard deviations).
    In the model: on `ref` it draws from the generator and moves the loss;
    `deterministic` turns it off; `pallas` ignores it, as the JAX
    package's `pallas` branch does."""
    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.standard_normal((2, 2, 64, 16)).astype(
        np.float32)) for _ in range(2))
    eye = torch.eye(64).expand(2, 2, 64, 64)     # out = P itself
    plain = attn_ref(q, k, eye)
    assert torch.equal(attn_ref(q, k, eye, dropout_p=0.0,
                                generator=torch.Generator()), plain)
    runs = [attn_ref(q, k, eye, dropout_p=0.1,
                     generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    kept = runs[0] != 0
    assert abs(1.0 - kept.float().mean().item() - 0.1) < 0.01
    torch.testing.assert_close(runs[0][kept], (plain / 0.9)[kept])
    with pytest.raises(ValueError, match="generator"):
        attn_ref(q, k, eye, dropout_p=0.1)

    _, cfg = _configs(attention_dropout_rate=0.3, **ENCODINGS["rope"])
    params = t5.init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(8).items()}

    def loss(c, **kw):
        return float(t5.forward(c, params, **batch, **kw)["loss"])

    base = loss(cfg)
    gen = dict(deterministic=False)
    assert loss(cfg, generator=torch.Generator().manual_seed(1), **gen) == \
        loss(cfg, generator=torch.Generator().manual_seed(1), **gen) != base
    pallas = cfg.replace(attention_type="pallas")
    _close(loss(pallas, generator=torch.Generator(), **gen), loss(pallas),
           0, 0)
