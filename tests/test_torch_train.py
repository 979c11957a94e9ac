"""The port's training path against the JAX package: the model's loss,
logits and every gradient, the optimizer and its schedules, the trainer over
three steps, and the original PyTorch FAT5 goldens through the port's
`forward`.

Weights are made by the JAX package (`init_params`, or the golden
state_dicts through `state_dict_to_params`), flattened to numpy and carried
across with `params_from_numpy`; inputs come from a numpy seed. The JAX side
runs its Pallas kernels in interpret mode (tests/conftest.py); the port runs
on the CPU, i.e. the plain version of every kernel.

Tolerances, each with its reason, stand beside the assertions.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.convert.hf_import import state_dict_to_params
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.optim import adamw_scale, cosine_schedule as jcosine
from flasht5_tpu.optim import no_decay_mask as jno_decay_mask
from flasht5_tpu.optim import wsd_schedule as jwsd
from flasht5_tpu.train import Trainer as JaxTrainer
from flasht5_tpu.train import TrainerConfig as JaxTrainerConfig
from flasht5_tpu.train.trainer import masked_accuracy as jmasked_accuracy
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy, params_to_numpy
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.optim import (AdamWScale, cosine_schedule,
                                     no_decay_mask, wsd_schedule)
from flasht5_tpu_torch.train import Trainer, TrainerConfig, masked_accuracy

TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            pad_token_id=0, z_loss=1e-4, dtype="float32")
FLAGSHIP_PATH = dict(attention_type="pallas_rpe", use_fused_layernorm=True,
                     use_fused_crossentropy=True)


def _configs(**kw):
    d = dict(TINY, **kw)
    return JaxConfig(**d), FlashT5Config(**d)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, b=2, enc=24, dec=16, vocab=256):
    rng = np.random.default_rng(seed)
    labels = rng.integers(2, vocab, size=(b, dec)).astype(np.int32)
    labels[:, -3:] = -100          # padded targets
    return {"input_ids": rng.integers(2, vocab, size=(b, enc)).astype(
        np.int32), "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_trees_close(got_leaves, want_tree, rtol, atol):
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in got_leaves] == [jax.tree_util.keystr(p)
                                          for p, _ in want]
    for (path, g), (_, w) in zip(got_leaves, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg=path)


# ---------------------------------------------------------------------------
# the model: loss, logits and the gradient of every leaf
# ---------------------------------------------------------------------------

# f32: both sides compute in f32 and differ in summation order only, through
# two encoder and two decoder layers: 1e-4. bf16 activations: a value one
# f32 ulp apart on the two sides can round to neighbouring bf16 values (2^-8
# relative) and such flips compound through the layers and the backward,
# so each gradient leaf is held to 5e-2 of its own largest entry.
@pytest.mark.parametrize("case", ["pallas_rpe", "ref", "pallas_rpe_bf16"])
def test_forward_and_gradients_match_jax(case):
    kw = dict(FLAGSHIP_PATH) if case.startswith("pallas_rpe") else {}
    if case.endswith("bf16"):
        kw["dtype"] = "bfloat16"
    jcfg, cfg = _configs(**kw)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(0)

    def loss_fn(p):
        out = jt5.forward(jcfg, p, input_ids=jnp.asarray(batch["input_ids"]),
                          labels=jnp.asarray(batch["labels"]))
        return out["loss"], out["logits"]

    (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)

    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    leaves = t5.tree_leaves_with_path(params)
    for _, p in leaves:
        p.requires_grad_(True)
    tb = _torch_batch(batch)
    out = t5.forward(cfg, params, input_ids=tb["input_ids"],
                     labels=tb["labels"])
    out["loss"].backward()
    got = [(path, p.grad.numpy()) for path, p in leaves]

    if case.endswith("bf16"):
        assert out["logits"].dtype == torch.bfloat16
        np.testing.assert_allclose(float(out["loss"].detach()),
                                   float(loss_j), rtol=1e-2)
        want = jax.tree_util.tree_leaves_with_path(grads_j)
        for (path, g), (_, w) in zip(got, want):
            w = np.asarray(w, np.float32)
            assert np.abs(g - w).max() <= 5e-2 * np.abs(w).max(), path
        return
    np.testing.assert_allclose(float(out["loss"].detach()), float(loss_j),
                               rtol=1e-5)
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    _assert_trees_close(got, grads_j, rtol=1e-4, atol=1e-4)


def test_compute_loss_reduction_quirk():
    """The fused path means over all rows, the plain path over the rows that
    are not ignored (reference modeling:68 and :74), as in the JAX model."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 30)).astype(np.float32)
    labels = rng.integers(0, 30, size=(2, 5)).astype(np.int32)
    labels[0, :2] = -100
    for fused in (True, False):
        jcfg, cfg = _configs(use_fused_crossentropy=fused)
        want = float(jt5.compute_loss(jcfg, jnp.asarray(logits),
                                      jnp.asarray(labels)))
        got = float(t5.compute_loss(cfg, torch.from_numpy(logits),
                                    torch.from_numpy(labels)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    jcfg, cfg = _configs(decoder_start_token_id=7)
    np.testing.assert_array_equal(
        t5.shift_right(cfg, torch.from_numpy(labels)).numpy(),
        np.asarray(jt5.shift_right(jcfg, jnp.asarray(labels))))


def test_model_forward_matches_jax():
    jcfg, cfg = _configs(**FLAGSHIP_PATH)
    jparams = jt5.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    batch = _batch(1)
    dec_ids = batch["labels"].clip(min=0)
    want = jax.jit(lambda p, a, b: jt5.model_forward(
        jcfg, p, input_ids=a, decoder_input_ids=b))(
        jparams, jnp.asarray(batch["input_ids"]), jnp.asarray(dec_ids))
    got = t5.model_forward(cfg, params,
                           input_ids=torch.from_numpy(batch["input_ids"]),
                           decoder_input_ids=torch.from_numpy(dec_ids))
    for key in ("last_hidden_state", "encoder_last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)


def test_dropout_draws_from_the_given_generator():
    """Dropout is off only when `deterministic` is True or the rate is 0;
    otherwise it draws from the caller's generator, and without one the
    forward refuses rather than train without dropout."""
    _, cfg = _configs(**dict(FLAGSHIP_PATH, dropout_rate=0.1))
    params = t5.init_params(cfg, seed=0, device="cpu")
    tb = _torch_batch(_batch(2))

    def loss(**kw):
        return float(t5.forward(cfg, params, input_ids=tb["input_ids"],
                                labels=tb["labels"], **kw)["loss"])

    with pytest.raises(ValueError, match="generator"):
        loss(deterministic=False)
    dropped = [loss(deterministic=False,
                    generator=torch.Generator().manual_seed(3))
               for _ in range(2)]
    assert dropped[0] == dropped[1]
    assert dropped[0] != loss()


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("attention", ["ref", "pallas", "pallas_rpe"])
def test_remat_matches_plain(attention, dropout):
    """`remat` recomputes each block in the backward pass (the JAX
    package's `test_remat_matches_plain`): over two steps drawn from one
    generator seed, the loss and every gradient are those of the model
    without remat, and so is the generator's state after each backward
    pass. With dropout, a recompute that drew new masks, or left the
    generator elsewhere (the second step's masks would move), changes
    them. Both sides run the same f32 arithmetic on the CPU: equal to
    1e-6 (the gradient sums may be added in another order)."""
    _, cfg = _configs(attention_type=attention, dropout_rate=dropout,
                      use_fused_layernorm=True, use_fused_crossentropy=True)
    params = t5.init_params(cfg, seed=0, device="cpu")
    leaves = [leaf for _, leaf in t5.tree_leaves_with_path(params)]
    batches = [_torch_batch(_batch(30 + i)) for i in range(2)]

    def run(remat):
        c = dataclasses.replace(cfg, remat=remat)
        gen = torch.Generator().manual_seed(7)
        steps = []
        for tb in batches:
            for leaf in leaves:
                leaf.requires_grad_(True)
                leaf.grad = None
            loss = t5.forward(c, params, input_ids=tb["input_ids"],
                              labels=tb["labels"], generator=gen,
                              deterministic=dropout == 0.0)["loss"]
            loss.backward()
            steps.append((loss.detach(), [leaf.grad.clone()
                                          for leaf in leaves],
                          gen.get_state()))
        return steps

    for (la, ga, sa), (lb, gb, sb) in zip(run(False), run(True)):
        torch.testing.assert_close(lb, la, rtol=1e-6, atol=1e-6)
        for a, b in zip(ga, gb):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
        assert torch.equal(sa, sb)


def test_remat_keeps_no_activations():
    """With `remat` a block's activations are not kept for the backward
    pass: the autograd graph of the loss saves fewer bytes."""
    _, cfg = _configs(**FLAGSHIP_PATH)
    params = t5.init_params(cfg, seed=0, device="cpu")
    for _, leaf in t5.tree_leaves_with_path(params):
        leaf.requires_grad_(True)
    tb = _torch_batch(_batch(40))
    saved = []
    for remat in (False, True):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            t5.forward(dataclasses.replace(cfg, remat=remat), params,
                       input_ids=tb["input_ids"], labels=tb["labels"])
        saved.append(total[0])
    assert saved[1] < saved[0] / 2


# ---------------------------------------------------------------------------
# the optimizer and its schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,warmup", [("cosine", 0), ("cosine", 3),
                                         ("wsd", 0), ("wsd", 3)])
def test_schedules_match_jax(kind, warmup):
    jfn, fn = {"cosine": (jcosine, cosine_schedule),
               "wsd": (jwsd, wsd_schedule)}[kind]
    js, s = jfn(2e-3, 12, warmup_steps=warmup), fn(2e-3, 12,
                                                   warmup_steps=warmup)
    for step in range(0, 14):
        # the JAX schedule evaluates in f32, the port's in f64
        np.testing.assert_allclose(s(step), float(js(step)), rtol=1e-5)


def _opt_tree(rng):
    def arr(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"encoder": {"block": [{"layer_norm": {"weight": 1 + arr(16)},
                                   "Wq": arr(16, 8)}],
                        "final_layer_norm": {"weight": 1 + arr(16)}},
            "pe": {"relative_attention_bias": arr(32, 4)},
            "lm_head": arr(8, 40, scale=1e-4)}


# f32 leaves: the same f32 arithmetic in another association: 1e-5. bf16
# leaves: the f32 update of the two sides differs by an ulp or so, which can
# round a bf16 value to its neighbour: 2^-7 relative (one bf16 ulp).
@pytest.mark.parametrize("mode", ["float32", "bf16_kahan", "bf16_state"])
def test_adamw_scale_matches_jax(mode):
    rng = np.random.default_rng(4)
    tree = _opt_tree(rng)
    bf16_leaf = mode == "bf16_kahan"
    if bf16_leaf:   # low-precision leaves take the Kahan-compensated update
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        jtree["lm_head"] = jtree["lm_head"].astype(jnp.bfloat16)
        jtree["encoder"]["block"][0]["Wq"] = \
            jtree["encoder"]["block"][0]["Wq"].astype(jnp.bfloat16)
    else:
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    state_dtype = mode == "bf16_state"
    kw = dict(b1=0.9, b2=0.99, eps=1e-6, weight_decay=0.1,
              kahan_sum=bf16_leaf)
    tx = adamw_scale(jcosine(1e-2, 10, warmup_steps=2), mask=jno_decay_mask,
                     state_dtype=jnp.bfloat16 if state_dtype else None, **kw)
    jstate = tx.init(jtree)

    params = params_from_numpy(_numpy_tree(jtree), device="cpu")
    named = t5.tree_leaves_with_path(params)
    decay = no_decay_mask(path for path, _ in named)
    assert decay == jax.tree_util.tree_leaves(jno_decay_mask(jtree))
    groups = [{"params": [p for (_, p), d in zip(named, decay) if d]},
              {"params": [p for (_, p), d in zip(named, decay) if not d],
               "weight_decay": 0.0}]
    opt = AdamWScale(groups, lr=cosine_schedule(1e-2, 10, warmup_steps=2),
                     betas=(kw["b1"], kw["b2"]), eps=kw["eps"],
                     weight_decay=kw["weight_decay"],
                     kahan_sum=kw["kahan_sum"],
                     state_dtype=torch.bfloat16 if state_dtype else None)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
            jtree)
        updates, jstate = tx.update(grads, jstate, jtree)
        jtree = optax.apply_updates(jtree, updates)
        for (_, p), g in zip(named, jax.tree_util.tree_leaves(grads)):
            p.grad = torch.tensor(np.asarray(g, np.float32)).to(p.dtype)
        opt.step()
        for (path, p), w in zip(named, jax.tree_util.tree_leaves(jtree)):
            assert p.dtype == {jnp.dtype("bfloat16"): torch.bfloat16,
                               jnp.dtype("float32"): torch.float32}[w.dtype]
            tol = 2.0 ** -7 if p.dtype == torch.bfloat16 else 1e-5
            np.testing.assert_allclose(
                p.float().numpy(), np.asarray(w, np.float32), rtol=tol,
                atol=1e-6, err_msg=f"step {step + 1} {path}")


def test_adamw_scale_refuses_sharded_statistics():
    """The statistics are ported (tests/test_torch_parallel*.py); a mesh
    axis named as in the JAX package, not a process group, is refused."""
    with pytest.raises(TypeError):
        AdamWScale([torch.zeros(3)], stat_axes="tensor")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

TRAIN = dict(learning_rate=5e-3, max_steps=3, warmup_steps=1,
             lr_scheduler="cosine", gradient_clip_norm=1.0,
             weight_decay=0.01, logging_steps=1)


def test_trainer_three_steps_match_jax():
    """Three steps of the port's `Trainer.train` against three of the JAX
    trainer's (its step is `make_train_step`'s: the same forward, AdamWScale
    with the no-decay mask and the cosine schedule, clipping by the global
    norm, which the 1.0 limit triggers here), on the same params and
    batches: the loss and gradient norm of every step, the token count, the
    params after the third step, and `evaluate`. f32 throughout, and the
    updates repeat the same f32 arithmetic: 1e-4 on the params."""
    jcfg, cfg = _configs(**FLAGSHIP_PATH)
    jparams = jt5.init_params(jax.random.PRNGKey(2), jcfg)
    # before the JAX trainer's step donates (and deletes) jparams
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    batches = [_batch(10 + i) for i in range(3)]
    jtr = JaxTrainer(jcfg, JaxTrainerConfig(**TRAIN), params=jparams)
    jres = jtr.train(iter(batches))
    tr = Trainer(cfg, TrainerConfig(**TRAIN), params=params, device="cpu")
    res = tr.train(iter(batches))
    assert res["final_step"] == jres["final_step"] == 3
    for got, want in zip(res["logs"], jres["logs"]):
        assert got["step"] == want["step"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        assert got["grad_norm"] > TRAIN["gradient_clip_norm"]
    assert res["logs"][-1]["tokens_per_sec"] > 0
    got_params = t5.tree_leaves_with_path(params_to_numpy(tr.params))
    _assert_trees_close(got_params, jax.device_get(jtr.params), rtol=1e-4,
                        atol=1e-5)
    ev, jev = tr.evaluate([_batch(20)]), jtr.evaluate([_batch(20)])
    for key in ("eval_loss", "eval_masked_accuracy", "eval_perplexity"):
        np.testing.assert_allclose(ev[key], jev[key], rtol=1e-5)


def test_masked_accuracy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, size=(3, 7))
    labels[0, 0] = int(logits[0, 0].argmax())
    assert masked_accuracy(logits, labels) == jmasked_accuracy(logits, labels)
    assert masked_accuracy(logits, np.zeros_like(labels)) == 0.0


def test_trainer_refuses_what_is_not_ported():
    _, cfg = _configs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, TrainerConfig())
    # the degrees run across ranks now (tests/test_torch_parallel*.py), and
    # raise without the process group they need
    for kw in (dict(data_parallel=2), dict(tensor_parallel=2),
               dict(pipeline_parallel=2)):
        with pytest.raises(RuntimeError, match="process group"):
            Trainer(cfg, TrainerConfig(**kw), device="cpu")
    # gradient accumulation runs now (tests/test_torch_pe_train.py)
    Trainer(cfg, TrainerConfig(gradient_accumulation_steps=2), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg.replace(tp_axis="model"), TrainerConfig(), device="cpu")
    with pytest.raises(ValueError):
        Trainer(cfg, TrainerConfig(), device="meta")


# ---------------------------------------------------------------------------
# the original PyTorch FAT5 goldens through the port's forward
# ---------------------------------------------------------------------------

# The T5 goldens, ref_t5_masking among them, run here on all three attention
# paths (the RoPE, ALiBi and FIRE ones: tests/test_torch_positional.py).
# Tolerances are those of tests/test_golden_reference.py (ref: 1e-4 on hidden
# states and logits, 2e-5 on the loss; the kernel paths: 5e-4 and 1e-4).
T5_GOLDENS = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                           "golden", "ref_t5_*.npz")))


def _load(path):
    """(config dict, state_dict, arrays) of a golden case, as
    tests/test_golden_reference.py reads them."""
    z = np.load(path)
    cfg = json.loads(bytes(z["config_json"]).decode())
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")
          and not k.endswith("embed_tokens.weight")}
    return cfg, sd, z


@pytest.mark.parametrize("attention", ["ref", "pallas", "pallas_rpe"])
@pytest.mark.parametrize("path", T5_GOLDENS,
                         ids=[os.path.basename(p)[4:-4] for p in T5_GOLDENS])
def test_goldens_through_the_port(path, attention):
    cfg_json, sd, z = _load(path)
    # use_masking asks for use_full_bias_size, as
    # tests/test_golden_reference.py:98 sets it on pallas_rpe
    d = dict(cfg_json, dtype="float32", param_dtype="float32",
             attention_type=attention,
             use_full_bias_size=bool(cfg_json.get("use_full_bias_size")
                                     or cfg_json.get("use_masking")))
    cfg = FlashT5Config.from_dict(d)
    params = params_from_numpy(
        _numpy_tree(state_dict_to_params(sd, dtype=jnp.float32)),
        device="cpu")
    with torch.no_grad():
        out = t5.forward(cfg, params,
                         input_ids=torch.from_numpy(z["input_ids"]),
                         attention_mask=torch.from_numpy(z["attention_mask"]),
                         labels=torch.from_numpy(z["labels"]))
    tol, loss_tol = (1e-4, 2e-5) if attention == "ref" else (5e-4, 1e-4)
    if attention == "ref":
        np.testing.assert_allclose(out["encoder_hidden_states"].numpy(),
                                   z["encoder_hidden_states"], atol=tol,
                                   rtol=tol)
    np.testing.assert_allclose(out["logits"].numpy(), z["logits"], atol=tol,
                               rtol=tol)
    assert abs(float(out["loss"]) - float(z["loss"])) < loss_tol
