"""The pretraining driver's path through the port against the JAX package:
randomized positions on the bias paths, the UL2 collator and its native core,
the run configurations, and three trainer steps on `pallas` with
`use_masking`. The model's loss and gradients on the same path are in
tests/test_torch_pallas_model.py; checkpoints, resume and the driver
(`flasht5_tpu_torch.train.cli`) end to end in tests/test_torch_driver.py.

Inputs come from numpy seeds and reach both packages; weights are made by
the JAX package and carried across with `params_from_numpy`. The JAX side
runs its Pallas kernels in interpret mode (tests/conftest.py), the port runs
on the CPU (the plain versions of its kernels). Tolerances stand beside the
assertions.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu import native as jnative
from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.config import load_run_config as jax_load_run_config
from flasht5_tpu.data import DataCollatorForUL2 as JaxCollator
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.train import Trainer as JaxTrainer
from flasht5_tpu.train import TrainerConfig as JaxTrainerConfig
from flasht5_tpu_torch import native
from flasht5_tpu_torch.config import FlashT5Config, load_run_config
from flasht5_tpu_torch.convert import params_from_numpy, params_to_numpy
from flasht5_tpu_torch.data import DataCollatorForUL2
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.train import Trainer, TrainerConfig
from flasht5_tpu_torch.train import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            pad_token_id=0, z_loss=1e-4, dtype="float32",
            use_fused_layernorm=True, use_fused_crossentropy=True)
MASKING = dict(use_masking=True, use_full_bias_size=True)
# one encoder and one decoder block: the JAX side's interpret-mode kernels
# dominate the file's time
ONE_LAYER = dict(num_layers=1, num_decoder_layers=1)


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


# ---------------------------------------------------------------------------
# randomized positions on the materialized-bias paths
# ---------------------------------------------------------------------------

def test_randomized_positions_are_refused_on_the_bias_paths(monkeypatch):
    """Randomized positions were refused on `ref` and `pallas`; they run
    now. The JAX package randomizes the T5 bias positions whenever a
    training rng is passed on `ref` and `pallas` (its t5.py:274-283), so its
    training loss differs from the plain forward's. With both packages'
    draw patched to one that is not the identity (0, 3, 6, ...), the port's
    training loss on `ref` and on `pallas` is JAX's on `ref` (f32: 1e-5).
    On `pallas_rpe` both packages leave the positions alone (unpatched)."""
    batch = _batch(0)
    args = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def every_third(length, max_length):
        assert 3 * (length - 1) < max_length
        return np.arange(length) * 3

    def jax_loss(jcfg, jparams, rng):
        return float(jax.jit(lambda p, r: jt5.forward(
            jcfg, p, rng=r, deterministic=r is None, **args)["loss"])(
                jparams, rng))

    jcfg, cfg = _configs(attention_type="pallas_rpe",
                         use_randomized_position_encoding=True, **ONE_LAYER)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    got = t5.forward(cfg, params, deterministic=False,
                     generator=torch.Generator().manual_seed(0), **tb)["loss"]
    np.testing.assert_allclose(
        float(got), jax_loss(jcfg, jparams, jax.random.PRNGKey(1)),
        rtol=1e-5)

    from flasht5_tpu import positional as jpositional
    from flasht5_tpu_torch import positional
    monkeypatch.setattr(jpositional, "_randomized_positions",
                        lambda r, n, m: jnp.asarray(every_third(n, m)))
    monkeypatch.setattr(positional, "_randomized_positions",
                        lambda g, n, m: torch.from_numpy(every_third(n, m)))
    jcfg, cfg = _configs(attention_type="ref",
                         use_randomized_position_encoding=True,
                         max_sequence_length=128, **ONE_LAYER)
    jparams = jt5.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    trained = jax_loss(jcfg, jparams, jax.random.PRNGKey(1))
    assert abs(trained - jax_loss(jcfg, jparams, None)) > 1e-4
    t5.check_supported(cfg)
    for attention in ("ref", "pallas"):
        got = t5.forward(cfg.replace(attention_type=attention), params,
                         deterministic=False, generator=torch.Generator(),
                         **tb)["loss"]
        np.testing.assert_allclose(float(got), trained, rtol=1e-5,
                                   err_msg=attention)
    Trainer(cfg, TrainerConfig(), device="cpu")


# ---------------------------------------------------------------------------
# the collator and its native core
# ---------------------------------------------------------------------------

class StubTokenizer:
    """100 sentinels at ids 900..999 (descending extra ids), eos 1, pad 0
    (as tests/test_ul2_collator.py's)."""
    eos_token_id = 1
    pad_token_id = 0

    def encode(self, text):
        return {"[R]": [10, 1], "[S]": [11, 1], "[X]": [12, 1]}.get(
            text, [13, 1])

    @property
    def all_special_tokens(self):
        return [f"<extra_id_{i}>" for i in range(100)] + ["</s>", "<pad>"]

    @property
    def all_special_ids(self):
        return [999 - i for i in range(100)] + [1, 0]


@pytest.mark.parametrize("use_native", [True, False])
def test_collator_matches_jax(use_native):
    """The 7-denoiser mixture, six calls of each collator from one seed,
    packing (more examples than rows) and not (exactly as many): every
    output array equal."""
    # the JAX collator takes its native core only where it loads
    assert jnative.load_ul2_core() is not None
    kw = dict(tokenizer=StubTokenizer(), max_length=128, max_labels_length=64,
              batch_size=4,
              denoiser_list=[dataclasses.asdict(d)
                             for d in cli.UL2_DENOISERS],
              denoiser_proportions=cli.UL2_PROPORTIONS,
              fixed_batch_size=True, min_size_inputs=5, seed=3,
              use_native=use_native)
    want_coll, got_coll = JaxCollator(**kw), DataCollatorForUL2(**kw)
    rng = np.random.default_rng(0)
    for n in (4, 12, 4, 9, 12, 4):
        examples = [{"input_ids": rng.integers(20, 800, size=int(
            rng.integers(8, 300))).astype(np.int32)} for _ in range(n)]
        want, got = want_coll(examples), got_coll(examples)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_native_core_matches_jax():
    for length, mu, r, spans, seed in [(100, 3.0, 0.15, 100, 7),
                                       (640, 64.0, 0.5, 100, 8),
                                       (40, 4.0, 0.0, 1, 9),
                                       (1021, 8.0, 0.5, 100, 2 ** 62)]:
        np.testing.assert_array_equal(
            native.native_noise_mask(length, mu, r, spans, seed),
            jnative.native_noise_mask(length, mu, r, spans, seed))
    rng = np.random.default_rng(0)
    li, ll, ns = (rng.integers(*bounds, 64) for bounds in
                  ((5, 60), (3, 30), (0, 10)))
    np.testing.assert_array_equal(
        native.native_best_fit(li, ll, ns, 128, 64, 100, 8),
        jnative.native_best_fit(li, ll, ns, 128, 64, 100, 8))


def test_native_core_raises_where_it_cannot_be_built(monkeypatch, tmp_path):
    """`use_native=True` means the native core: no silent numpy stream."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native.load_ul2_core.cache_clear()
    try:
        coll = DataCollatorForUL2(
            StubTokenizer(), 64, 32, 2, cli.UL2_DENOISERS,
            cli.UL2_PROPORTIONS, seed=0, use_native=True)
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            coll([{"input_ids": np.arange(20, 80, dtype=np.int32)}] * 2)
    finally:
        native.load_ul2_core.cache_clear()


# ---------------------------------------------------------------------------
# the run configurations
# ---------------------------------------------------------------------------

YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                         recursive=True))


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.basename(p)[:-5] for p in YAMLS])
def test_run_configs_load_as_in_jax(path):
    run, want = load_run_config(path), jax_load_run_config(path)
    assert run == want
    cfg = FlashT5Config.from_dict(run["model_args"])
    assert cfg.to_dict() == JaxConfig.from_dict(want["model_args"]).to_dict()
    t5.check_supported(cfg)


# ---------------------------------------------------------------------------
# the trainer (the model's loss and gradients: tests/test_torch_pallas_model.py)
# ---------------------------------------------------------------------------

TRAIN = dict(learning_rate=5e-3, max_steps=3, warmup_steps=1,
             lr_scheduler="cosine", gradient_clip_norm=1.0,
             weight_decay=0.01, logging_steps=1)


def test_trainer_three_steps_match_jax_on_pallas_with_masking():
    """Three steps of `Trainer.train` against the JAX trainer's on
    `pallas` with `use_masking` (padded batches): each step's loss and
    gradient norm, and the parameters after the third, f32 throughout (as
    tests/test_torch_train.py holds the pallas_rpe trainer)."""
    jcfg, cfg = _configs(attention_type="pallas", **MASKING, **ONE_LAYER)
    jparams = jt5.init_params(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device="cpu")
    batches = [_batch(10 + i) for i in range(3)]
    jtr = JaxTrainer(jcfg, JaxTrainerConfig(**TRAIN), params=jparams)
    jres = jtr.train(iter(batches))
    tr = Trainer(cfg, TrainerConfig(**TRAIN), params=params, device="cpu")
    res = tr.train(iter(batches))
    for got, want in zip(res["logs"], jres["logs"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
    got = t5.tree_leaves_with_path(params_to_numpy(tr.params))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(jtr.params))
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=path)
