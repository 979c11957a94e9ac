"""The port's `parallel/` across four gloo ranks on the CPU, against the
JAX package on the conftest's 8-device CPU mesh: the ring collective
matmuls (plain and int8), the vocab-parallel loss (value and gradient) and
next token at t = 2 and 4, two steps of the tensor-parallel step at (2, 2)
with and without the collective matmul and with a bf16 all-reduce, of the
data-parallel step at (4, 1) and of the pipeline step at (pipe 2, data 2)
with 2 microbatches; `sharded_train_step` at (2, 2), (4, 1) and (1, 4);
then the `Trainer` at (data 2, tensor 2) and (pipe 2, data 2) with a
clipped step and ranks whose ignored rows differ, against the JAX
`Trainer`, its evaluation, a checkpoint saved across ranks and restored
on one, and dropout's masks across ranks.

One spawn of the four ranks serves the module (`torch_parallel_ranks.py`,
whose ranks import torch and the port only). Inputs come from a numpy
seed; the JAX parameters are carried across. Widths are JAX
test_tp_step.py's tiny config in f32; the JAX side runs `ref` attention and
the port the plain versions of `pallas_rpe`'s kernels. Two JAX sharded
references run: its tensor-parallel step, which the port's TP, DP and PP
steps are held to (the same math), and its `Trainer`; the gradients of
the loss come from JAX's single-device `t5.compute_loss`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.ops.quant import quantize_int8
from flasht5_tpu.optim import adamw_scale, no_decay_mask
from flasht5_tpu.parallel import make_mesh
from flasht5_tpu.parallel import distributed as jdist
from flasht5_tpu.parallel.collective_matmul import (allgather_matmul,
                                                    matmul_reducescatter)
from flasht5_tpu.parallel.sharding import batch_sharding
from flasht5_tpu.parallel.tp_step import (make_tp_train_step, tp_stat_axes,
                                          tp_train_state)
from flasht5_tpu.parallel.vocab_parallel import (vocab_parallel_loss,
                                                 vocab_parallel_next_token)
from flasht5_tpu.train.trainer import Trainer as JaxTrainer
from flasht5_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from torch_parallel_ranks import spawn

TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, dropout_rate=0.0, attention_scale=1.0,
            dtype="float32", pad_token_id=0, use_fused_crossentropy=True)
PORT_PATH = dict(attention_type="pallas_rpe", use_fused_layernorm=True)
LR = 1e-2
# f32 throughout: the collective matmuls within 1e-5 of the largest entry
# (the ring sums in another order); the loss within 1e-6 relative and its
# gradient within 1e-6 of the largest entry; parameters after two steps
# within 2e-5 of each leaf's largest entry (AdamWScale's step is lr times
# the rms, so a 1e-7 gradient gap moves few entries by more than that) and
# a step's loss, taken after an update, within 5e-6 relative
MATMUL_TOL = 1e-5
CE_TOL = 1e-6
PARAM_TOL = 2e-5
LOSS_TOL = 5e-6
TRAINER = dict(max_steps=2, logging_steps=1, gradient_clip_norm=0.5,
               lr_scheduler="constant", learning_rate=LR)
# the trainer's loss: the mean over the non-ignored rows, smoothing, z-loss
TRAINER_MODEL = dict(TINY, use_fused_crossentropy=False, z_loss=1e-4,
                     label_smoothing=0.1)

CE_CASES = {
    # name: (t, fused mean, label smoothing, z-loss)
    "t2_fused_smooth_z": (2, True, 0.1, 1e-4),
    "t2_valid_mean_z": (2, False, 0.0, 1e-4),
    "t4_fused_plain": (4, True, 0.0, 0.0),
    "t4_valid_mean_smooth_z": (4, False, 0.2, 1e-3),
}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ce_inputs(t, fused, smoothing, z, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, 8, 64)) * 3.0).astype(np.float32)
    labels = rng.integers(0, 64, size=(3, 8))
    labels[0, 5:] = -100
    labels[2, :2] = -100
    cfg = dict(TINY, vocab_size=64, use_fused_crossentropy=fused,
               label_smoothing=smoothing, z_loss=z)
    return {"t": t, "config": cfg, "logits": logits, "labels": labels}


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    # K 512 and N 384: the JAX package's quant_matmul runs its kernel (x
    # rounded to bf16) and not its oracle at these shards' shapes, as the
    # port's does at every shape
    x = rng.standard_normal((32, 512)).astype(np.float32)
    w = (rng.standard_normal((512, 384)) * 0.1).astype(np.float32)
    q = quantize_int8(jnp.asarray(w))
    next_logits = rng.standard_normal((6, 64)).astype(np.float32)
    # ties: row 1's maximum in two shards, row 3's twice in one shard
    next_logits[1, [5, 40]] = 9.0
    next_logits[3, [20, 21]] = 9.0
    jcfg = JaxConfig(**TINY)
    params = _numpy(jt5.init_params(jax.random.PRNGKey(0), jcfg))
    batch = {"input_ids": rng.integers(2, 256, (8, 24)).astype(np.int32),
             "labels": rng.integers(2, 256, (8, 12)).astype(np.int32)}
    ce = {name: _ce_inputs(*case, seed=i + 1)
          for i, (name, case) in enumerate(CE_CASES.items())}
    return {"x": x, "w": w, "wq": (np.asarray(q.qvalues),
                                   np.asarray(q.scales)),
            "next_logits": next_logits, "ce_cases": ce,
            "config": dict(TINY, **PORT_PATH), "params": params,
            "batch": batch, "ce_fault_case": "t2_fused_smooth_z"}


def _trainer_batch(rng, ignored):
    labels = rng.integers(2, 256, (8, 12)).astype(np.int32)
    for row, start in ignored:
        labels[row, start:] = -100
    return {"input_ids": rng.integers(2, 256, (8, 24)).astype(np.int32),
            "labels": labels}


@pytest.fixture(scope="module")
def trainer_inputs(inputs):
    rng = np.random.default_rng(1)
    # the first data rank's rows 0-3 lose 11 labels, the second's 4-7 one
    batches = [_trainer_batch(rng, [(0, 6), (1, 7), (3, 10)]),
               _trainer_batch(rng, [(5, 11), (6, 4)])]
    evals = [_trainer_batch(rng, [(2, 3)]), _trainer_batch(rng, [])]
    return {"config": dict(TRAINER_MODEL, **PORT_PATH),
            "params": inputs["params"], "trainer": TRAINER,
            "batches": batches, "eval_batches": evals}


@pytest.fixture(scope="module")
def ranks(inputs, trainer_inputs, tmp_path_factory):
    return spawn("all", {"ops": inputs, "trainer": trainer_inputs},
                 tmp_path_factory.mktemp("parallel"))


def _tensor_mesh(t):
    return make_mesh(1, t)


def test_host_local_batch_slice_matches_jax(ranks, monkeypatch):
    monkeypatch.setattr(jdist.jax, "process_count", lambda: 4)
    for r, res in enumerate(ranks):
        monkeypatch.setattr(jdist.jax, "process_index", lambda r=r: r)
        assert res["batch_slice"] == jdist.host_local_batch_slice(10)


@pytest.mark.parametrize("name", ["allgather", "allgather_int8",
                                  "reducescatter", "reducescatter_int8"])
def test_collective_matmul_matches_jax(ranks, inputs, name):
    mesh = _tensor_mesh(4)
    x, w = jnp.asarray(inputs["x"]), jnp.asarray(inputs["w"])
    if name.endswith("int8"):
        w = quantize_int8(w)
    if name.startswith("allgather"):
        f = shard_map(lambda xs, ws: allgather_matmul(xs, ws, "tensor"),
                      mesh=mesh, in_specs=(P("tensor", None), P()),
                      out_specs=P(), check_vma=False)
        want = np.asarray(jax.jit(f)(x, w))
        for res in ranks:
            _assert_close(res[name], want, MATMUL_TOL, name)
    else:
        w_spec = P("tensor", None)
        if name.endswith("int8"):
            # per-channel scales of a row-split weight stay whole
            w_spec = type(w)(P("tensor", None), P(None, None))
        f = shard_map(lambda xs, ws: matmul_reducescatter(xs, ws, "tensor"),
                      mesh=mesh, in_specs=(P(None, "tensor"), w_spec),
                      out_specs=P("tensor", None), check_vma=False)
        want = np.asarray(jax.jit(f)(x, w))
        got = np.concatenate([res[name] for res in ranks])
        _assert_close(got, want, MATMUL_TOL, name)


@pytest.fixture(scope="module")
def jax_ce(inputs):
    """{case: (JAX vocab_parallel_loss's value on the t-way split, the
    gradient of JAX's single-device compute_loss)}."""
    out = {}
    for name, case in inputs["ce_cases"].items():
        cfg = JaxConfig(**case["config"])
        logits = jnp.asarray(case["logits"])
        labels = jnp.asarray(case["labels"], jnp.int32)
        f = shard_map(
            lambda lg, lb, cfg=cfg: vocab_parallel_loss(cfg, lg, lb,
                                                        "tensor"),
            mesh=_tensor_mesh(case["t"]),
            in_specs=(P(None, None, "tensor"), P()), out_specs=P(),
            check_vma=False)
        out[name] = (float(jax.jit(f)(logits, labels)), np.asarray(
            jax.grad(lambda lg, cfg=cfg, labels=labels: jt5.compute_loss(
                cfg, lg, labels))(logits)))
    return out


@pytest.mark.parametrize("name", list(CE_CASES))
def test_vocab_parallel_loss_matches_jax(ranks, inputs, jax_ce, name):
    t = inputs["ce_cases"][name]["t"]
    want_loss, want_grad = jax_ce[name]
    grads = {}
    for res in ranks:
        got = res[f"ce_{name}"]
        np.testing.assert_allclose(float(got["loss"]), want_loss,
                                   rtol=CE_TOL)
        grads.setdefault(got["rank"], got["grad"])
    got_grad = np.concatenate([grads[r] for r in range(t)], axis=-1)
    _assert_close(got_grad, want_grad, CE_TOL, f"{name} dlogits")


def test_vocab_parallel_loss_fault_with_the_shards_lse_is_caught(
        ranks, inputs, jax_ce):
    """The split backward fed each shard's own lse instead of the global
    one lands beyond the gradient's limit."""
    case = inputs["ce_cases"][inputs["ce_fault_case"]]
    want = jax_ce[inputs["ce_fault_case"]][1]
    grads = {res["ce_fault"]["rank"]: res["ce_fault"]["grad"]
             for res in ranks}
    got = np.concatenate([grads[r] for r in range(case["t"])], axis=-1)
    with pytest.raises(AssertionError):
        _assert_close(got, want, CE_TOL, "planted fault")


@pytest.mark.parametrize("t", [2, 4])
def test_vocab_parallel_next_token_matches_jax(ranks, inputs, t):
    import torch

    from flasht5_tpu_torch.inference.sampling import sample_token
    logits = jnp.asarray(inputs["next_logits"])
    f = shard_map(lambda lg: vocab_parallel_next_token(lg, "tensor"),
                  mesh=_tensor_mesh(t), in_specs=P(None, "tensor"),
                  out_specs=P(), check_vma=False)
    want = np.asarray(jax.jit(f)(logits))
    assert want[1] == 5 and want[3] == 20           # lowest index wins
    sampled = sample_token(torch.from_numpy(inputs["next_logits"]),
                           generator=torch.Generator().manual_seed(7),
                           temperature=0.8, top_k=20, top_p=0.9).numpy()
    for res in ranks:
        np.testing.assert_array_equal(res[f"next_greedy_{t}"], want)
        np.testing.assert_array_equal(res[f"next_sampled_{t}"], sampled)


def test_shard_then_gather_gives_the_tree_back(ranks, inputs):
    want = jax.tree_util.tree_leaves(inputs["params"])
    for res in ranks:
        got = jax.tree_util.tree_leaves(res["roundtrip"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def jax_tp_params(inputs):
    """JAX's make_tp_train_step at (2, 2), two steps."""
    cfg = JaxConfig(**TINY)
    mesh = make_mesh(2, 2)
    tx = adamw_scale(LR, mask=no_decay_mask, stat_axes=tp_stat_axes)
    params, opt = tp_train_state(cfg, mesh, tx)
    step = make_tp_train_step(cfg, mesh, tx)
    bs = batch_sharding(mesh)
    batch = {k: jax.device_put(jnp.asarray(v), bs)
             for k, v in inputs["batch"].items()}
    losses = []
    for _ in range(2):
        params, opt, metrics = step(params, opt, batch, None)
        losses.append(float(metrics["loss"]))
    return losses, _numpy(params)


def _assert_params(got_tree, want_tree, what):
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        _assert_close(g, w, PARAM_TOL, f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("collective", [False, True])
def test_tp_step_matches_jax(ranks, jax_tp_params, collective):
    losses, want = jax_tp_params
    for res in ranks:
        got = res[f"tp_{collective}"]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL)
        _assert_params(got["params"], want, f"tp collective={collective}")


def test_tp_step_with_a_bf16_allreduce_tracks_f32(ranks, jax_tp_params):
    """`make_tp_train_step(allreduce_dtype="bfloat16")` at (2, 2): the
    gradients cast to bf16 for the sum over "data" only. Two steps track
    JAX's f32 step within JAX's own test's limits (test_tp_step.py: losses
    2e-3, parameters 5e-3, here of each leaf's largest entry), and differ
    from the port's f32 step, so the cast took place."""
    losses, want = jax_tp_params
    for res in ranks:
        got = res["tp_bf16_allreduce"]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-3,
                                   atol=2e-3)
        leaves = jax.tree_util.tree_leaves_with_path(got["params"])
        for (path, g), w in zip(leaves, jax.tree_util.tree_leaves(want)):
            _assert_close(g, w, 5e-3, f"bf16 all-reduce "
                                      f"{jax.tree_util.keystr(path)}")
        f32 = jax.tree_util.tree_leaves(res["tp_False"]["params"])
        assert any(not np.array_equal(g, w)
                   for (_, g), w in zip(leaves, f32))


@pytest.fixture(scope="module")
def jax_seed0_loss(inputs):
    """JAX's single-device loss on the port's parameters drawn from seed 0
    (what `sharded_train_step` draws) and the module's batch."""
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.convert import params_to_numpy
    from flasht5_tpu_torch.models import t5
    params = params_to_numpy(t5.init_params(
        FlashT5Config(**inputs["config"]), seed=0, device="cpu"))
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    return float(jt5.forward(JaxConfig(**TINY), jax.tree_util.tree_map(
        jnp.asarray, params), **batch)["loss"])


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "1x4"])
def test_sharded_train_step_matches_jax_single_device(ranks, jax_seed0_loss,
                                                      mesh):
    """`sharded_train_step` (parameters drawn from seed 0, one tensor- and
    data-parallel step) returns the loss of JAX's single-device forward on
    the same parameters and batch (as JAX's test_parallel.py holds its
    sharded step to its (1, 1) one), within LOSS_TOL."""
    for res in ranks:
        np.testing.assert_allclose(float(res[f"sharded_{mesh}"]),
                                   jax_seed0_loss, rtol=LOSS_TOL)


def test_dp_step_matches_jax(ranks, jax_tp_params):
    losses, want = jax_tp_params
    for res in ranks:
        np.testing.assert_allclose(res["dp"]["losses"], losses,
                                   rtol=LOSS_TOL)
        _assert_params(res["dp"]["params"], want, "dp")


def test_pp_step_matches_jax(ranks, jax_tp_params):
    """The pipeline step at (pipe 2, data 2), 2 micro-batches, against the
    JAX run of the same two steps of the same math: JAX's pipeline step
    gives its single-device numbers (tests/test_pp_step.py), and so does
    its tensor-parallel step, whose run stands for both here (one JAX
    sharded reference per module: each costs ~20 s on this CPU)."""
    losses, want = jax_tp_params
    for res in ranks:
        np.testing.assert_allclose(res["pp_step"]["losses"], losses,
                                   rtol=LOSS_TOL)
        _assert_params(res["pp_step"]["params"], want, "pp")


# ---------------------------------------------------------------------------
# the trainer across ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trainer(trainer_inputs):
    """The JAX `Trainer` at (data 2, tensor 2) (GSPMD: the one-card math)."""
    tr = JaxTrainer(JaxConfig(**TRAINER_MODEL),
                    JaxTrainerConfig(data_parallel=2, tensor_parallel=2,
                                     **TRAINER),
                    params=jax.tree_util.tree_map(
                        jnp.asarray, trainer_inputs["params"]))
    out = tr.train(trainer_inputs["batches"])
    return out["logs"], _numpy(tr.params), tr.evaluate(
        trainer_inputs["eval_batches"])


@pytest.mark.parametrize("layout", ["tp", "pp"])
def test_trainer_across_ranks_matches_jax(ranks, jax_trainer, layout):
    logs, params, evaluation = jax_trainer
    # the clip acts on both steps
    assert all(entry["grad_norm"] > TRAINER["gradient_clip_norm"]
               for entry in logs)
    for res in ranks:
        got = res[layout]
        for mine, want in zip(got["logs"], logs):
            np.testing.assert_allclose(mine["loss"], want["loss"],
                                       rtol=LOSS_TOL)
            np.testing.assert_allclose(mine["grad_norm"], want["grad_norm"],
                                       rtol=LOSS_TOL)
        _assert_params(got["params"], params, f"trainer {layout}")
        for key in ("eval_loss", "eval_masked_accuracy"):
            np.testing.assert_allclose(got["eval"][key], evaluation[key],
                                       rtol=LOSS_TOL)


@pytest.mark.parametrize("layout", ["tp", "pp"])
def test_checkpoint_across_ranks_restores_bit_equal_on_one(
        ranks, trainer_inputs, layout):
    from flasht5_tpu_torch.config import FlashT5Config
    from flasht5_tpu_torch.models import t5
    from flasht5_tpu_torch.train import Trainer, TrainerConfig
    for res in ranks:
        assert res[layout]["restored_equal"]
    one = Trainer(FlashT5Config(**trainer_inputs["config"]),
                  TrainerConfig(**TRAINER), device="cpu")
    assert one.restore_checkpoint(ranks[0][layout]["checkpoint"]) == 2
    assert one.optimizer.step_count == 2
    got = t5.tree_leaves_with_path(one.params)
    want = jax.tree_util.tree_leaves(ranks[0][layout]["params"])
    for (path, g), w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), w, err_msg=path)
    evaluation = one.evaluate(trainer_inputs["eval_batches"])
    for key in ("eval_loss", "eval_masked_accuracy"):
        np.testing.assert_allclose(evaluation[key],
                                   ranks[0][layout]["eval"][key],
                                   rtol=LOSS_TOL)


def test_dropout_masks_agree_over_tensor_and_differ_over_data(ranks):
    seeds = {}
    for res in ranks:
        d = res["dropout"]
        # whole leaves stay equal on every tensor rank after a dropout step
        assert d["whole_leaves_spread"] == 0.0
        seeds.setdefault(d["data"], set()).add(d["seed"])
    assert all(len(s) == 1 for s in seeds.values())
    assert seeds[0] != seeds[1]
