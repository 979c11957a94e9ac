"""The port's `parallel/` in one process, against the JAX package: the
tensor-parallel sharding rules leaf by leaf (plain, int8 per-channel and
group-wise, fp8 trees), the pipeline layout and its specs, AdamWScale's
`stat_batch_dims` on stacked leaves, `host_local_batch_slice`, and what
raises without a process group. The collectives run in
`test_torch_parallel_multiproc.py`, across four gloo ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.optim import adamw_scale
from flasht5_tpu.parallel import distributed as jdist
from flasht5_tpu.parallel import pp_step as jpp
from flasht5_tpu.parallel.sharding import param_pspecs as jax_pspecs
from flasht5_tpu.quantize import quantize_params as jax_quantize
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.models import t5
from flasht5_tpu_torch.ops.quant import QuantizedTensor
from flasht5_tpu_torch.optim import AdamWScale
from flasht5_tpu_torch.parallel import distributed, pp_step, sharding
from flasht5_tpu_torch.parallel.mesh import make_mesh
from flasht5_tpu_torch.parallel.tp_step import optimizer_groups
from flasht5_tpu_torch.train import Trainer, TrainerConfig

TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, dropout_rate=0.0, dtype="float32", pad_token_id=0)


@functools.lru_cache(maxsize=None)
def _jax_params(pe="t5"):
    return jt5.init_params(jax.random.PRNGKey(0),
                           JaxConfig(**TINY, position_encoding_type=pe))


def _spec_dim(spec):
    """A JAX PartitionSpec as the port writes it: the split dimension."""
    dims = [i for i, a in enumerate(spec) if a is not None]
    return dims[0] if dims else None


def _port_specs(tree, path=""):
    """[(keystr path, spec)] of the port's spec tree, a QuantizedTensor's
    two parts as JAX writes them (.qvalues, .scales)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _port_specs(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _port_specs(v, f"{path}[{i}]")]
    if isinstance(tree, QuantizedTensor):
        return [(path + ".qvalues", tree.qvalues),
                (path + ".scales", tree.scales)]
    return [(path, tree)]


def _to_port(tree):
    """The port's tree of a JAX tree, QuantizedTensors kept as such (the
    specs read only shapes)."""
    def conv(node):
        if hasattr(node, "qvalues"):
            return QuantizedTensor(torch.zeros(node.qvalues.shape),
                                   torch.zeros(node.scales.shape))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, np.float32))
    return conv(tree)


@pytest.mark.parametrize("pe,quant", [("t5", None), ("FIRE", None),
                                     ("t5", ("int8", None)),
                                     ("t5", ("int8", 32)),
                                     ("t5", ("fp8", None))])
def test_param_pspecs_match_jax_leaf_by_leaf(pe, quant):
    jparams = _jax_params(pe)
    if quant is not None:
        jparams = jax_quantize(jparams, quant[0], group_size=quant[1])
    want = [(jax.tree_util.keystr(p), _spec_dim(s)) for p, s in
            jax.tree_util.tree_leaves_with_path(
                jax_pspecs(jparams),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    got = _port_specs(sharding.param_pspecs(_to_port(jparams)))
    assert got == want
    # each rule shows up in the tree
    kinds = {s for _, s in got}
    assert kinds == {None, sharding.ROW, sharding.COL}


def test_pp_layout_and_specs_match_jax():
    jparams = _jax_params()
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    jpp_params = jpp.to_pp_params(jparams)
    pp = pp_step.to_pp_params(params)
    want = jax.tree_util.tree_leaves_with_path(jpp_params)
    got = t5.tree_leaves_with_path(pp)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), path)
    back = t5.tree_leaves_with_path(pp_step.from_pp_params(pp))
    orig = t5.tree_leaves_with_path(params)
    assert [p for p, _ in back] == [p for p, _ in orig]
    for (path, g), (_, w) in zip(back, orig):
        assert torch.equal(g, w), path
    specs = [s for _, s in t5.tree_leaves_with_path(
        pp_step.pp_param_pspecs(pp))]
    jspecs = [_spec_dim(s) for s in jax.tree_util.tree_leaves(
        jpp.pp_param_pspecs(jpp_params),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert specs == jspecs
    dims = [d for _, d in t5.tree_leaves_with_path(
        pp_step.pp_stat_batch_dims(pp))]
    assert dims == jax.tree_util.tree_leaves(
        jpp.pp_stat_batch_dims(jpp_params))


def test_adamw_scale_stat_batch_dims_matches_jax():
    """Stacked leaves, each layer its own rms (stat_batch_dims 1), beside
    a leaf taken whole, three steps on random gradients."""
    rng = np.random.default_rng(3)
    leaves = {"stacked": (rng.standard_normal((3, 8, 5)) * [[[0.01]],
                                                            [[1.0]],
                                                            [[0.3]]]),
              "whole": rng.standard_normal((4, 6))}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    jtree = {k: jnp.asarray(v) for k, v in leaves.items()}
    tx = adamw_scale(1e-2, weight_decay=0.1,
                     stat_batch_dims={"stacked": 1, "whole": 0})
    state = tx.init(jtree)
    mine = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
    opt = AdamWScale([{"params": [mine["stacked"]], "stat_batch_dims": 1},
                      {"params": [mine["whole"]]}], lr=1e-2,
                     weight_decay=0.1)
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in leaves.items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                               state, jtree)
        jtree = optax.apply_updates(jtree, upd)
        for k, p in mine.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        # f32: the port's AdamWScale tests' tolerance
        for k, p in mine.items():
            np.testing.assert_allclose(p.numpy(), np.asarray(jtree[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step + 1} {k}")


def test_adamw_scale_refuses_bad_stat_batch_dims():
    with pytest.raises(ValueError):
        AdamWScale([torch.zeros(3)], stat_batch_dims=2)
    with pytest.raises(ValueError):
        AdamWScale([torch.zeros(3)], stat_batch_dims=-1)


def test_optimizer_groups_split_by_decay_and_statistics():
    named = [("['a']['layer_norm']['weight']", torch.zeros(2)),
             ("['a']['Wq']", torch.zeros(2, 2)),
             ("['a']['o']", torch.zeros(2, 2))]
    groups = optimizer_groups(named, 0.1, stat_axes=[None, None, "g"])
    assert [(len(g["params"]), g["weight_decay"], g["stat_axes"])
            for g in groups] == [(1, 0.1, None), (1, 0.1, "g"),
                                 (1, 0.0, None)]


def test_host_local_batch_slice_without_a_process_group():
    assert distributed.host_local_batch_slice(12) == \
        jdist.host_local_batch_slice(12) == slice(0, 12)


def test_degrees_and_meshes_raise_without_a_process_group():
    cfg = FlashT5Config(**TINY)
    for kw in (dict(data_parallel=2), dict(tensor_parallel=2),
               dict(pipeline_parallel=2)):
        with pytest.raises(RuntimeError, match="process group"):
            Trainer(cfg, TrainerConfig(**kw), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg.replace(tp_axis="tensor"), TrainerConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, 2)
    params = t5.init_params(cfg, device="cpu")
    ids = torch.ones((1, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="mesh"):
        t5.forward(cfg.replace(tp_axis="tensor"), params, input_ids=ids,
                   labels=ids)


@pytest.mark.parametrize("change", [dict(dropout_rate=0.1),
                                    dict(num_layers=3)])
def test_pp_refusals_match_jax(change):
    """JAX pp_step.py:227-233: dropout, and stages that do not divide the
    layers."""
    jcfg = JaxConfig(**dict(TINY, **change))
    mesh = jpp.make_pp_mesh(2, 1)
    with pytest.raises(ValueError):
        jpp.make_pp_train_step(jcfg, mesh, adamw_scale(1e-3))
    with pytest.raises(ValueError):
        pp_step.check_pp_config(FlashT5Config(**dict(TINY, **change)), 2)
