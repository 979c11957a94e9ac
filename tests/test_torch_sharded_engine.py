"""Serving across ranks: the port's ShardedEngine in four gloo ranks on the
CPU against the JAX package's engines.

Widths, engine settings and requests are JAX tests/test_sharded_engine.py's
(d_model 64, 4 heads of 16, d_ff 128, vocab 256, 2 + 2 layers, f32, `ref`
attention; 4 slots, decode 16, encode buckets 16/32/64, windows of 4), the
JAX parameters carried across. One spawn of the four ranks serves the
module (`torch_parallel_ranks.py`, whose ranks import torch and the port
only); each JAX reference is computed once.

The served tokens must equal the JAX single-device `InferenceEngine`'s
exactly, request by request, as JAX's own sharded engine's do: at meshes
(2, 2), (4, 1) and (1, 4) with native KV; with int8 KV; with int8 weights
per channel at (1, 4) and in groups of 64 at (2, 2) (the weight's row
split keeps whole groups there); with more requests than slots; and with
requests that arrive over time while every rank reads its own clock. The
(2, 2) native case is also held to JAX's `ShardedEngine`. `probe_step`'s
full (B, V) logits are held to JAX's single-device probe at 1e-5, and the
ring reduce-scatter (`use_collective_matmul`) to the all-reduce at JAX's
rtol 1e-4 / atol 1e-5 (the ring sums in another order).
"""

import jax
import numpy as np
import pytest

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.inference import engine as jengine
from flasht5_tpu.inference.sharded_engine import ShardedEngine as JaxSharded
from flasht5_tpu.inference.sharded_engine import make_serving_mesh
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.ops.quant import QuantizedTensor as JaxQT
from flasht5_tpu.quantize import quantize_params as jax_quantize_params
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.inference.engine import EngineConfig
from flasht5_tpu_torch.inference.sharded_engine import ShardedEngine
from torch_parallel_ranks import spawn

TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            use_glu_mlp=True, use_gelu_act=True, attention_scale=1.0,
            position_encoding_type="t5", attention_type="ref",
            use_fused_crossentropy=False, pad_token_id=0, dtype="float32")
ECFG = dict(max_slots=4, max_decode_len=16, max_encode_len=64,
            encode_buckets=(16, 32, 64), steps_per_sync=4)
PROBE_TOL = dict(rtol=1e-5, atol=1e-5)
RING_TOL = dict(rtol=1e-4, atol=1e-5)


def _requests(n, seed, arrivals=False):
    """(uid, input_ids, max_new_tokens, arrival_s), JAX's `_requests`."""
    rng = np.random.RandomState(seed)
    out = []
    for uid in range(n):
        ids = rng.randint(2, 250, size=(int(rng.randint(5, 40)),)).astype(
            np.int32)
        out.append((uid, ids, 12, 0.05 * uid if arrivals else 0.0))
    return out


REQUESTS = {"six": _requests(6, 3), "ten": _requests(10, 11),
            "two": _requests(2, 5), "three": _requests(3, 5),
            "arrivals": _requests(6, 3, arrivals=True)}

# name: (mesh, params, engine config changes, requests, extra)
CASES = {
    "native_2x2": ((2, 2), "f32", {}, "six", {}),
    "native_4x1": ((4, 1), "f32", {}, "six", {}),
    "native_1x4": ((1, 4), "f32", {}, "six", {}),
    "int8kv_2x2": ((2, 2), "f32", {"kv_dtype": "int8"}, "six", {}),
    "int8w_channel_1x4": ((1, 4), "int8", {"kv_dtype": "int8"}, "six", {}),
    "int8w_g64_2x2": ((2, 2), "int8_g64", {"kv_dtype": "int8"}, "six", {}),
    "more_requests_2x2": ((2, 2), "f32", {}, "ten", {}),
    "arrivals_2x2": ((2, 2), "f32", {}, "arrivals", {"clock": 0.002}),
    "probe_2x2": ((2, 2), "f32", {}, "two", {"probe": 1}),
    "ring_off_1x4": ((1, 4), "f32", {}, "three", {"probe": 3}),
    "ring_on_1x4": ((1, 4), "f32", {}, "three",
                    {"probe": 3, "config": {"use_collective_matmul": True}}),
}
# the JAX single-device run each token case is held to
REFERENCE = {"native_2x2": ("f32", "native", "six"),
             "native_4x1": ("f32", "native", "six"),
             "native_1x4": ("f32", "native", "six"),
             "int8kv_2x2": ("f32", "int8", "six"),
             "int8w_channel_1x4": ("int8", "int8", "six"),
             "int8w_g64_2x2": ("int8_g64", "int8", "six"),
             "more_requests_2x2": ("f32", "native", "ten"),
             "arrivals_2x2": ("f32", "native", "six")}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: ((np.asarray(x.qvalues), np.asarray(x.scales))
                   if isinstance(x, JaxQT) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, JaxQT))


@pytest.fixture(scope="module")
def jax_params():
    params = jt5.init_params(jax.random.PRNGKey(0), JaxConfig(**TINY))
    return {"f32": params,
            "int8": jax_quantize_params(params, "int8"),
            "int8_g64": jax_quantize_params(params, "int8", group_size=64)}


@pytest.fixture(scope="module")
def ranks(jax_params, tmp_path_factory):
    cases = [dict(name=name, mesh=mesh, params=p, ecfg=ecfg,
                  requests=reqs, **extra)
             for name, (mesh, p, ecfg, reqs, extra) in CASES.items()]
    inp = {"config": TINY, "ecfg": ECFG, "requests": REQUESTS,
           "cases": cases,
           "params": {k: _numpy_tree(v) for k, v in jax_params.items()}}
    return spawn("serving", inp, tmp_path_factory.mktemp("serving"))


def _jax_requests(name):
    return [jengine.Request(uid=u, input_ids=ids, max_new_tokens=m)
            for u, ids, m, _ in REQUESTS[name]]


@pytest.fixture(scope="module")
def jax_tokens(jax_params):
    """The JAX single-device engine's tokens by uid, once a reference."""
    cache = {}

    def served(params, kv, reqs):
        key = (params, kv, reqs)
        if key not in cache:
            eng = jengine.InferenceEngine(
                JaxConfig(**TINY), jax_params[params],
                jengine.EngineConfig(kv_dtype=kv, **ECFG))
            cache[key] = {r.uid: r.result
                          for r in eng.run(_jax_requests(reqs))}
        return cache[key]
    return served


@pytest.mark.parametrize("case", list(REFERENCE))
def test_sharded_tokens_match_jax(ranks, jax_tokens, case):
    want = jax_tokens(*REFERENCE[case])
    assert len(want) == len(REQUESTS[REFERENCE[case][2]])
    for r, res in enumerate(ranks):
        got = res[case]["tokens"]
        assert sorted(got) == sorted(want), (r, case)
        for uid, toks in want.items():
            assert got[uid] is not None, (r, case, uid)
            np.testing.assert_array_equal(got[uid], toks,
                                          err_msg=f"{case} rank {r} uid {uid}")


def test_sharded_tokens_match_jax_sharded_engine(ranks, jax_params):
    """The (2, 2) native case against JAX's own ShardedEngine there."""
    eng = JaxSharded(JaxConfig(**TINY), jax_params["f32"],
                     jengine.EngineConfig(**ECFG), make_serving_mesh(2, 2))
    want = {r.uid: r.result for r in eng.run(_jax_requests("six"))}
    for res in ranks:
        for uid, toks in want.items():
            np.testing.assert_array_equal(res["native_2x2"]["tokens"][uid],
                                          toks, err_msg=f"uid {uid}")


def test_probe_logits_match_jax(ranks, jax_params):
    """`probe_step`'s every-slot tokens and full (B, V) logits, gathered
    over "tensor" and "data", against JAX's single-device probe."""
    eng = jengine.InferenceEngine(JaxConfig(**TINY), jax_params["f32"],
                                  jengine.EngineConfig(**ECFG))
    for i, r in enumerate(_jax_requests("two")):
        eng.admit_request(r, i)
    want_tok, want_logits = eng.probe_step()
    for res in ranks:
        (tok, logits), = res["probe_2x2"]
        assert logits.shape == (ECFG["max_slots"], TINY["vocab_size"])
        np.testing.assert_array_equal(tok, want_tok)
        np.testing.assert_allclose(logits, want_logits, **PROBE_TOL)


def test_ring_matches_the_all_reduce(ranks):
    for res in ranks:
        for (tok_ar, log_ar), (tok_ring, log_ring) in zip(
                res["ring_off_1x4"], res["ring_on_1x4"]):
            np.testing.assert_allclose(log_ring, log_ar, **RING_TOL)


class _Mesh:
    """A mesh's shape alone: the refusals come before any collective."""
    mesh_dim_names = ("data", "tensor")

    def __init__(self, data, tensor=1, names=None):
        self._shape = (data, tensor)
        if names:
            self.mesh_dim_names = names

    def size(self, i):
        return self._shape[i]


@pytest.mark.parametrize("mesh,change,match", [
    (_Mesh(4), dict(max_slots=6), "split"),
    (_Mesh(3), dict(max_slots=6), "power of two"),
    (_Mesh(2), dict(spec_window=2), "speculative"),
    (_Mesh(1, names=("pipe", "data")), {}, "dimensions")],
    ids=["slots", "power_of_two", "spec_window", "mesh"])
def test_sharded_engine_refusals(change, mesh, match):
    params = params_from_numpy(_numpy_tree(jt5.init_params(
        jax.random.PRNGKey(0), JaxConfig(**TINY))), device="cpu")
    with pytest.raises(ValueError, match=match):
        ShardedEngine(FlashT5Config(**TINY), params,
                      EngineConfig(**{**ECFG, **change}), mesh, device="cpu")
