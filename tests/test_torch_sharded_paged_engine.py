"""Serving across ranks with paged KV: the port's ShardedPagedEngine in four
gloo ranks on the CPU against the JAX package's paged engine.

Widths, engine settings and requests are JAX
tests/test_sharded_paged_engine.py's (d_model 64, 4 heads of 16, d_ff 128,
vocab 256, 2 + 2 layers, f32, `ref` attention; 4 slots, pages of 8, 3 a
slot, encode buckets 16/32/64, windows of 4; 7 requests of up to 12 new
tokens), the JAX parameters carried across; one spawn of the four ranks
serves the module (`torch_parallel_ranks.py`).

At mesh (2, 2), with 12 pages a data rank, the served tokens must equal
the JAX single-device `PagedInferenceEngine`'s with the same pages a data
rank (24) exactly, request by request, as JAX's own sharded paged engine's
do: int8 KV, native KV, and int8 weights with int8 KV. Then an
oversubscribed pool: 3 pages a data rank, where each request needs 2 (13
tokens of KV in pages of 8), so each rank's two slots cannot both hold a
request and admissions wait on a rank's own free list; every rank must
count the same deferred admissions (at least one) and serve the roomy
pool's tokens. (JAX's test of that name gives 6 pages a data rank, which
hold both slots' requests at these settings, so nothing waits there.)
"""

import dataclasses

import jax
import numpy as np
import pytest

from flasht5_tpu.config import FlashT5Config as JaxConfig
from flasht5_tpu.inference import paged_engine as jpaged
from flasht5_tpu.inference.engine import Request as JaxRequest
from flasht5_tpu.models import t5 as jt5
from flasht5_tpu.ops.quant import QuantizedTensor as JaxQT
from flasht5_tpu.quantize import quantize_params as jax_quantize_params
from flasht5_tpu_torch.config import FlashT5Config
from flasht5_tpu_torch.convert import params_from_numpy
from flasht5_tpu_torch.inference.paged_engine import PagedEngineConfig
from flasht5_tpu_torch.inference.sharded_paged_engine import (
    ShardedPagedEngine)
from torch_parallel_ranks import spawn

TINY = dict(vocab_size=256, d_model=64, d_kv=16, num_heads=4, d_ff=128,
            num_layers=2, num_decoder_layers=2, dropout_rate=0.0,
            use_glu_mlp=True, use_gelu_act=True, attention_scale=1.0,
            position_encoding_type="t5", attention_type="ref",
            use_fused_crossentropy=False, pad_token_id=0, dtype="float32")
ECFG = dict(max_slots=4, page_size=8, max_pages_per_slot=3,
            max_encode_len=64, encode_buckets=(16, 32, 64),
            steps_per_sync=4)
DATA, PAGES = 2, 12


def _requests(n=7, seed=3):
    """(uid, input_ids, max_new_tokens, arrival_s), JAX's `_requests`."""
    rng = np.random.RandomState(seed)
    out = []
    for uid in range(n):
        ids = rng.randint(2, 250, size=(int(rng.randint(5, 40)),)).astype(
            np.int32)
        out.append((uid, ids, 12, 0.0))
    return out


REQUESTS = {"seven": _requests()}
# name: (params, kv dtype, pages a data rank); the reference is JAX's
# single-device engine on the same params and kv dtype with PAGES x DATA
CASES = {"int8kv": ("f32", "int8", PAGES),
         "native": ("f32", "native", PAGES),
         "int8w_int8kv": ("int8", "int8", PAGES),
         "oversubscribed": ("f32", "int8", 3)}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(
        lambda x: ((np.asarray(x.qvalues), np.asarray(x.scales))
                   if isinstance(x, JaxQT) else np.asarray(x)),
        tree, is_leaf=lambda x: isinstance(x, JaxQT))


@pytest.fixture(scope="module")
def jax_params():
    params = jt5.init_params(jax.random.PRNGKey(0), JaxConfig(**TINY))
    return {"f32": params, "int8": jax_quantize_params(params)}


@pytest.fixture(scope="module")
def ranks(jax_params, tmp_path_factory):
    cases = [dict(name=name, mesh=(DATA, 2), params=p,
                  ecfg=dict(kv_dtype=kv, num_pages=pages), requests="seven")
             for name, (p, kv, pages) in CASES.items()]
    inp = {"config": TINY, "ecfg": ECFG, "requests": REQUESTS,
           "cases": cases,
           "params": {k: _numpy_tree(v) for k, v in jax_params.items()}}
    return spawn("paged_serving", inp, tmp_path_factory.mktemp("paged"))


@pytest.fixture(scope="module")
def jax_tokens(jax_params):
    cache = {}

    def served(params, kv):
        if (params, kv) not in cache:
            eng = jpaged.PagedInferenceEngine(
                JaxConfig(**TINY), jax_params[params],
                jpaged.PagedEngineConfig(num_pages=PAGES * DATA, kv_dtype=kv,
                                         **ECFG))
            reqs = [JaxRequest(uid=u, input_ids=ids, max_new_tokens=m)
                    for u, ids, m, _ in REQUESTS["seven"]]
            cache[params, kv] = {r.uid: r.result for r in eng.run(reqs)}
        return cache[params, kv]
    return served


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_paged_tokens_match_jax(ranks, jax_tokens, case):
    params, kv, _ = CASES[case]
    want = jax_tokens(params, kv)
    deferrals = {res[case]["deferrals"] for res in ranks}
    assert len(deferrals) == 1, deferrals      # every rank's scheduler agrees
    if case == "oversubscribed":
        assert deferrals.pop() >= 1
    for r, res in enumerate(ranks):
        got = res[case]["tokens"]
        assert sorted(got) == sorted(want)
        for uid, toks in want.items():
            np.testing.assert_array_equal(got[uid], toks,
                                          err_msg=f"{case} rank {r} uid {uid}")


class _Mesh:
    """A mesh's shape alone: the refusals come before any collective."""
    mesh_dim_names = ("data", "tensor")

    def __init__(self, data):
        self._shape = (data, 1)

    def size(self, i):
        return self._shape[i]


@dataclasses.dataclass
class _SpecConfig(PagedEngineConfig):
    spec_window: int = 2


@pytest.mark.parametrize("ecfg,match", [
    (PagedEngineConfig(kernel="dense", **ECFG), "production"),
    (PagedEngineConfig(window_appends=False, **ECFG), "production"),
    (PagedEngineConfig(dense_read_max=64, **ECFG), "dense_read_max"),
    (PagedEngineConfig(window_stage_max_bytes=1 << 20, **ECFG),
     "dense_read_max"),
    (PagedEngineConfig(**{**ECFG, "max_slots": 6}), "split"),
    (_SpecConfig(**ECFG), "speculative")],
    ids=["dense", "stepwise", "dense_read", "window_stage", "slots",
         "spec_window"])
def test_sharded_paged_engine_refusals(ecfg, match):
    params = params_from_numpy(_numpy_tree(jt5.init_params(
        jax.random.PRNGKey(0), JaxConfig(**TINY))), device="cpu")
    with pytest.raises(ValueError, match=match):
        ShardedPagedEngine(FlashT5Config(**TINY), params, ecfg, _Mesh(4),
                           device="cpu")
