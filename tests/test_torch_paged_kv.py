"""The paged KV pool and paged decode attention of the port against the JAX
package's, on the CPU.

The port's paged functions run their plain version here (CPU tensors); the
JAX kernels run in Pallas interpret mode (tests/conftest.py), once per
route, on one hard case: an int8 pool, a bias, a fragmented page table, an
empty slot and lengths that are not multiples of the page size. The other
cases are held against the JAX package's plain functions
(`paged_decode_attention_ref`, `gather_pool_dense`, `dense_cache_attention`).
`paged_decode_attention_ref` gives a slot of length 0 the mean of its V
rows (a softmax over scores that are all -1e30), where every kernel gives
0; it is compared on the live slots only.

Tolerances: 1e-5 (absolute and relative) for f32 and int8 pools. Both sides
compute in f32 and differ in summation order and in where the int8 scales
enter (the JAX (slot, page) and ragged kernels dequantize K/V first; its
chunked kernel and the port fold the scales into the scores and into P).
For a bf16 pool the port rounds q, K, P and V to bf16 as the TPU kernels
do, while the JAX oracle computes in f32 on the bf16 values: 2e-2, about
two bf16 ulps of outputs of size ~1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.inference import paged_kv as jpk
from flasht5_tpu_torch.inference import paged_kv as pk
from flasht5_tpu_torch.ops import paged_attention as pa

H, D, P, MAXP, SLOTS, NPAGES = 2, 32, 8, 4, 4, 20
LENGTHS = (19, 0, 32, 5)     # an empty slot, a full one, two partial pages
SM_SCALE = 0.3
TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed=0):
    """Pages, scales, a fragmented table, q and a bias as numpy arrays; an
    int8 pool is the port's quantize_kv of the same normal values (the JAX
    package's formula)."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(NPAGES, H, P, D)).astype(np.float32)
    v = rng.normal(size=(NPAGES, H, P, D)).astype(np.float32)
    kq, ks = (np.asarray(t) for t in pk.quantize_kv(torch.from_numpy(k)))
    vq, vs = (np.asarray(t) for t in pk.quantize_kv(torch.from_numpy(v)))
    table = rng.permutation(NPAGES)[:SLOTS * MAXP].reshape(SLOTS, MAXP)
    return dict(k=k, v=v, kq=kq, ks=ks, vq=vq, vs=vs,
                table=table.astype(np.int32),
                lengths=np.asarray(LENGTHS, np.int32),
                q=rng.normal(size=(SLOTS, H, D)).astype(np.float32),
                bias=(0.5 * rng.normal(size=(SLOTS, H, MAXP * P))
                      ).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))     # a writable copy


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# every route against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["arrays", "ragged", "chunked_packed"])
def test_paged_routes_match_jax_kernels(route):
    a = _arrays()
    jargs = [jnp.asarray(a[n]) for n in ("kq", "vq", "ks", "vs")]
    targs = [_t(a[n]) for n in ("kq", "vq", "ks", "vs")]
    common = dict(sm_scale=SM_SCALE)
    jq, jt, jl, jb = (jnp.asarray(a[n]) for n in ("q", "table", "lengths",
                                                  "bias"))
    tq, tt, tl, tb = (_t(a[n]) for n in ("q", "table", "lengths", "bias"))
    if route == "chunked_packed":
        want = jpk.paged_decode_attention_chunked_packed(
            jq, *jpk.pack_kv_pages_fused(*jargs), jt, jl, bias=jb, chunk=2,
            return_state=True, **common)
        got = pk.paged_decode_attention_chunked_packed(
            tq, *pk.pack_kv_pages_fused(*targs), tt, tl, bias=tb,
            return_state=True, **common)
        assert len(got) == 3
        for g, w in zip(got, want):
            _close(g, w)
        # the empty slot's state is the kernel's: out 0, m -1e30, l 0
        assert torch.all(got[1][1] == -1e30) and not got[2][1].any()
        return
    fn = {"arrays": "paged_decode_attention_arrays",
          "ragged": "paged_decode_attention_ragged"}[route]
    want = getattr(jpk, fn)(jq, *jargs, jt, jl, bias=jb, **common)
    got = getattr(pk, fn)(tq, *targs, tt, tl, bias=tb, **common)
    _close(got, want)
    assert not got[1].any()


# ---------------------------------------------------------------------------
# the other cases against the JAX package's plain functions
# ---------------------------------------------------------------------------

def _pools(kv, a):
    """(JAX pool, port pool) holding the same pages, table and lengths."""
    quant = kv == "int8"
    jpool = jpk.PagedKVPool(NPAGES, H, P, D, SLOTS, MAXP, quantized=quant)
    pool = pk.PagedKVPool(NPAGES, H, P, D, SLOTS, MAXP, quantized=quant,
                          dtype=torch.bfloat16 if kv == "bf16"
                          else torch.float32, device="cpu")
    if quant:
        vals = {"pages_k": a["kq"], "pages_v": a["vq"], "scales_k": a["ks"],
                "scales_v": a["vs"]}
    else:
        vals = {"pages_k": a["k"], "pages_v": a["v"]}
    for name, x in vals.items():
        t = _t(x)
        if kv == "bf16":
            t = t.to(torch.bfloat16)
        setattr(pool, name, t)
        setattr(jpool, name, jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16) if kv == "bf16" else jnp.asarray(x))
    jpool.page_table, pool.page_table = jnp.asarray(a["table"]), _t(a["table"])
    jpool.lengths, pool.lengths = jnp.asarray(a["lengths"]), _t(a["lengths"])
    return jpool, pool


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_paged_decode_attention_matches_oracle(kv, with_bias):
    a = _arrays(1)
    jpool, pool = _pools(kv, a)
    bias = a["bias"] if with_bias else None
    want = jpk.paged_decode_attention_ref(
        jnp.asarray(a["q"]), jpool, sm_scale=SM_SCALE,
        bias=None if bias is None else jnp.asarray(bias))
    got = pk.paged_decode_attention(_t(a["q"]), pool, sm_scale=SM_SCALE,
                                    bias=None if bias is None else _t(bias))
    assert got.dtype == torch.float32 and got.shape == (SLOTS, H, D)
    live = a["lengths"] > 0
    _close(got[live], np.asarray(want)[live],
           **(dict(rtol=2e-2, atol=2e-2) if kv == "bf16" else {}))
    assert not got[~live].any()
    # the port's own oracle is the JAX one, empty slot included
    _close(pk.paged_decode_attention_ref(_t(a["q"]), pool, sm_scale=SM_SCALE,
                                         bias=None if bias is None
                                         else _t(bias)), want)
    # the fused layout and the standard one give the same result
    chunked = pk.paged_decode_attention_chunked(
        _t(a["q"]), pool.pages_k, pool.pages_v, pool.scales_k, pool.scales_v,
        pool.page_table, pool.lengths, sm_scale=SM_SCALE,
        bias=None if bias is None else _t(bias))
    torch.testing.assert_close(chunked, got, rtol=0, atol=0)


def test_released_slot_attends_to_nothing():
    a = _arrays(2)
    jpool, pool = _pools("int8", a)
    owned = [[int(x) for x in row] for row in a["table"]]
    free = [x for x in range(NPAGES) if x not in a["table"]]
    jpool._owned, jpool._free = owned, free
    pool.allocator.owned, pool.allocator.free = list(owned), list(free)
    for p in (jpool, pool):
        p.release(2)
    assert int(pool.lengths[2]) == 0
    assert len(pool.allocator.free) == len(jpool._free)
    want = np.asarray(jpk.paged_decode_attention_ref(jnp.asarray(a["q"]),
                                                     jpool))
    got = pk.paged_decode_attention(_t(a["q"]), pool)
    _close(got[[0, 3]], want[[0, 3]])
    assert not got[2].any() and not got[1].any()


@pytest.mark.parametrize("quantized", [False, True])
def test_gather_and_dense_attention_match_jax(quantized):
    a = _arrays(3)
    names = ("kq", "vq", "ks", "vs") if quantized else ("k", "v")
    jpacked = jpk.pack_kv_pages_fused(*(jnp.asarray(a[n]) for n in names))
    fused = pk.pack_kv_pages_fused(*(_t(a[n]) for n in names))
    if not quantized:
        jpacked, fused = (jpacked[0], None), (fused[0], None)
    jt, tt = jnp.asarray(a["table"]), _t(a["table"])
    jkf, jvf = jpk.gather_pool_dense(*jpacked, jt, head_dim=D)
    kf, vf = pk.gather_pool_dense(*fused, tt)
    _close(kf, jkf, rtol=0, atol=0)
    _close(vf, jvf, rtol=0, atol=0)
    (kv_, ks_), _ = pk.gather_pool_dense(*fused, tt, dequant=False)
    assert kv_.dtype == (torch.int8 if quantized else torch.float32)
    assert (ks_ is None) != quantized
    want = jpk.dense_cache_attention(
        jnp.asarray(a["q"]), jkf, jvf, jnp.asarray(a["lengths"]),
        sm_scale=SM_SCALE, bias=jnp.asarray(a["bias"]), return_state=True)
    got = pk.dense_cache_attention(_t(a["q"]), kf, vf, _t(a["lengths"]),
                                   sm_scale=SM_SCALE, bias=_t(a["bias"]),
                                   return_state=True)
    for g, w in zip(got, want):
        _close(g, w)
    # and the paged kernel's plain version agrees with both, state included
    paged = pk.paged_decode_attention_chunked_packed(
        _t(a["q"]), *fused, tt, _t(a["lengths"]), sm_scale=SM_SCALE,
        bias=_t(a["bias"]), return_state=True)
    for g, w in zip(paged, want):
        _close(g, w)


def test_layouts_carry_across_from_jax():
    """A JAX pool in the TPU's token-packed layout unpacks to the standard
    one; at packing factor 1 (D = 128) the JAX fused record is the port's."""
    a = _arrays(4)
    pages2, scales2 = jpk.pack_kv_pages(jnp.asarray(a["kq"]),
                                        jnp.asarray(a["ks"]))
    assert pages2.shape[-1] == 4 * D            # f = 128 // 32 tokens a row
    vals, scales = pk.unpack_kv_pages(_t(np.asarray(pages2)),
                                      _t(np.asarray(scales2)), head_dim=D)
    np.testing.assert_array_equal(vals.numpy(), a["kq"])
    np.testing.assert_array_equal(scales.numpy(), a["ks"])
    rng = np.random.default_rng(5)
    k128 = rng.normal(size=(3, H, P, 128)).astype(np.float32)
    s128 = rng.random(size=(3, H, P, 1)).astype(np.float32)
    jv, js = jpk.pack_kv_pages_fused(*(jnp.asarray(x)
                                       for x in (k128, k128, s128, s128)))
    v, s = pk.pack_kv_pages_fused(*(_t(x) for x in (k128, k128, s128, s128)))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(s.shape))


# ---------------------------------------------------------------------------
# the pool: allocator and append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_pool_append_matches_jax(quantized):
    """The same allocations and appends (a batch of slots per append) leave
    both pools with the same table, lengths, pages and scales."""
    rng = np.random.default_rng(6)
    jpool = jpk.PagedKVPool(NPAGES, H, P, D, SLOTS, MAXP, quantized=quantized)
    pool = pk.PagedKVPool(NPAGES, H, P, D, SLOTS, MAXP, quantized=quantized,
                          device="cpu")
    plan = ((0, 1, 3), (0, 3), (0, 1, 3), (3,))     # slots of each append
    for p in (jpool, pool):
        for slot, tokens in ((0, 11), (1, 2), (3, 17)):
            p.ensure_capacity(slot, tokens)
    for slots in plan * 3:
        k = rng.normal(size=(len(slots), H, D)).astype(np.float32)
        v = rng.normal(size=(len(slots), H, D)).astype(np.float32)
        jpool.append(jnp.asarray(slots), jnp.asarray(k), jnp.asarray(v))
        pool.append(torch.tensor(slots), _t(k), _t(v))
    assert pool.allocator.owned == jpool._owned == [[19, 18], [17], [],
                                                    [16, 15, 14]]
    for name in ("page_table", "lengths", "pages_k", "pages_v") + (
            ("scales_k", "scales_v") if quantized else ()):
        np.testing.assert_array_equal(getattr(pool, name).numpy(),
                                      np.asarray(getattr(jpool, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(pool.lengths.numpy(), [9, 6, 0, 12])
    pool.release(0)
    assert sorted(pool.allocator.free)[-2:] == [18, 19]
    assert int(pool.lengths[0]) == 0


def test_pool_exhaustion_and_device():
    pool = pk.PagedKVPool(num_pages=2, num_heads=2, page_size=4, head_dim=8,
                          max_slots=2, max_pages_per_slot=4, device="cpu")
    pool.ensure_capacity(0, 8)       # takes both pages
    assert pool.page_table[0, :2].tolist() == [1, 0]
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.ensure_capacity(1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pk.PagedKVPool(2, 2, 4, 8, 2, 4)


# ---------------------------------------------------------------------------
# the kernel's split over warps and a cluster, and the merge it relies on
# ---------------------------------------------------------------------------

class _NoTensorOps(torch.overrides.TorchFunctionMode):
    """Raises on any torch function or tensor method called inside it."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"the plan called {func}")


# the paged engine's serving shape (8 slots of 8 heads, 5 pages), the
# roofline shape (64 slots of 16 pages), these tests' pools, long tables,
# one page, many slots
_PAGED_SHAPES = [(8, 8, 5), (64, 8, 16), (SLOTS, H, MAXP), (4, 2, 12),
                 (6, 4, 40), (1, 1, 1), (2, 8, 3), (1, 8, 257), (64, 16, 128)]


@pytest.mark.parametrize("b,h,maxp", _PAGED_SHAPES)
def test_paged_plan_covers_pages_once(b, h, maxp):
    """The warps' shares of the table run in the kernel's merge order
    (cluster rank, then warp), cover its maxp entries once without a gap,
    and fit the kernel: a cluster of 1-8 CTAs (a power of two) of 1-4
    warps, a split CTA keeping two pages or more, the grid on the card at
    once."""
    splits, warps, pages = pa.paged_plan(b, h, maxp)
    assert splits in (1, 2, 4, 8) and 1 <= warps <= 4
    assert pages == -(-maxp // (splits * warps))
    assert splits == 1 or maxp >= 2 * splits
    assert warps == 1 or b * h * splits * warps <= 132 * 12
    pieces = pa.paged_pieces(b, h, maxp)
    assert len(pieces) == splits * warps
    assert pieces[0][0] == 0 and pieces[-1][1] == maxp
    covered = [j for a, e in pieces for j in range(a, e)]
    assert covered == list(range(maxp))


def test_paged_plan_fills_the_card():
    """The serving shape (64 (slot, head) pairs of 5 pages) runs on about
    128 CTAs of the H100's 132 SMs, a page a warp; the roofline shape's 512
    pairs on one CTA each, in one wave of the card; a plan depends on
    nothing but the shape and reads no tensor (the lengths live on the
    card, and reading them would synchronize the step)."""
    splits, warps, pages = pa.paged_plan(8, 8, 5)
    assert 8 * 8 * splits >= 128 and pages == 1
    assert pa.paged_plan(64, 8, 16) == (1, 2, 8)
    with _NoTensorOps():
        plans = [pa.paged_plan.__wrapped__(*s) for s in _PAGED_SHAPES]
        pa.paged_pieces(8, 8, 5)
    assert plans == [pa.paged_plan(*s) for s in _PAGED_SHAPES]


def _merge(states):
    """(out, m, l) states merged in order as the kernel merges them: the
    largest m, each state's sum weighted by exp(m_i - m), out = sum / l."""
    m = torch.stack([s[1] for s in states]).amax(0)
    w = [torch.exp(s[1] - m) for s in states]
    l = sum(s[2] * wi for s, wi in zip(states, w))
    acc = sum(s[0] * (s[2] * wi)[..., None] for s, wi in zip(states, w))
    return (acc / torch.where(l > 0, l, 1.0)[..., None],
            torch.where(l > 0, m, -1e30), l)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_state_merges_in_rank_order(kv):
    """paged_attention_plain over each warp's share of the table (its
    pages, its length clipped to them: shares beyond a slot's length give
    the empty state out 0, m -1e30, l 0), merged warp by warp within each
    CTA and then CTA by CTA in rank order, is the plain version over the
    whole table, an empty slot included: the state contract the kernel's
    merge relies on. f32 sums in another grouping: 1e-6."""
    rng = np.random.default_rng(11)
    b, h, p, maxp, d = 4, 2, 8, 12, 16
    n = b * maxp + 3
    k = torch.from_numpy(rng.normal(size=(n, h, p, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n, h, p, d)).astype(np.float32))
    ks = vs = None
    if kv == "int8":
        (k, ks), (v, vs) = pk.quantize_kv(k), pk.quantize_kv(v)
        ks, vs = ks[..., 0], vs[..., 0]
    table = torch.from_numpy(rng.permutation(n)[:b * maxp].reshape(
        b, maxp).astype(np.int32))
    lengths = torch.tensor([0, 1, 50, maxp * p], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(b, h, d)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(b, h, maxp * p)).astype(
        np.float32))
    kw = dict(sm_scale=0.4, return_state=True)
    whole = pa.paged_attention_plain(q, k, v, ks, vs, table, lengths,
                                     bias=bias, **kw)
    splits, warps, _ = pa.paged_plan(b, h, maxp)
    parts = []
    for a, e in pa.paged_pieces(b, h, maxp):
        if e == a:      # a share past the table: the empty state
            parts.append((torch.zeros_like(q), torch.full((b, h), -1e30),
                          torch.zeros((b, h))))
            continue
        clipped = (lengths - a * p).clamp(0, (e - a) * p).to(torch.int32)
        parts.append(pa.paged_attention_plain(
            q, k, v, ks, vs, table[:, a:e].contiguous(), clipped,
            bias=bias[..., a * p:e * p], **kw))
    assert any(float(s[2][0].sum()) == 0 for s in parts[1:])
    ctas = [_merge(parts[r * warps:(r + 1) * warps]) for r in range(splits)]
    got = _merge(ctas)
    for g, w in zip(got, whole):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    assert not got[0][0].any() and bool((got[1][0] == -1e30).all())
    assert not got[2][0].any()
