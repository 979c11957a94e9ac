"""The port's flash attention with a bias against the JAX package's.

`flasht5_tpu_torch.ops.flash_attention.flash_attention(q, k, v, bias)` on the
CPU (the plain versions of its three kernels) against
`flasht5_tpu.ops.flash_attention.flash_attention` (its Pallas kernels in
interpret mode, tests/conftest.py): the output and the gradients of q, k, v
and the bias, on the same inputs made from a numpy seed.

Tolerances: in float32 both sides compute the same arithmetic and differ in
summation order only: 1e-5 absolute, 1e-4 relative. In bfloat16 both round
P and dS to bf16 at the same points, but a value one f32 ulp apart on the
two sides can round to the neighbouring bf16 value (2^-8 relative) and move
the sums it enters: each output within 1e-2 of its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flasht5_tpu.ops import flash_attention as jfa
from flasht5_tpu_torch.ops import flash_attention as fa

B, H, D = 2, 3, 32
SCALE = 0.6

# (bias shape tag, M, N, causal, dtype, masked row)
CASES = {
    "1hmn": ("1h", 48, 48, False, "float32", False),
    "bhmn": ("bh", 48, 48, False, "float32", False),
    "11mn": ("11", 48, 48, False, "float32", False),
    "b1mn": ("b1", 48, 48, False, "float32", False),
    "causal_m_lt_n": ("1h", 40, 72, True, "float32", False),
    "causal_m_gt_n": ("1h", 72, 40, True, "float32", False),
    "ragged": ("bh", 40, 72, False, "float32", False),
    "masked_row": ("bh", 48, 48, False, "float32", True),
    "bf16": ("1h", 40, 72, True, "bfloat16", False),
}
_LEAD = {"1h": (1, H), "bh": (B, H), "11": (1, 1), "b1": (B, 1)}


def _inputs(form, m_len, n_len, dtype, masked_row, seed=0):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":     # both sides see the same bf16 values
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        return a
    q, do = arr(B, H, m_len, D), arr(B, H, m_len, D)
    k, v = arr(B, H, n_len, D), arr(B, H, n_len, D)
    bias = rng.standard_normal((*_LEAD[form], m_len, n_len)).astype(
        np.float32)
    if masked_row:      # use_masking's fold: a padded query row
        bias[1, :, 5] = np.finfo(np.float32).min
    return q, k, v, bias, do


@pytest.mark.parametrize("case", list(CASES))
def test_bias_attention_matches_jax(case):
    form, m_len, n_len, causal, dtype, masked_row = CASES[case]
    q, k, v, bias, do = _inputs(form, m_len, n_len, dtype, masked_row)
    jdt = jnp.dtype(dtype)
    o_j, vjp = jax.vjp(
        lambda a, b, c, s: jfa.flash_attention(a, b, c, s, causal=causal,
                                               sm_scale=SCALE),
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(bias))
    want = (o_j,) + vjp(jnp.asarray(do, jdt))

    tdt = getattr(torch, dtype)
    ts = [torch.tensor(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    tb = torch.tensor(bias).requires_grad_(True)
    o = fa.flash_attention(*ts, tb, causal=causal, sm_scale=SCALE)
    o.backward(torch.tensor(do).to(tdt))
    got = [o.detach()] + [t.grad for t in ts] + [tb.grad]

    assert o.dtype == tdt and tb.grad.shape == bias.shape
    for name, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4,
                                       err_msg=name)
        else:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), name
    if masked_row:      # clamped at -1e29: no gradient, uniform attention
        assert np.all(got[4][1, :, 5].numpy() == 0)
        np.testing.assert_allclose(got[0][1, :, 5].numpy(),
                                   v[1].mean(axis=1), atol=1e-5)


def test_bias_attention_refuses_a_bias_it_does_not_take():
    x = torch.zeros((2, 3, 8, 32))
    with pytest.raises(ValueError, match="4-D"):
        fa.flash_attention(x, x, x, torch.zeros((8, 8)))
    meta = torch.zeros((2, 3, 8, 32), device="meta")
    with pytest.raises(ValueError, match="bias"):
        fa.flash_attention_bias_fwd(meta, meta, meta,
                                    torch.zeros((1, 2, 8, 8), device="meta"))
