"""The operation and byte counts, against a hand count at one shape each."""

from portbench.tests import tiny  # noqa: F401
from portbench.work import bias_attn_bwd, quant_product, t5_model


def test_quant_product():
    flops, nbytes = quant_product.work(m=2, k=32, n=16)
    assert flops == 2 * 2 * 32 * 16
    # x bf16 2*32*2, w int8 32*16, scales 16*4, out bf16 2*16*2
    assert nbytes == 128 + 512 + 64 + 64


def test_bias_attention_backward():
    flops, nbytes = bias_attn_bwd.work(batch=2, heads=3, m=4, n=4, d=8,
                                       causal=False)
    assert flops == 10 * 2 * 3 * 16 * 8
    # q, o, do, k, v, dq, dk, dv: 8 bf16 (2, 3, 4, 8) tensors; lse f32
    # (2, 3, 4); bias and dbias f32 (3, 4, 4)
    assert nbytes == 8 * 2 * 3 * 4 * 8 * 2 + 2 * 3 * 4 * 4 + 2 * 3 * 16 * 4
    causal, _ = bias_attn_bwd.work(batch=2, heads=3, m=4, n=4, d=8,
                                   causal=True)
    assert causal == 10 * 2 * 3 * (1 + 2 + 3 + 4) * 8


def test_t5_step():
    m = dict(d_model=4, d_kv=2, num_heads=2, d_ff=8, num_layers=1,
             vocab_size=10)
    # encoder, 3 tokens: 3 * 2 * (4 * 4 * 4 + 3 * 4 * 8) linear, 4 * 9 * 4
    # attention, cross K/V 3 * 2 * 2 * 4 * 4
    assert t5_model.encode_flops(m, 3) == 3 * 2 * 160 + 144 + 192
    # decoder, 2 tokens over 3 encoder states: 2 * 2 * (6 * 16 + 96)
    # linear, 4 * 4 * 3 causal, 4 * 4 * 2 * 3 cross, lm_head 2 * 2 * 4 * 10
    assert t5_model.decode_flops(m, 2, 3) == 768 + 48 + 96 + 160
    assert sum(t5_model.decode_token_flops(m, p, 3) for p in range(2)) \
        == t5_model.decode_flops(m, 2, 3)
    assert t5_model.train_step_flops(m, 5, 3, 2) == 3 * 5 * (
        t5_model.encode_flops(m, 3) + t5_model.decode_flops(m, 2, 3))
