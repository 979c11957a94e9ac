"""The backward of attention on an additive bias tensor (the encoder's and
the decoder's self-attention on the materialized T5 bias), one call.

Operations: the scores recomputed (Q K^T), dV = P^T dO, dP = dO V^T,
dK = dS^T Q and dQ = dS K, two per multiply-add, over the (query, key)
pairs the mask keeps. Bytes: Q, K, V, O, dO (bf16) and the row statistics
(f32) read once, the bias read once (f32, shared by the batch), dQ, dK, dV
(bf16) and the batch-summed dbias (f32) written once.
"""


def pairs(m: int, n: int, causal: bool) -> int:
    if not causal:
        return m * n
    # query i sees keys 0..i (+ n - m where the keys run longer)
    return sum(min(n, i + 1 + max(0, n - m)) for i in range(m))


def work(batch: int, heads: int, m: int, n: int, d: int, causal: bool):
    flops = 10.0 * batch * heads * pairs(m, n, causal) * d
    io = batch * heads * d * 2 * (3 * m + 2 * n)    # q, o, do; k, v
    io += batch * heads * m * 4                      # lse
    io += heads * m * n * 4                          # bias
    io += batch * heads * d * 2 * (m + 2 * n)        # dq; dk, dv
    io += heads * m * n * 4                          # dbias
    return flops, float(io)
