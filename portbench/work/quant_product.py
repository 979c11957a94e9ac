"""A weight-only int8 product x (M, K) bf16 @ w (K, N) int8 with one f32
scale a column, output bf16: 2 M K N operations; x, w and the scales read
once, the output written once."""


def work(m: int, k: int, n: int):
    return 2.0 * m * k * n, float(2 * m * k + k * n + 4 * n + 2 * m * n)
