"""The decode_matmul operation's share of its roofline in the traced stretch
(work/decode_matmul.py over the device time of kernels/decode_matmul/)."""

from portbench.bench.roofline import kernel_share


def read(run):
    return kernel_share(run, "decode_matmul")
