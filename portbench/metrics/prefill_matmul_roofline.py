"""The prefill_matmul operation's share of its roofline in the traced stretch
(work/prefill_matmul.py over the device time of kernels/prefill_matmul/)."""

from portbench.bench.roofline import kernel_share


def read(run):
    return kernel_share(run, "prefill_matmul")
