"""The bias_attn_bwd operation's share of its roofline in the traced stretch
(work/bias_attn_bwd.py over the device time of kernels/bias_attn_bwd/)."""

from portbench.bench.roofline import kernel_share


def read(run):
    return kernel_share(run, "bias_attn_bwd")
