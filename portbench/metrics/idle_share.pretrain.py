"""The share of the traced stretch with no operation on the device."""

from portbench.bench.roofline import idle_share


def read(run):
    return idle_share(run)
