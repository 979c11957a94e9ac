"""The model's analytic operations in the window (work/t5_model.py) over
its wall, as a share of the card's bf16 peak."""

from portbench.bench.roofline import mfu


def read(run):
    return mfu(run)
