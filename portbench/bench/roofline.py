"""Shares of the card's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM3. The
weight-only int8 products run on the bf16 tensor cores, so bf16 is their
peak too. A run prints the card's power limit beside these shares.
"""

from __future__ import annotations

from typing import Optional

from portbench.bench import spec

PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def kernel_share(run, operation: str) -> Optional[float]:
    """Percent of the roofline an operation reached in the traced stretch:
    the least time its work needs on the card (the larger of its operations
    over the peak rate and its bytes over the peak bandwidth) over the
    summed device time of the kernels `kernels/<operation>/` names, launched
    from the harness spans the driver gave for it. None where the trace
    holds none of them."""
    if run.trace is None:
        return None
    op = run.window.get("ops", {}).get(operation)
    if not op or not op["calls"]:
        return None
    work = spec.work_module(operation)
    flops = nbytes = 0.0
    for shape, count in op["calls"]:
        f, b = work.work(**shape)
        flops += f * count
        nbytes += b * count
    seconds = run.trace.device_seconds(spec.kernel_patterns(operation),
                                       op.get("spans"))
    if seconds <= 0:
        return None
    return 100.0 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S) \
        / seconds


def mfu(run) -> Optional[float]:
    """Percent of the bf16 peak of the cell's cards: the model's analytic
    operations in the window over its wall."""
    flops, wall = run.window.get("model_flops"), run.window.get("wall_s")
    if not flops or not wall:
        return None
    return 100.0 * flops / wall / (PEAK_FLOPS * run.cell.chips)


def idle_share(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
