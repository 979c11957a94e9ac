"""Tracing, timing and speed-of-light accounting.

The counterpart of `flasht5_tpu/utils/profiling.py` (the reference's
torch-profiler wrapper, benchmarks/benchmark_utils.py:203-268):
`profile_trace` records a `torch.profiler` trace of the CPU and the card and
writes it as a Chrome trace; `timed` gives seconds per call, from CUDA
events where the call returns a CUDA tensor and from the host clock
otherwise (synchronized with the card where there is one);
`peak_memory_bytes` the card's peak allocation over one call; `roofline`
compares a measured call with the card's compute and memory
bounds.

`CHIP_SPECS` holds the H100 SXM's data-sheet peaks (dense bf16 and int8
tensor rates, HBM3 bandwidth; the same figures `chip_smoke.py` bounds its
kernels with) and a nominal CPU entry, as the JAX package has one. The
rates assume the card's full 700 W: read its `power.limit` beside any
share taken against them. Another card's peaks are registered in
`CHIP_SPECS` under a word of its name before `roofline` measures on it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import torch

CHIP_SPECS = {
    "h100": {"bf16_flops": 989e12, "int8_flops": 1979e12,
             "hbm_gbps": 3.35e12},
    "cpu": {"bf16_flops": 1e12, "int8_flops": 1e12, "hbm_gbps": 100e9},
}


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _on_cuda(x) -> bool:
    t = _first_tensor(x)
    return t is not None and t.is_cuda


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Record a `torch.profiler` trace (CPU and, where there is a card,
    CUDA activity) of the block and write it to `logdir/trace.json`, a
    Chrome trace (chrome://tracing, Perfetto). Yields the profiler.

        with profile_trace("traces/step") as prof:
            run_steps()
    """
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Seconds per call of fn(*args): CUDA events around `iters` calls
    queued back to back where fn returns a CUDA tensor, the host clock
    otherwise; where there is a card, the host clock's span starts and
    ends with a synchronize, so a call that queues work on the card and
    returns no CUDA tensor is timed to the end of that work."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if out is None:
        out = fn(*args)
    if _on_cuda(out):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    sync = torch.cuda.synchronize if torch.cuda.is_available() else None
    if sync:
        sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    if sync:
        sync()
    return (time.perf_counter() - t0) / iters


@dataclasses.dataclass
class Roofline:
    seconds: float
    flops: float
    bytes: float
    chip: str

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    @property
    def flops_bound_time(self) -> float:
        return self.flops / CHIP_SPECS[self.chip]["bf16_flops"]

    @property
    def memory_bound_time(self) -> float:
        return self.bytes / CHIP_SPECS[self.chip]["hbm_gbps"]

    @property
    def speed_of_light(self) -> float:
        """The share of the roofline bound achieved (1.0 = at the bound)."""
        bound = max(self.flops_bound_time, self.memory_bound_time)
        return bound / self.seconds

    @property
    def bound(self) -> str:
        return ("compute" if self.flops_bound_time > self.memory_bound_time
                else "memory")

    def report(self) -> Dict:
        return {
            "seconds": round(self.seconds, 6),
            "achieved_tflops": round(self.achieved_tflops, 2),
            "achieved_gbps": round(self.achieved_gbps, 1),
            "bound": self.bound,
            "speed_of_light": round(self.speed_of_light, 3),
        }


def peak_memory_bytes(fn: Callable, *args, device=None) -> Optional[int]:
    """Peak device memory allocated during one call of fn(*args) on the
    CUDA card `device` (default the current one); None where there is no
    card or fn returns no CUDA result (a CPU run)."""
    if not torch.cuda.is_available():
        fn(*args)
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    out = fn(*args)
    torch.cuda.synchronize(device)
    if not _on_cuda(out):
        return None
    return torch.cuda.max_memory_allocated(device)


def chip_name() -> str:
    """The `CHIP_SPECS` key of the current device: "cpu" without a card,
    else the key that the card's name holds; raises for a card not
    listed."""
    if not torch.cuda.is_available():
        return "cpu"
    name = torch.cuda.get_device_name()
    for key in CHIP_SPECS:
        if key != "cpu" and key in name.lower():
            return key
    raise ValueError(f"no peaks for {name!r} in CHIP_SPECS: register them")


def roofline(fn: Callable, *args, flops: float, bytes_accessed: float,
             chip: Optional[str] = None, iters: int = 10) -> Roofline:
    """Measure fn and compare it with the chip's compute and memory
    bounds; the chip is the current card's (`chip_name`) unless named."""
    return Roofline(timed(fn, *args, iters=iters), flops, bytes_accessed,
                    chip or chip_name())
