"""Tracing, timing and speed-of-light accounting.

`span(name, **attrs)` marks a layer boundary of the program (the trainer's
step and its phases, the collator, the paged engine's admissions, windows
and scheduler): off by default, when it costs a flag check and records
nothing; inside a `recording()` block its spans are kept in memory on
`time.perf_counter()`; while a `torch.profiler` records, each span is also
a `record_function("ft5.<name>")`, so it lands in the Chrome trace on the
kernels' clock. The counts a layer does (requests admitted, tokens emitted,
rows collated) are attributes of its span.

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
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

CHIP_SPECS = {
    "h100": {"bf16_flops": 989e12, "int8_flops": 1979e12,
             "hbm_gbps": 3.35e12},
    "cpu": {"bf16_flops": 1e12, "int8_flops": 1e12, "hbm_gbps": 100e9},
}


class SpanRecord(NamedTuple):
    """One closed span: its name, its id and its parent's (None at the top
    of its thread), start and end in `time.perf_counter()` seconds, and its
    attributes."""
    name: str
    id: int
    parent: Optional[int]
    start: float
    end: float
    attrs: Dict


_SPAN_LIMIT = 1_000_000     # spans a recorder keeps


class Recorder:
    """The spans closed inside a `recording()` block, in the order they
    closed: at most `_SPAN_LIMIT` of them, `dropped` counts the rest."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.dropped = 0
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _keep(self, record: SpanRecord) -> None:
        if len(self.spans) < _SPAN_LIMIT:
            self.spans.append(record)
        else:
            self.dropped += 1


_recorder: Optional[Recorder] = None


class _NullSpan:
    """What `span` returns while nothing records: enters, exits and takes
    attributes doing nothing; false, so that a caller computes an attribute
    only for a span that keeps it (`if sp: sp.set(...)`)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "_recorder", "_annotation", "_id",
                 "_parent", "_start")

    def __init__(self, name: str, attrs: Dict, recorder, profiled: bool):
        self.name = name
        self.attrs = attrs
        self._recorder = recorder
        self._annotation = (torch.profiler.record_function("ft5." + name)
                            if profiled else None)

    def set(self, **attrs) -> None:
        """Add attributes (counts known only once the work is done)."""
        self.attrs.update(attrs)

    def __enter__(self):
        if self._annotation is not None:
            self._annotation.__enter__()
        rec = self._recorder
        if rec is not None:
            stack = rec._stack()
            self._parent = stack[-1] if stack else None
            self._id = next(rec._ids)
            stack.append(self._id)
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self._recorder
        if rec is not None:
            end = time.perf_counter()
            rec._stack().pop()
            rec._keep(SpanRecord(self.name, self._id, self._parent,
                                 self._start, end, self.attrs))
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return None


def span(name: str, **attrs):
    """A context manager around one pass through a layer boundary, closed
    on exceptions too. While no `recording()` block is open and no
    `torch.profiler` records, a shared object that does nothing (no clock,
    no allocation, no device synchronization); else it keeps a
    `SpanRecord` in the open recorder and enters
    `record_function("ft5." + name)` under the profiler.

        with span("paged.window", window=n, steps=k) as sp:
            out = run_window()
            if sp:
                sp.set(tokens=int(out.sum()))
    """
    rec = _recorder
    profiled = _profiler_enabled()
    if rec is None and not profiled:
        return _NULL_SPAN
    return _Span(name, attrs, rec, profiled)


@contextlib.contextmanager
def recording():
    """Keep every span that closes inside the block in a new `Recorder`
    (yielded), on `time.perf_counter()`; the recorder open before, if any,
    is restored after.

        with recording() as rec:
            trainer.train(batches)
        steps = [s for s in rec.spans if s.name == "train.step"]
    """
    global _recorder
    outer, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


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
