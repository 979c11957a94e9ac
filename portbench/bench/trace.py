"""The traced part of a `--trace 1` run: `torch.profiler` over a stretch of
the window that begins and ends on a synchronized card, read back from its
Chrome trace.

What it gives the readers: every device operation (kernels, copies, sets)
with its start, length and the harness span whose host code launched it,
the device's busy time (the union of those operations) and the traced
wall, the operations that took most time, and the longest idle gaps named
by what the host was doing meanwhile.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN_PREFIX = "portbench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    """A harness span around a call into a layer (recorded only while the
    profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """Starts and stops the profiler at synchronized points of a run."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.done = False
        self._span = None

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._span = span("traced")
        self._span.__enter__()

    def stop(self) -> None:
        if not self.active:
            return
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def read(self) -> Optional["Trace"]:
        if not self.done:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        return Trace(events.get("traceEvents", events))


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void\s+", "", name.strip())
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += name[i] == ")"
            depth -= name[i] == "("
            if depth == 0:
                name = name[:i]
                break
    return name.strip() or "(unnamed)"


class Trace:
    def __init__(self, events: List[Dict]):
        launches, spans, host = {}, [], []
        ops = []
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in _DEVICE_CATS:
                ops.append((e["name"], ts, dur,
                            e.get("args", {}).get("correlation")))
            elif cat in _LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
            elif cat == "user_annotation" and e["name"].startswith(
                    SPAN_PREFIX):
                spans.append((e["name"][len(SPAN_PREFIX):], ts, ts + dur))
            elif cat in ("cpu_op", "python_function"):
                host.append((e["name"], ts, ts + dur))
        traced = [s for s in spans if s[0] == "traced"]
        self.t0, self.t1 = ((traced[0][1], traced[0][2]) if traced else
                            (min((o[1] for o in ops), default=0.0),
                             max((o[1] + o[2] for o in ops), default=0.0)))
        self.window_s = (self.t1 - self.t0) * 1e-6
        spans = [s for s in spans if s[0] != "traced"]
        spans.sort(key=lambda s: s[1])
        self._spans = spans
        self._span_starts = [s[1] for s in spans]
        self._host = sorted(host, key=lambda s: s[1])
        # (name, short name, start us, length us, the harness span that
        # launched it or None)
        self.ops = [(n, _short(n), ts, dur,
                     self._span_at(launches.get(corr)))
                    for n, ts, dur, corr in sorted(ops, key=lambda o: o[1])]
        # seconds some operation ran on the device
        self.busy_s = sum(b - a for a, b in self.intervals()) * 1e-6

    def _span_at(self, ts: Optional[float]) -> Optional[str]:
        """The innermost harness span open at host time ts."""
        if ts is None:
            return None
        # spans nest, so the latest-starting span still open is innermost
        i = bisect.bisect_right(self._span_starts, ts)
        for name, _, end in reversed(self._spans[max(0, i - 1000):i]):
            if end >= ts:
                return name
        return None

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the traced
        window, in us."""
        out: List[List[float]] = []
        for _, _, ts, dur, _ in self.ops:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def device_seconds(self, patterns: List[str],
                       spans: Optional[List[str]] = None) -> float:
        """Summed device time of the operations whose name matches one of
        `patterns` (and, given `spans`, that a host span of those names
        launched)."""
        regs = [re.compile(p) for p in patterns]
        return sum(dur for name, _, _, dur, sp in self.ops
                   if any(r.search(name) for r in regs)
                   and (spans is None or sp in spans)) * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for _, short, _, dur, _ in self.ops:
            by[short] += dur * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The n longest stretches with no device operation, each named by
        the harness span and the host operation open at its middle."""
        edges = [self.t0] + [x for ab in self.intervals() for x in ab] \
            + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = [h[1] for h in self._host]
        out = []
        for a, b in gaps[:n]:
            mid = 0.5 * (a + b)
            sp = self._span_at(mid) or "outside any span"
            # the innermost host operation open at mid
            i = bisect.bisect_right(starts, mid)
            op = "python"
            for name, s, e in reversed(self._host[max(0, i - 200):i]):
                if e >= mid:
                    op = name
                    break
            out.append([f"{sp}: {op}", (b - a) * 1e-6])
        return out
