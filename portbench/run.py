"""The benchmark of `flasht5_tpu_torch` on one or four cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Looks the workload up in `BENCHMARK.json`, makes its inputs and weights
from the seed, sets up and warms the program (`setup_s`), measures for
`--seconds`, checks what the timed path produced against the plain
reference in `portbench/reference/`, and prints one JSON line: the cell's
end-to-end metrics (`--trace 0`) or its per-layer metrics from a traced
stretch of the window (`--trace 1`). Each cell's driver is
`portbench/drivers/<traffic's driver>.py`, each metric's reader
`portbench/metrics/<name>.py`.

Exits non-zero, printing no result, without enough CUDA cards, or where
`jax`, `jaxlib`, `flax` or `flasht5_tpu` is loaded once the window closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import env, spec  # noqa: E402


class Context:
    """One run: what the driver is given, and what it leaves for the
    metric readers and the checks."""

    def __init__(self, cell, seed, seconds, trace, device, fault=None):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace_on = bool(trace)
        self.device = device
        self.fault = fault
        self.t_start = T_START
        self.setup_s = None
        self.window = {}           # the driver's counts and walls
        self.trace = None          # bench.trace.Trace of a --trace 1 run
        self.checks = {}           # name -> (value, limit)
        self.readings = {}         # further numbers a check printed
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.kernel_build_s = None

    def check(self, name: str, value: float, limit_key: str = None) -> None:
        limit = self.cell.limits.get(limit_key or name)
        self.checks[name] = (float(value), limit)

    @property
    def correct(self) -> bool:
        if not self.checks:
            return False
        for value, limit in self.checks.values():
            if limit is None or not value <= limit:
                return False
        return True


class Args:
    """The command line's four values, for callers that build a run in
    Python (the calibration and the tests)."""

    def __init__(self, workload, seed, seconds, trace=0):
        self.workload, self.seed, self.seconds, self.trace = (
            workload, seed, seconds, trace)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args, *, device="cuda", cell=None, fault=None) -> Context:
    """Set-up, window and checks of one run; returns its context."""
    import torch
    bench = spec.benchmark()
    cell = cell or spec.Cell(bench, args.workload)
    ctx = Context(cell, args.seed, args.seconds, args.trace, device, fault)
    if device == "cuda":
        from flasht5_tpu_torch import runtime
        t0 = time.perf_counter()
        built = runtime.build_kernels()
        ctx.kernel_build_s = time.perf_counter() - t0
        print(f"kernel build: {len(built)} libraries built in "
              f"{ctx.kernel_build_s:.3f} s"
              + (" (a first run in this checkout)" if built else
                 " (all cached in the checkout)"), file=sys.stderr,
              flush=True)
    spec.driver(cell.traffic["driver"]).run(ctx)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return ctx


def result_line(ctx: Context) -> dict:
    import torch
    metrics = spec.read_metrics(ctx.cell.metrics(ctx.trace_on), ctx)
    dev = {"platform": "gpu" if ctx.device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if ctx.device == "cuda"
                    else "cpu"),
           "count": ctx.cell.chips,
           "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    out = {"correct": ctx.correct, "attempted": int(ctx.attempted),
           "failed": int(ctx.failed), "metrics": metrics, "device": dev}
    if ctx.trace_on and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(10),
                            "idle_gaps": ctx.trace.idle_gaps(10)}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in ctx.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    env.pin_caches()
    import torch
    cell = spec.Cell(spec.benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < \
            cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi (name, power limit, "
          f"draw, SM clock, max SM clock, temperature): {env.nvidia_smi()}",
          file=sys.stderr, flush=True)
    ctx = execute(args, cell=cell)
    found = env.forbidden_loaded()
    if found:
        print(f"modules that may not be loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(ctx)
    print(f"set-up {ctx.setup_s:.3f} s (kernel build "
          f"{ctx.kernel_build_s:.3f} s of it); peak memory "
          f"{ctx.memory_peak_bytes} bytes; nvidia-smi after the window: "
          f"{env.nvidia_smi()}", file=sys.stderr)
    for name, value in ctx.readings.items():
        print(f"reading {name}: {json.dumps(value)}", file=sys.stderr)
    for name, (value, limit) in ctx.checks.items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
