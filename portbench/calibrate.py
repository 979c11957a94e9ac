"""The readings a cell's limits are set from, on the card at the cell's own
size (the benchmark's own runs never do this):

    python3 portbench/calibrate.py --workload <name> --seeds 11,12,13 \
        [--seconds 2] [--control] [--faults unchanged,half_batch]

For each seed, one line each: the program's numbers compared (a short
window), the control's (the reference at the driver's `CONTROL` precision
in the program's place), and each planted fault's. A serving cell's
control line also holds the program's own gap over the same sequences
(`served_gap_program`), so `--program 0 --control` reads both from one
window. The lower reading of a
limit is the largest the program gives over a dozen seeds or more; the
upper the smallest the control or a fault gives (`checks/<cell>.json`).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as bench_run  # noqa: E402
from portbench.bench import env, spec  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program", type=int, default=1)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    a = p.parse_args()
    env.pin_caches()
    import torch
    from flasht5_tpu_torch import runtime
    cell = spec.Cell(spec.benchmark(), a.workload)
    drv = spec.driver(cell.traffic["driver"])
    print(f"nvidia-smi: {env.nvidia_smi()}", flush=True)
    runtime.build_kernels()
    faults = [f for f in a.faults.split(",") if f]
    for seed in [int(s) for s in a.seeds.split(",")]:
        kinds = ([("program", None)] if a.program else []) \
            + [("fault", f) for f in faults] \
            + ([("control", None)] if a.control else [])
        for kind, fault in kinds:
            t0 = time.perf_counter()
            args = bench_run.Args(a.workload, seed, a.seconds, 0)
            try:
                if kind == "control":
                    ctx = bench_run.Context(cell, seed, a.seconds, 0, "cuda")
                    drv.control(ctx, drv.CONTROL)
                else:
                    ctx = bench_run.execute(args, cell=cell, fault=fault)
                line = {"kind": kind, "fault": fault, "seed": seed,
                        "checks": {k: v for k, (v, _) in ctx.checks.items()},
                        "readings": ctx.readings,
                        "window": {k: v for k, v in ctx.window.items()
                                   if isinstance(v, (int, float))},
                        "seconds": time.perf_counter() - t0}
            except Exception:  # noqa: BLE001 - a crash is a reading too
                line = {"kind": kind, "fault": fault, "seed": seed,
                        "error": traceback.format_exc()[-2000:]}
            print("calibrate " + json.dumps(line), flush=True)
            ctx = None
            gc.collect()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
