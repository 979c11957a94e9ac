"""The knee of an open-loop slot-engine cell: the highest arrival rate
whose queue does not grow over the window, found once by a sweep on the
card (the cell then fixes a rate below it in its traffic file):

    python3 portbench/knee.py --workload <name> --rates 40,80,120 \
        [--seconds 10] [--seed 1]

One engine is set up and warmed; each rate serves its own requests; each
line gives the tails, the queue wait of the first and the last quarter of
the requests, and how long the engine ran on after the last was due.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as bench_run  # noqa: E402
from portbench.bench import env, spec, stats  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args()
    env.pin_caches()
    cell = spec.Cell(spec.benchmark(), a.workload)
    drv = spec.driver(cell.traffic["driver"])
    ctx = bench_run.Context(cell, a.seed, a.seconds, 0, "cuda")
    print(f"nvidia-smi: {env.nvidia_smi()}", flush=True)
    engine = drv.setup(ctx)
    for rate in [float(r) for r in a.rates.split(",")]:
        reqs = drv.due(ctx, rate)
        t0 = time.perf_counter()
        engine.run(reqs, now=time.perf_counter)
        wall = time.perf_counter() - t0
        q = [r.admitted_at - r.arrival_s for r in reqs]
        k = max(1, len(q) // 4)
        line = {
            "rate": rate, "requests": len(reqs), "wall_s": wall,
            "after_last_due_s": wall - reqs[-1].arrival_s,
            "ttft_p50_ms": 1e3 * stats.percentile(
                [r.first_token_at - r.arrival_s for r in reqs], 50),
            "ttft_p95_ms": stats.percentile(
                [1e3 * (r.first_token_at - r.arrival_s) for r in reqs], 95),
            "latency_p95_ms": stats.percentile(
                [1e3 * (r.finished_at - r.arrival_s) for r in reqs], 95),
            "queue_first_quarter_ms": 1e3 * sum(q[:k]) / k,
            "queue_last_quarter_ms": 1e3 * sum(q[-k:]) / k,
            "tokens_per_s": sum(len(r.result) for r in reqs) / wall}
        print("knee " + json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
