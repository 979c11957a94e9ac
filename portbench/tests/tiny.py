"""Cells at a size a CPU test run holds: the benchmark's own
configurations and mixes with their widths, depths and counts cut down."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.bench import spec  # noqa: E402

# cells whose files are in the benchmark but whose entry is held out of
# BENCHMARK.json: their check is still tested here
HELD_OUT = [{"name": "serve-prompt.flan-xl", "config": "fat5-flan-xl",
             "traffic": "prompt-poisson", "chips": 1,
             "why": "held out: the slot engine's host pace spreads its runs"}]

TINY_MODEL = dict(d_model=64, d_kv=16, d_ff=128, num_heads=4, num_layers=2,
                  num_decoder_layers=2, dtype="float32")


def tiny_cell(name: str, limits=None, **traffic) -> spec.Cell:
    """The workload `name` of BENCHMARK.json at a tiny size, on float32
    activations (the plain CPU versions of the kernels)."""
    bench = spec.benchmark()
    bench["workloads"] = bench["workloads"] + [
        w for w in HELD_OUT
        if w["name"] not in {x["name"] for x in bench["workloads"]}]
    cell = spec.Cell(bench, name)
    cfg = copy.deepcopy(cell.config)
    cfg["model_args"] = dict(cfg["model_args"], **TINY_MODEL)
    cfg["vocab_size"] = 512
    if "training_args" in cfg:
        cfg["training_args"]["per_device_train_batch_size"] = 4
        cfg["collator_args"] = dict(cfg["collator_args"], max_length=64,
                                    max_labels_length=16)
    cell.config = cfg
    cell.traffic = copy.deepcopy(cell.traffic)
    if "documents" in cell.traffic:
        cell.traffic["documents"] = {
            "count": 64, "length": {"lognormal": {"median": 80,
                                                  "sigma": 1.0},
                                    "min": 16, "max": 400}}
    if "serving" in cfg:
        cfg["serving"] = dict(cfg["serving"], dtype="float32")
    engine = cell.traffic.get("engine")
    if engine is not None and "num_pages" in engine:
        cell.traffic.update(
            engine=dict(engine, max_slots=4, page_size=8, num_pages=24,
                        max_pages_per_slot=4, max_encode_len=64,
                        encode_buckets=[64], steps_per_sync=4),
            requests={"input_length": {"uniform": [64, 64]},
                      "new_tokens": {"mixture": [
                          {"share": 0.75, "uniform": [3, 6]},
                          {"share": 0.25, "uniform": [12, 30]}]}},
            backlog=40, warmup={"requests": 4, "new_tokens": 3},
            check={"sample": 40})
    elif engine is not None:
        cell.traffic.update(
            engine=dict(engine, max_slots=4, max_decode_len=9,
                        max_encode_len=64, encode_buckets=[64],
                        steps_per_sync=4),
            requests={"input_length": {"uniform": [40, 64]},
                      "new_tokens": {"uniform": [2, 8]},
                      "rate_per_s": 40.0},
            warmup={"requests": 4}, check={"sample": 40})
    cell.traffic.update(traffic)
    if limits is not None:
        cell.limits = limits
    return cell
