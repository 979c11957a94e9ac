"""The benchmark's data: `BENCHMARK.json`, a cell's configuration, traffic
and limits, and the per-metric readers, each found by its name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path) -> ModuleType:
    """A module from a file, named after the file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of `BENCHMARK.json` with its files."""

    def __init__(self, bench: dict, name: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {sorted(by_name)})")
        self.workload = by_name[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(
            BENCH_DIR / "traffic" / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])
        checks = BENCH_DIR / "checks" / f"{name}.json"
        self.limits = load_json(checks)["limits"] if checks.exists() else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, name, self.end_to_end)]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str, end_to_end=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if end_to_end is None:
        return True
    return metric["moves"] in {m["name"] for m in end_to_end}


def reader(metric_name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{metric_name}.py")


def driver(kind: str) -> ModuleType:
    return load_module(BENCH_DIR / "drivers" / f"{kind}.py")


def kernel_patterns(operation: str) -> List[str]:
    """Every regex of `kernels/<operation>/*.txt` (one a line, # comments)."""
    out = []
    for path in sorted((BENCH_DIR / "kernels" / operation).glob("*.txt")):
        for line in path.read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                out.append(line)
    return out


def work_module(operation: str) -> ModuleType:
    return load_module(BENCH_DIR / "work" / f"{operation}.py")


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric's reader on the run; a reader that finds nothing to read
    returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
