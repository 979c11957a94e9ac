"""Trainer callbacks: the hook protocol, the structured JSONL log, the
experiment trackers and energy reporting.

The counterpart of `flasht5_tpu/train/callbacks.py`: every log, eval and
save event of `Trainer.train` fans out to the registered callbacks. The
wandb and ClearML trackers import their package in the constructor, which
raises ImportError without it (`train.cli` prints and skips such a
tracker). `EnergyCallback` reckons elapsed hours x cards x watts, the watts
read once from the card's power limit (`nvidia-smi`) unless the caller
passes them; on the CPU, or without `nvidia-smi`, the caller must.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Optional

import torch

from flasht5_tpu_torch import runtime


class TrainerCallback:
    """Base callback; all hooks are optional no-ops."""

    def on_train_begin(self, trainer) -> None: ...

    def on_log(self, trainer, entry: Dict) -> None: ...

    def on_eval(self, trainer, metrics: Dict) -> None: ...

    def on_save(self, trainer, path: str) -> None: ...

    def on_train_end(self, trainer, result: Dict) -> None: ...


class JSONLCallback(TrainerCallback):
    """Structured log file, one JSON object per event."""

    def __init__(self, path: str):
        self.path = path

    def _write(self, kind: str, payload: Dict) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps({"kind": kind, **payload}) + "\n")

    def on_log(self, trainer, entry):
        self._write("train", entry)

    def on_eval(self, trainer, metrics):
        self._write("eval", metrics)

    def on_save(self, trainer, path):
        self._write("checkpoint", {"path": path, "step": trainer.step_num})


class WandbCallback(TrainerCallback):
    """Weights & Biases tracker (reference: train_fat5_minipile.py:8,89)."""

    def __init__(self, project: str, run_name: Optional[str] = None,
                 config: Optional[Dict] = None):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "WandbCallback requires the `wandb` package") from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=run_name,
                               config=config or {})

    def on_log(self, trainer, entry):
        self._run.log(entry, step=entry.get("step"))

    def on_eval(self, trainer, metrics):
        self._run.log(metrics)

    def on_train_end(self, trainer, result):
        self._run.finish()


class ClearMLCallback(TrainerCallback):
    """ClearML tracker (reference: train_flash_t5.py:7-9,156)."""

    def __init__(self, project: str, task_name: str):
        try:
            from clearml import Task
        except ImportError as e:
            raise ImportError(
                "ClearMLCallback requires the `clearml` package") from e
        self._task = Task.init(project_name=project, task_name=task_name)
        self._logger = self._task.get_logger()

    def _report(self, series_prefix: str, entry: Dict) -> None:
        step = int(entry.get("step", 0))
        for k, v in entry.items():
            if isinstance(v, (int, float)) and k != "step":
                self._logger.report_scalar(
                    title=series_prefix, series=k, value=float(v),
                    iteration=step)

    def on_log(self, trainer, entry):
        self._report("train", entry)

    def on_eval(self, trainer, metrics):
        self._report("eval", metrics)

    def on_train_end(self, trainer, result):
        self._task.close()


def card_power_limit_watts(index: int) -> float:
    """The power limit of CUDA card `index`, as `nvidia-smi` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits", "-i", str(index)],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


class EnergyCallback(TrainerCallback):
    """Energy and carbon reporting (reference: codecarbon,
    train_flash_t5.py:96): `elapsed_hours x n_chips x watts_per_chip` and
    CO2 by a grid intensity factor, a running total in every log entry
    under `energy_kwh`, a summary at train end (in the result's `energy`,
    and in `out_path` where given).

    With `watts_per_chip` None the watts are the power limit of the CUDA
    card `device` names (default the current one), read once here from
    `nvidia-smi`; on the CPU, or where `nvidia-smi` cannot be run, the
    constructor raises unless the caller passes them. The limit is the
    card's ceiling, not its draw: the estimate is an upper bound."""

    def __init__(self, n_chips: int = 1,
                 watts_per_chip: Optional[float] = None,
                 kg_co2_per_kwh: float = 0.475,
                 out_path: Optional[str] = None, device=None):
        if watts_per_chip is None:
            dev = torch.device("cuda" if device is None else device)
            if dev.type != "cuda":
                raise ValueError(f"EnergyCallback on {dev}: pass "
                                 f"watts_per_chip (no card to read)")
            dev = runtime.resolve_device(dev)
            try:
                watts_per_chip = card_power_limit_watts(dev.index)
            except (OSError, subprocess.CalledProcessError) as e:
                raise ValueError(f"EnergyCallback: nvidia-smi gave no power "
                                 f"limit ({e}); pass watts_per_chip") from e
        self.n_chips = n_chips
        self.watts = float(watts_per_chip)
        self.intensity = kg_co2_per_kwh
        self.out_path = out_path
        self._t0 = None

    def _totals(self) -> Dict:
        hours = (time.perf_counter() - self._t0) / 3600.0 if self._t0 else 0.0
        kwh = hours * self.n_chips * self.watts / 1000.0
        return {"energy_kwh": round(kwh, 6),
                "co2_kg": round(kwh * self.intensity, 6)}

    def on_train_begin(self, trainer):
        self._t0 = time.perf_counter()

    def on_log(self, trainer, entry):
        entry.update(self._totals())

    def on_train_end(self, trainer, result):
        summary = self._totals()
        result["energy"] = summary
        if self.out_path:
            os.makedirs(os.path.dirname(self.out_path) or ".", exist_ok=True)
            with open(self.out_path, "w") as f:
                json.dump(summary, f)
