"""Trainer callbacks: the hook protocol and the structured JSONL log.

The counterpart of `flasht5_tpu/train/callbacks.py`'s `TrainerCallback` and
`JSONLCallback`: every log, eval and save event of `Trainer.train` fans out
to the registered callbacks. The wandb, ClearML and energy callbacks are not
ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict


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
