"""The port's trackers (`train/callbacks.py`) and the driver's mapping of
`report_to` onto them (`train/cli.py::_callbacks`), against the JAX
package's (`flasht5_tpu/train/callbacks.py`, `train.py:104-122`).

`wandb` and `clearml` are not installed here: stand-ins in `sys.modules`
record what each tracker is given, and the same events go to the JAX
package's callbacks for comparison. `EnergyCallback` runs with explicit
watts (its totals against the JAX callback's at the same watts and the same
clock), with the `nvidia-smi` read patched, and refuses the CPU without
watts. No tolerance: the trackers pass values through.
"""

import json
import sys
import types

import pytest

from flasht5_tpu.train import callbacks as jcb
from flasht5_tpu_torch.train import callbacks as cb
from flasht5_tpu_torch.train import cli


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kw):
            self.calls.append((name, args, kw))
            return self
        return record


@pytest.fixture
def trackers(monkeypatch):
    """Stand-in `wandb` and `clearml` modules; yields their recorders."""
    wandb_run, task = _Recorder(), _Recorder()
    wandb = types.ModuleType("wandb")
    wandb.init = lambda **kw: (wandb_run.calls.append(("init", (), kw))
                               or wandb_run)
    clearml = types.ModuleType("clearml")

    class Task:
        @staticmethod
        def init(**kw):
            task.calls.append(("init", (), kw))
            return task
    clearml.Task = Task
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    monkeypatch.setitem(sys.modules, "clearml", clearml)
    return wandb_run, task


def _events(callback):
    entry = {"step": 5, "loss": 2.5, "grad_norm": 0.5, "note": "x"}
    callback.on_log(None, dict(entry))
    callback.on_eval(None, {"step": 5, "eval_loss": 3.0})
    callback.on_train_end(None, {"final_step": 5})


def test_wandb_and_clearml_match_jax(trackers):
    wandb_run, task = trackers
    for make in (lambda m: m.WandbCallback("proj", run_name="r",
                                           config={"a": 1}),
                 lambda m: m.ClearMLCallback("proj", "task")):
        got = []
        for module in (cb, jcb):
            wandb_run.calls.clear()
            task.calls.clear()
            _events(make(module))
            got.append((list(wandb_run.calls), list(task.calls)))
        assert got[0] == got[1]
        assert got[0][0] or got[0][1]


def test_trackers_raise_without_their_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "clearml", None)
    with pytest.raises(ImportError, match="wandb"):
        cb.WandbCallback("proj")
    with pytest.raises(ImportError, match="clearml"):
        cb.ClearMLCallback("proj", "task")


def test_energy_matches_jax_at_explicit_watts(monkeypatch, tmp_path):
    clock = iter([100.0, 100.0 + 1800.0, 100.0 + 3600.0] * 2)
    monkeypatch.setattr(cb.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(jcb.time, "perf_counter", lambda: next(clock))
    results = []
    for module in (cb, jcb):
        path = tmp_path / f"{module.__name__}.json"
        energy = module.EnergyCallback(n_chips=2, watts_per_chip=350.0,
                                       out_path=str(path))
        energy.on_train_begin(None)
        entry = {"step": 1}
        energy.on_log(None, entry)
        result = {}
        energy.on_train_end(None, result)
        results.append((entry, result, json.loads(path.read_text())))
    assert results[0] == results[1]
    assert results[0][1]["energy"]["energy_kwh"] == 0.7     # 1 h x 2 x 350 W


def test_energy_reads_the_cards_power_limit(monkeypatch):
    """watts None on a card: one `nvidia-smi` read of that card's limit."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout="700.00\n")
    monkeypatch.setattr(cb.subprocess, "run", fake_run)
    monkeypatch.setattr(cb.runtime, "resolve_device", lambda d: d)
    import torch
    energy = cb.EnergyCallback(device=torch.device("cuda", 3))
    assert energy.watts == 700.0
    assert calls == [["nvidia-smi", "--query-gpu=power.limit",
                      "--format=csv,noheader,nounits", "-i", "3"]]

    def missing(cmd, **kw):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(cb.subprocess, "run", missing)
    with pytest.raises(ValueError, match="watts_per_chip"):
        cb.EnergyCallback(device=torch.device("cuda", 0))


def test_energy_refuses_the_cpu_without_watts():
    with pytest.raises(ValueError, match="watts_per_chip"):
        cb.EnergyCallback(device="cpu")
    assert cb.EnergyCallback(watts_per_chip=65.0, device="cpu").watts == 65.0


def test_cli_maps_report_to_onto_the_trackers(trackers, tmp_path, capsys):
    targs = {"report_to": ["jsonl", "wandb", "clearml", "energy"],
             "project": "p", "run_name": "r", "watts_per_chip": 300.0}
    got = cli._callbacks(targs, str(tmp_path), device="cpu")
    assert [type(c) for c in got] == [cb.JSONLCallback, cb.WandbCallback,
                                      cb.ClearMLCallback, cb.EnergyCallback]
    assert got[0].path == f"{tmp_path}/tracker_log.jsonl"
    assert got[3].out_path == f"{tmp_path}/energy.json"
    assert got[3].watts == 300.0
    wandb_run, task = trackers
    assert wandb_run.calls[0][2]["project"] == "p"
    assert task.calls[0][2] == {"project_name": "p", "task_name": "r"}
    with pytest.raises(ValueError, match="unknown tracker"):
        cli._callbacks({"report_to": ["tensorboard"]}, str(tmp_path))


def test_cli_skips_a_tracker_whose_package_is_missing(monkeypatch, tmp_path,
                                                      capsys):
    monkeypatch.setitem(sys.modules, "wandb", None)
    got = cli._callbacks({"report_to": ["wandb", "jsonl"]}, str(tmp_path))
    assert [type(c) for c in got] == [cb.JSONLCallback]
    assert "tracker 'wandb' unavailable" in capsys.readouterr().out
