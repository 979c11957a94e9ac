"""The port's profiling utilities (`utils/profiling.py`) on the CPU: the
contracts of tests/test_profiling.py (`timed`, the `Roofline` arithmetic,
a measured `roofline`), with the H100's peaks; `peak_memory_bytes` is None
on the CPU, and `profile_trace` writes a Chrome trace. Times here are the
CPU's, checked only for being positive and finite."""

import json
import os

import numpy as np
import torch

from flasht5_tpu_torch.utils.profiling import (CHIP_SPECS, Roofline,
                                               chip_name, peak_memory_bytes,
                                               profile_trace, roofline, timed)


def test_timed_measures():
    x = torch.ones((256, 256))
    assert timed(lambda a: a @ a, x, iters=3, warmup=1) > 0


def test_timed_measures_a_call_that_returns_no_tensor():
    x = torch.ones((256, 256))
    assert timed(lambda: (x @ x, None)[1], iters=3, warmup=1) > 0


def test_roofline_math():
    r = Roofline(seconds=1e-3, flops=100e9, bytes=100e6, chip="h100")
    assert r.achieved_tflops == 100.0
    assert r.achieved_gbps == 100.0
    # 100 GFLOP / 989 TFLOP/s = 0.101 ms > 100 MB / 3.35 TB/s = 0.030 ms
    assert r.bound == "compute"
    assert r.speed_of_light == r.flops_bound_time / 1e-3
    assert 0 < r.speed_of_light < 1
    assert set(r.report()) == {"seconds", "achieved_tflops",
                               "achieved_gbps", "bound", "speed_of_light"}
    mem = Roofline(seconds=1e-3, flops=1e9, bytes=1e9, chip="h100")
    assert mem.bound == "memory"
    assert mem.memory_bound_time == 1e9 / 3.35e12


def test_roofline_measured_on_the_cpu():
    x = torch.ones((1024, 1024))
    r = roofline(lambda a: (a * 2.0).sum(), x, flops=x.numel() * 2,
                 bytes_accessed=x.numel() * 4, iters=3)
    assert r.chip == chip_name() and r.chip in CHIP_SPECS
    assert np.isfinite(r.speed_of_light)


def test_peak_memory_is_none_on_the_cpu():
    if not torch.cuda.is_available():
        assert chip_name() == "cpu"
    assert peak_memory_bytes(lambda: torch.ones(8)) is None


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones((64, 64)).sum()
    assert prof is not None
    path = tmp_path / "trace" / "trace.json"
    assert os.path.getsize(path) > 0
    assert "traceEvents" in json.loads(path.read_text())
