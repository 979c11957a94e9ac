"""The import guard: nothing the benchmark loads is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing under portbench/ reads the JAX benchmark's folder."""

import re
import subprocess
import sys
from pathlib import Path

from portbench.tests import tiny  # noqa: F401
from portbench.bench import env

BENCH = Path(__file__).resolve().parents[1]


def test_whole_name_comparison():
    assert "flasht5_tpu_torch".split(".")[0] not in env.FORBIDDEN_MODULES
    assert "flasht5_tpu" in env.FORBIDDEN_MODULES


def test_nothing_loaded_is_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import run, calibrate\n"
        "from portbench.bench import env, spec, serving\n"
        "from portbench.reference import t5_ref, adamw_ref\n"
        "import flasht5_tpu_torch.train.cli, flasht5_tpu_torch.inference."
        "paged_engine, flasht5_tpu_torch.inference.engine\n"
        "for p in sorted((spec.BENCH_DIR / 'drivers').glob('*.py')) + "
        "sorted((spec.BENCH_DIR / 'metrics').glob('*.py')) + "
        "sorted((spec.BENCH_DIR / 'work').glob('*.py')):\n"
        "    spec.load_module(p)\n"
        "print(env.forbidden_loaded())\n" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_file_reads_the_jax_benchmark():
    pattern = re.compile(r"\bbenchmarks/|import benchmarks|from benchmarks"
                         r"|\bimport jax\b|\bfrom jax\b|import flasht5_tpu\b"
                         r"|from flasht5_tpu\b(?!_torch)")
    this = Path(__file__).resolve()
    for path in BENCH.rglob("*.py"):
        if path.resolve() == this:
            continue
        assert not pattern.search(path.read_text()), path
