"""The run's environment: caches inside the checkout, the card, the clocks
and power `nvidia-smi` reads, and the modules that may not be loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List

from portbench.bench.spec import ROOT

# compared whole, by each loaded module's top-level name: the port's name
# begins with the JAX package's
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "flasht5_tpu")
CACHE_DIR = ROOT / ".portbench_cache"


def pin_caches() -> None:
    """Triton's kernel cache at a fixed path inside the checkout (the port's
    nvcc libraries already live in its package's `build/`), and no JAX for
    any library that would load it by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN_MODULES))


def nvidia_smi() -> str:
    """The card's name, power limit and draw, and SM clocks, one CSV line
    a card ('' where nvidia-smi does not run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()
