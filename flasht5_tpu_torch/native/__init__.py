"""ctypes bindings of the native (C++) core of the UL2 collator.

A copy of `flasht5_tpu/native/`: `ul2_core.cpp` (span noise masks, greedy
first-fit packing) is built with `g++` at first use into the package's
`build/` directory, under a name keyed by a hash of the source and flags,
and loaded with `ctypes`. A failed build or load raises: the collator asks
for this core only with `use_native=True`, and then means it (the JAX
package falls back to numpy instead, which draws another noise-mask
stream).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from flasht5_tpu_torch.runtime import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "ul2_core.cpp"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libul2_core-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def load_ul2_core() -> ctypes.CDLL:
    """The loaded native core, built first if missing; raises if it cannot
    be built or loaded."""
    path = _lib_path()
    if not path.exists():
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native UL2 core is built "
                               "at first use (use_native=False takes the "
                               "numpy collator)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native UL2 core failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.ul2_random_spans_noise_mask.restype = ctypes.c_int64
    lib.ul2_random_spans_noise_mask.argtypes = [
        ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8)]
    lib.ul2_best_fit_pack.restype = ctypes.c_int64
    lib.ul2_best_fit_pack.argtypes = [
        ctypes.c_int64, _I64P, _I64P, _I64P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _I64P]
    return lib


def native_noise_mask(length: int, mu: float, r: float, max_spans: int,
                      seed: int) -> np.ndarray:
    """The (length,) bool span noise mask drawn from `seed`."""
    out = np.zeros(length, np.uint8)
    load_ul2_core().ul2_random_spans_noise_mask(
        length, mu, r, max_spans, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def native_best_fit(len_in: np.ndarray, len_lb: np.ndarray,
                    n_sent: np.ndarray, max_len: int, max_labels: int,
                    sentinel_budget: int, batch_size: int) -> np.ndarray:
    """Each example's bin in [0, batch_size), or -1 if it fits none."""
    li, ll, ns = (np.ascontiguousarray(a, np.int64)
                  for a in (len_in, len_lb, n_sent))
    out = np.full(len(li), -1, np.int64)
    load_ul2_core().ul2_best_fit_pack(
        len(li), li.ctypes.data_as(_I64P), ll.ctypes.data_as(_I64P),
        ns.ctypes.data_as(_I64P), max_len, max_labels, sentinel_budget,
        batch_size, out.ctypes.data_as(_I64P))
    return out
