"""Device selection and the build of the hand-written CUDA kernels.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit `device="cpu"` they raise, they never quietly
fall back. On the CPU every kernel wrapper runs its plain PyTorch version;
that is how the tests run without a GPU.

The CUDA kernels (`csrc/*.cu`, each with a plain C interface) are compiled at
first use by `nvcc` for `sm_90a` into one shared library per source, kept in
the package's `build/` directory under a name keyed by a hash of the sources
and flags, and loaded with `ctypes`. `build_kernels()` starts one `nvcc` per
missing library, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Union

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """`cuda` unless the caller names another device; raises without CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# CUDA kernel libraries
# ---------------------------------------------------------------------------

def kernel_sources() -> list:
    """Names of the CUDA kernel sources (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under CUDA_HOME."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing kernel library, one `nvcc` per source, all
    started together. Returns {name: {"seconds": s, "log": ptxas output}}
    for the libraries built by this call; raises if any build fails."""
    names = list(names) if names is not None else kernel_sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return built


@functools.lru_cache(maxsize=None)
def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing."""
    path = _lib_path(name)
    if not path.exists():
        build_kernels([name])
    lib = ctypes.CDLL(str(path))
    lib.ft5_error_string.restype = ctypes.c_char_p
    lib.ft5_error_string.argtypes = [ctypes.c_int]
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.ft5_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
