"""Builds the port's CUDA sources and loads them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library, loaded with `ctypes`:
no PyTorch headers, so a build takes seconds. Libraries go to
`build/repro_torch/` at the root of the checkout, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is built once. Nothing is compiled at import: the first call of a kernel
builds it, or `build()` builds every source. Fast math stays off: the
kernels' tiny-guards and their cbrt/pow accuracy depend on it.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list:
    """Names of every kernel source in `csrc/`."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, $PATH, /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("repro_torch.kernels.build: nvcc not found (set "
                       "CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output for `name` (ptxas register and spill report)."""
    return library_path(name).with_suffix(".log")


def build(names=None) -> dict:
    """Compile every named source (default: all) that has no library yet.
    Returns {name: seconds} for the sources it compiled; raises with the
    compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {}
    for name in sources() if names is None else names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        try:
            with open(log_path(name), "w") as log:
                rc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT).returncode
            if rc != 0:
                raise RuntimeError(
                    f"nvcc failed on {name}.cu:\n{log_path(name).read_text()}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        seconds[name] = time.perf_counter() - t0
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built on first use."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
