"""Builds the port's CUDA sources and loads them.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library, loaded with `ctypes`:
no PyTorch headers, so a build takes seconds. Libraries go to
`build/repro_torch/` at the root of the checkout, named by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is built once. Nothing is compiled at import: the first call of a kernel
builds it, or `build()` builds every source, one nvcc per source started
together. Fast math stays off: the kernels' tiny-guards and their
cbrt/pow/exp accuracy depend on it.
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
    """Compile every named source (default: all) that has no library yet,
    one nvcc per source, all started together. Returns {name: seconds from
    the start to that library} for the sources it compiled; raises with
    the compiler's output on failure and stops every compiler it started."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in (sources() if names is None else names)
            if not library_path(n).exists()]
    jobs = {}
    seconds = {}
    t0 = time.perf_counter()
    try:
        for name in todo:
            tmp = library_path(name).with_name(
                f"{library_path(name).stem}.{os.getpid()}.tmp.so")
            log = open(log_path(name), "w")
            jobs[name] = (subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT), tmp, log)
        failed = []
        for name, (proc, tmp, log) in jobs.items():
            if proc.wait() != 0:
                failed.append(name)
                continue
            os.replace(tmp, library_path(name))
            seconds[name] = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(
                f"{n}.cu:\n{log_path(n).read_text()}" for n in failed))
    finally:
        for proc, tmp, log in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            tmp.unlink(missing_ok=True)
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The shared library of `csrc/<name>.cu`, built on first use."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
