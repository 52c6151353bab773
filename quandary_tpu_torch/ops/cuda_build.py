"""Build and load the package's CUDA sources: one shared library per
``csrc/*.cu`` file, compiled with nvcc for sm_90a at first use into
``build/quandary_tpu_torch/`` (keyed on a hash of the source and the shared
``csrc/*.cuh`` headers) and bound with ctypes. The sources have a plain C
interface and include no PyTorch header, so a build takes seconds;
``build_parallel`` runs one nvcc per source, all at once."""

from __future__ import annotations

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "quandary_tpu_torch")
MAX_SMEM = 227 * 1024       # dynamic shared memory one block can use
LIBS = {}       # source path -> (loaded library, its path): one per process


def nvcc_command(src: str, out: str, verbose: bool = False) -> list:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, src]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build_library(src: str, bind, verbose: bool = False):
    """Compile `src` (unless its library is already built) and load it, once
    per process: later calls return the loaded library without touching the
    source file. `bind(lib)` sets the argument types of its entry points.
    Returns (library path, build seconds, compiler output); seconds is 0
    when the library was already built."""
    if src in LIBS:
        return LIBS[src][1], 0.0, ""
    h = hashlib.sha256()
    for name in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(name, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(src))[0]
    path = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run(nvcc_command(src, tmp, verbose),
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    bind(lib)
    LIBS[src] = (lib, path)
    return path, seconds, log


def library(src: str, bind):
    """The loaded library of `src`, built at first use."""
    build_library(src, bind)
    return LIBS[src][0]


def build_parallel(build_fns, verbose: bool = False):
    """Call every module's build_kernels(verbose) at once, one thread (and
    so one nvcc) each; returns their results in order. A failed build
    raises."""
    with concurrent.futures.ThreadPoolExecutor(len(build_fns)) as pool:
        futures = [pool.submit(b, verbose) for b in build_fns]
        return [f.result() for f in futures]
