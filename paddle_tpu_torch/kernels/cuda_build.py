"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/*.cu` file has a plain C interface and is compiled on its own
by `nvcc` for Hopper (`sm_90a`) into `kernels/_build/`, then loaded with
`ctypes`.  Builds are keyed by the source text and the flags, so a
process reuses a library an earlier process built from the same
source.  `build_all` starts one `nvcc` per missing source at once and
waits for all of them.  A missing compiler or a failed build raises:
nothing falls back.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

__all__ = ["load_library", "build_all", "build_counts", "build_log"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_counts = {"compiles": 0, "compile_seconds": 0.0, "cache_hits": 0,
           "cache_misses": 0}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
            "are built from source at first use")
    return path


def _target(source: str):
    """-> (source path, library path keyed by source text and flags)."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        text = f.read()
    key = hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    return src, os.path.join(BUILD_DIR, f"{stem}-{key[:16]}.so")


def _compile_locked(sources: Iterable[str]) -> None:
    """Compile every source without a current build, all nvcc processes
    running at once.  Caller holds _lock."""
    jobs = []
    for source in sources:
        src, so = _target(source)
        if os.path.exists(so):
            _counts["cache_hits"] += 1
            continue
        _counts["cache_misses"] += 1
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((source, so, tmp, proc))
    t0 = time.perf_counter()
    failed = []
    for source, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        _logs[source] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {source} "
                          f"(exit {proc.returncode}):\n{out[-4000:]}")
            continue
        os.replace(tmp, so)
        _counts["compiles"] += 1
    if jobs:
        _counts["compile_seconds"] += time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(sources: Optional[Iterable[str]] = None
              ) -> Dict[str, ctypes.CDLL]:
    """Build and load every given `csrc/` source (default: all of them),
    compiling the missing ones in parallel -> {source: library}."""
    if sources is None:
        sources = sorted(os.path.basename(p)
                         for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    sources = list(sources)
    with _lock:
        todo = [s for s in sources if s not in _loaded]
        # lint: blocking-under-lock-ok — the nvcc processes ARE the
        # critical section: the first caller builds each shared object
        # once, and every other thread must wait for exactly that build
        # before it loads the library
        _compile_locked(todo)
        for source in todo:
            _loaded[source] = ctypes.CDLL(_target(source)[1])
        return {s: _loaded[s] for s in sources}


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<source>`, compiling it when
    no build of this exact source and flag set exists yet."""
    return build_all([source])[source]


def build_counts() -> Dict[str, float]:
    """Process-wide build counters: nvcc runs and their seconds, and
    how many loads found an existing build (hits) or had to compile
    (misses)."""
    with _lock:
        return dict(_counts)


def build_log(source: str) -> str:
    """nvcc's output (including ptxas register/spill lines) for a source
    this process compiled; empty when it was loaded from an earlier
    build."""
    with _lock:
        return _logs.get(source, "")
