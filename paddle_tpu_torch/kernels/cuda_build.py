"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/*.cu` file has a plain C interface and is compiled on its own
by `nvcc` for Hopper (`sm_90a`) into the build directory, then loaded
with `ctypes`.  The build directory is the `compilation_cache_dir` flag
(PADDLE_TPU_COMPILATION_CACHE_DIR), `kernels/_build/` when it is unset.
Builds are keyed by the source text and the flags, so a process reuses
a library an earlier process built from the same source, and
`export_builds` copies a process's loaded builds into another directory
(the serving warm-start artifact).  `build_all` starts one `nvcc` per missing source at once and
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

__all__ = ["load_library", "build_all", "build_counts", "build_log",
           "build_dir", "source_key", "export_builds", "nvcc_version"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_loaded_from: Dict[str, str] = {}
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


def build_dir() -> str:
    """Where libraries are built and loaded: the compilation_cache_dir
    flag, else kernels/_build."""
    from ..core.flags import get_flag

    return get_flag("compilation_cache_dir") or BUILD_DIR


def source_key(source: str) -> str:
    """The build key of `csrc/<source>`: a hash of its text and the nvcc
    flags (the build's file name carries it)."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        text = f.read()
    return hashlib.sha1(
        text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def _target(source: str, directory: Optional[str] = None):
    """-> (source path, library path keyed by source text and flags)."""
    stem = os.path.splitext(source)[0]
    return (os.path.join(CSRC_DIR, source),
            os.path.join(directory or build_dir(),
                         f"{stem}-{source_key(source)}.so"))


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
        os.makedirs(os.path.dirname(so), exist_ok=True)
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
            so = _target(source)[1]
            _loaded[source] = ctypes.CDLL(so)
            _loaded_from[source] = so
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


def export_builds(sources: Iterable[str], directory: str) -> Dict[str, str]:
    """Make `directory` hold a build of every given source -> {source:
    library path}.  A build already there stays; a library this process
    loaded is copied (same key, same bytes); any other source raises:
    load it first.  Counts nothing: this writes an artifact, it loads
    no library."""
    os.makedirs(directory, exist_ok=True)
    with _lock:
        loaded_from = dict(_loaded_from)
    out = {}
    for source in sources:
        so = _target(source, directory)[1]
        out[source] = so
        if os.path.exists(so):
            continue
        have = loaded_from.get(source)
        if not have or os.path.basename(have) != os.path.basename(so):
            raise RuntimeError(
                f"export_builds: this process loaded no build of the "
                f"current {source}; load it before exporting")
        tmp = f"{so}.{os.getpid()}.tmp"
        shutil.copyfile(have, tmp)
        os.replace(tmp, so)
    return out


def nvcc_version() -> Optional[str]:
    """The last line of `nvcc --version` (the release and build), or
    None where there is no nvcc."""
    try:
        res = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60)
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    return lines[-1] if lines else None
