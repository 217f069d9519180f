"""Native runtime library: C++ host-side services behind a ctypes C ABI
(counterpart of paddle_tpu/native/).

Paddle's runtime layer is native C++ (channels framework/channel.h,
thread pool framework/threadpool.h, buddy allocator
memory/detail/buddy_allocator.h, reader pipeline framework/reader.h).
This package is the port's copy of that layer: `src/` holds the same
sources as the JAX package's, so the loader shuffles and batches the
same samples into the same batches for the same seed.  PyTorch owns the
device; this layer owns host concurrency, staging memory and data
loading.

Two libraries are built with `g++` at first use into `_build/` (never
into `src/`), each keyed by the text of its sources, its flags, the
compiler's version and target and the interpreter's version, as
kernels/cuda_build.py keys the CUDA builds:

- `_native` (`channel.cc`, `threadpool.cc`, `allocator.cc`,
  `loader.cc`): `Channel`, `ThreadPool`, `BuddyAllocator`,
  `NativeLoader`;
- `_capi` (`capi.cc`): the C inference ABI, which embeds CPython and
  calls `paddle_tpu_torch.capi_runtime` (`capi_library`).  Its include
  and link flags come from `sysconfig`; it links the shared libpython
  where the interpreter has one (`shared_libpython`), so that a C host
  can link it (`build_capi_host`), and otherwise leaves the Python
  symbols to the process that loads it.

A missing compiler or a failed build raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import List, Optional

__all__ = ["Channel", "ThreadPool", "BuddyAllocator", "NativeLoader", "lib",
           "capi_library", "build_capi_host", "shared_libpython",
           "BUILD_DIR"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "src")
BUILD_DIR = os.path.join(_DIR, "_build")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
NATIVE_SOURCES = ("channel.cc", "threadpool.cc", "allocator.cc",
                  "loader.cc")
_lock = threading.Lock()
_lib = None
_toolchains = {}


def _compiler(name: str) -> str:
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found on PATH: the native library "
                           "is built from source at first use")
    return found


def _toolchain(compiler: str) -> str:
    """The compiler's version and target machine, and the interpreter's
    version: a build made by another toolchain is not reused."""
    if compiler not in _toolchains:
        res = subprocess.run([_compiler(compiler), "-dumpfullversion",
                              "-dumpmachine"], capture_output=True,
                             text=True)
        _toolchains[compiler] = res.stdout + sys.version
    return _toolchains[compiler]


def _key(paths, flags, compiler) -> str:
    h = hashlib.sha1()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode() + _toolchain(compiler).encode())
    return h.hexdigest()[:16]


def _build(stem: str, sources, compiler: str, flags, link=()) -> str:
    """Compile `sources` (paths) into `_build/<stem>-<key>[.so]`, unless
    that exact build exists; -> its path.  Raises on a failed build."""
    headers = sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                     if f.endswith(".h"))
    key = _key(list(sources) + headers, list(flags) + list(link), compiler)
    shared = "-shared" in flags
    out = os.path.join(BUILD_DIR, f"{stem}-{key}" + (".so" if shared
                                                     else ""))
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_compiler(compiler), *flags, *sources, *link, "-o", tmp]
        # lint: blocking-under-lock-ok — the compiler IS the critical
        # section: one first caller builds while the others wait for it
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"failed to build {stem} (exit {res.returncode}): "
                f"{' '.join(cmd)}\n{(res.stdout + res.stderr)[-4000:]}")
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """Build (when no build of these sources exists) and load the
    runtime library."""
    global _lib
    if _lib is None:
        path = _build("_native",
                      [os.path.join(SRC_DIR, s) for s in NATIVE_SOURCES],
                      "g++", (*CXXFLAGS, "-shared"))
        with _lock:
            if _lib is None:
                lib_ = ctypes.CDLL(path)
                _declare(lib_)
                _lib = lib_
    return _lib


def shared_libpython() -> Optional[str]:
    """The running interpreter's shared libpython (a path), or None
    when it has only a static one."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        return None
    name = sysconfig.get_config_var("LDLIBRARY") or ""
    for d in (sysconfig.get_config_var("LIBDIR"),
              os.path.join(sys.base_prefix, "lib")):
        if d and name and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    return None


def _python_flags():
    """-> (compile flags, link flags) for code that embeds this
    interpreter, from sysconfig."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise RuntimeError(f"Python.h not found under {include}: the C "
                           "inference ABI needs the interpreter's headers")
    libpy = shared_libpython()
    if libpy is None:
        return [f"-I{include}"], []
    libdir = os.path.dirname(libpy)
    version = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    extra = (sysconfig.get_config_var("LIBS") or "").split()
    return [f"-I{include}"], [f"-L{libdir}", f"-lpython{version}",
                              f"-Wl,-rpath,{libdir}", *extra]


def capi_library() -> str:
    """Path of the C inference ABI's library (`_capi`), built at first
    use.  Its six functions are those of the JAX package's `_capi.so`;
    the session it opens runs the port's Executor."""
    cflags, link = _python_flags()
    return _build("_capi", [os.path.join(SRC_DIR, "capi.cc")], "g++",
                  (*CXXFLAGS, *cflags, "-shared"), link)


def build_capi_host() -> str:
    """Build `src/capi_host.c`, a standalone C program that links the C
    ABI and runs one float32 feed through a saved inference model
    (usage in the source) -> its path.  Needs a shared libpython
    (`shared_libpython`): without one a C host cannot embed the
    interpreter, and this raises."""
    if shared_libpython() is None:
        raise RuntimeError("the interpreter has no shared libpython: a "
                           "standalone C host cannot embed it")
    so = capi_library()
    return _build("capi_host", [os.path.join(SRC_DIR, "capi_host.c")],
                  "gcc", ("-O2", "-Wall"),
                  [so, f"-Wl,-rpath,{os.path.dirname(so)}"])


def _declare(l: ctypes.CDLL):
    p, sz, i, u64 = (
        ctypes.c_void_p,
        ctypes.c_size_t,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
    )
    l.pt_channel_create.restype = p
    l.pt_channel_create.argtypes = [sz, sz]
    l.pt_channel_send.restype = i
    l.pt_channel_send.argtypes = [p, ctypes.c_void_p]
    l.pt_channel_recv.restype = i
    l.pt_channel_recv.argtypes = [p, ctypes.c_void_p]
    l.pt_channel_close.argtypes = [p]
    l.pt_channel_size.restype = sz
    l.pt_channel_size.argtypes = [p]
    l.pt_channel_is_closed.restype = i
    l.pt_channel_is_closed.argtypes = [p]
    l.pt_channel_destroy.argtypes = [p]

    l.pt_threadpool_create.restype = p
    l.pt_threadpool_create.argtypes = [sz]
    l.pt_threadpool_num_threads.restype = sz
    l.pt_threadpool_num_threads.argtypes = [p]
    l.pt_threadpool_submit.argtypes = [p, ctypes.c_void_p, ctypes.c_void_p]
    l.pt_threadpool_wait.argtypes = [p]
    l.pt_threadpool_destroy.argtypes = [p]

    l.pt_buddy_create.restype = p
    l.pt_buddy_create.argtypes = [sz, sz]
    l.pt_buddy_alloc.restype = p
    l.pt_buddy_alloc.argtypes = [p, sz]
    l.pt_buddy_free.argtypes = [p, ctypes.c_void_p]
    l.pt_buddy_stats.argtypes = [p, u64]
    l.pt_buddy_destroy.argtypes = [p]

    l.pt_loader_create.restype = p
    l.pt_loader_create.argtypes = [
        sz, ctypes.POINTER(ctypes.c_size_t), sz, sz, ctypes.c_uint64, sz, i,
    ]
    l.pt_loader_push.restype = i
    l.pt_loader_push.argtypes = [p, ctypes.POINTER(ctypes.c_void_p)]
    l.pt_loader_finish_epoch.argtypes = [p]
    l.pt_loader_next.restype = p
    l.pt_loader_next.argtypes = [p]
    l.pt_batch_n.restype = sz
    l.pt_batch_n.argtypes = [p]
    l.pt_batch_slot.restype = p
    l.pt_batch_slot.argtypes = [p, sz]
    l.pt_batch_release.argtypes = [p, p]
    l.pt_loader_destroy.argtypes = [p]


TASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class Channel:
    """CSP channel of fixed-size byte elements (capacity 0 = unbuffered).

    Paddle's Channel semantics (framework/channel.h): blocking
    send/recv, close() wakes waiters, recv drains a closed channel.
    """

    def __init__(self, elem_size: int, capacity: int = 0):
        self._l = lib()
        self.elem_size = elem_size
        self._h = self._l.pt_channel_create(elem_size, capacity)

    def send(self, data: bytes) -> bool:
        if len(data) != self.elem_size:
            raise ValueError(
                f"element must be {self.elem_size} bytes, got {len(data)}"
            )
        buf = ctypes.create_string_buffer(data, self.elem_size)
        return bool(self._l.pt_channel_send(
            self._h, ctypes.cast(buf, ctypes.c_void_p)))

    def recv(self):
        buf = ctypes.create_string_buffer(self.elem_size)
        ok = self._l.pt_channel_recv(self._h,
                                     ctypes.cast(buf, ctypes.c_void_p))
        return buf.raw if ok else None

    def close(self):
        self._l.pt_channel_close(self._h)

    def __len__(self):
        return self._l.pt_channel_size(self._h)

    @property
    def closed(self) -> bool:
        return bool(self._l.pt_channel_is_closed(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.pt_channel_destroy(self._h)
            self._h = None


class ThreadPool:
    """Native worker pool (Paddle's framework/threadpool.h)."""

    def __init__(self, num_threads: int = 0):
        self._l = lib()
        self._h = self._l.pt_threadpool_create(num_threads)
        self._keepalive: List = []

    @property
    def num_threads(self) -> int:
        return self._l.pt_threadpool_num_threads(self._h)

    def submit(self, fn):
        """Run zero-arg python callable on a pool thread."""
        cb_holder = []

        def trampoline(_):
            try:
                fn()
            finally:
                self._keepalive.remove(cb_holder[0])

        cb = TASK_FN(trampoline)
        cb_holder.append(cb)
        self._keepalive.append(cb)
        self._l.pt_threadpool_submit(
            self._h, ctypes.cast(cb, ctypes.c_void_p), None
        )

    def wait(self):
        self._l.pt_threadpool_wait(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.pt_threadpool_destroy(self._h)
            self._h = None


class NativeLoader:
    """Shuffle/batch/prefetch input pipeline running on native threads.

    Python pushes fixed-shape samples (the ctypes call releases the GIL
    for the copy), a native worker shuffles with a seeded RNG, stacks
    samples into contiguous per-slot batch buffers from a buddy-allocated
    arena, and double-buffers ready batches (`prefetch_depth`) so host
    assembly overlaps device compute.

    slots: list of (shape, dtype) per sample component, e.g.
           [((3, 32, 32), np.float32), ((1,), np.int32)].
    """

    def __init__(self, slots, batch_size, shuffle_buf=0, seed=0,
                 prefetch_depth=2, drop_last=False):
        import numpy as np

        self._l = lib()
        self.slots = [
            (tuple(shape), np.dtype(dt)) for shape, dt in slots
        ]
        self.batch_size = batch_size
        nbytes = [
            int(np.prod(shape)) * dt.itemsize for shape, dt in self.slots
        ]
        arr = (ctypes.c_size_t * len(nbytes))(*nbytes)
        self._h = self._l.pt_loader_create(
            len(nbytes), arr, batch_size, shuffle_buf, seed, prefetch_depth,
            1 if drop_last else 0,
        )

    def push(self, *arrays) -> bool:
        """Push one sample (one contiguous array per slot)."""
        import numpy as np

        if len(arrays) != len(self.slots):
            raise ValueError(
                f"expected {len(self.slots)} slots, got {len(arrays)}"
            )
        ptrs = (ctypes.c_void_p * len(arrays))()
        keep = []
        for i, (a, (shape, dt)) in enumerate(zip(arrays, self.slots)):
            a = np.ascontiguousarray(a, dtype=dt)
            if a.shape != shape:
                raise ValueError(
                    f"slot {i}: expected shape {shape}, got {a.shape}"
                )
            keep.append(a)
            ptrs[i] = a.ctypes.data
        return bool(self._l.pt_loader_push(self._h, ptrs))

    def finish_epoch(self):
        self._l.pt_loader_finish_epoch(self._h)

    def next_batch(self):
        """Blocking: next batch as a tuple of numpy arrays, or None at epoch
        end.  The arrays are copies owned by Python (safe to hold)."""
        import numpy as np

        b = self._l.pt_loader_next(self._h)
        if not b:
            return None
        n = self._l.pt_batch_n(b)
        out = []
        for i, (shape, dt) in enumerate(self.slots):
            addr = self._l.pt_batch_slot(b, i)
            nbytes = n * int(np.prod(shape)) * dt.itemsize
            buf = (ctypes.c_char * nbytes).from_address(addr)
            out.append(
                np.frombuffer(buf, dtype=dt).reshape((n,) + shape).copy()
            )
        self._l.pt_batch_release(self._h, b)
        return tuple(out)

    def run(self, sample_reader):
        """Feed `sample_reader` (yields per-slot tuples) on a background
        Python thread; yield assembled batches until the epoch drains."""
        def feed():
            for sample in sample_reader():
                if not isinstance(sample, (tuple, list)):
                    sample = (sample,)
                if not self.push(*sample):
                    return  # loader shut down
            self.finish_epoch()

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            b = self.next_batch()
            if b is None:
                break
            yield b
        t.join()

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.pt_loader_destroy(self._h)
            self._h = None


class BuddyAllocator:
    """Buddy-system host allocator (Paddle's
    memory/detail/buddy_allocator.h).

    alloc() returns raw addresses (ints) inside native arena chunks; use
    with `view()` to get zero-copy numpy arrays over allocator memory.
    """

    def __init__(self, min_block_log2: int = 6, chunk_log2: int = 26):
        self._l = lib()
        self._h = self._l.pt_buddy_create(min_block_log2, chunk_log2)

    def alloc(self, nbytes: int) -> int:
        p = self._l.pt_buddy_alloc(self._h, nbytes)
        if not p:
            raise MemoryError(f"buddy allocator failed for {nbytes} bytes")
        return p

    def free(self, addr: int):
        self._l.pt_buddy_free(self._h, addr)

    def view(self, addr: int, shape, dtype):
        import numpy as np

        dtype = np.dtype(dtype)
        n = int(np.prod(shape)) * dtype.itemsize
        buf = (ctypes.c_char * n).from_address(addr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._l.pt_buddy_stats(self._h, out)
        return {
            "arena_bytes": out[0],
            "in_use": out[1],
            "peak_in_use": out[2],
            "num_chunks": out[3],
        }

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.pt_buddy_destroy(self._h)
            self._h = None
