"""Dataset acquisition machinery + synthetic-data helpers (the port's
copy of paddle_tpu/dataset/common.py).

Reference: Paddle's python/paddle/v2/dataset/common.py (md5file :43,
download :62 — cache under DATA_HOME/<module>/, verify md5, retry up to 3;
split :151, cluster_files_reader :184).

Real corpora are downloaded, md5-verified and cached exactly like the
reference.  Because this stack must also run in zero-egress CI, every
dataset module keeps a deterministic SYNTHETIC generator with the same
schema, selected by ``PADDLE_TPU_DATASET``:

  * ``auto`` (default) — use the cached/downloaded real corpus; if the
    download fails (offline), warn once and serve synthetic data.
  * ``real`` — real data or raise.
  * ``synthetic`` — never touch the network.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import sys
import threading as _threading
import urllib.request
import zlib

import numpy as np

__all__ = ["DATA_HOME", "data_home", "md5file", "download", "data_mode",
           "fetch_real", "fixed_rng", "cached", "split",
           "cluster_files_reader"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def data_home() -> str:
    """DATA_HOME, env-overridable per call (tests point it at a tmpdir)."""
    return os.path.expanduser(
        os.environ.get("PADDLE_TPU_DATA_HOME", DATA_HOME))


def md5file(fname: str) -> str:
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: str,
             save_name: str = None, retry_policy=None) -> str:
    """Fetch `url` into DATA_HOME/<module_name>/, verify md5, return the
    local path.  A cached file with the right md5 short-circuits; corrupt
    or missing files are re-fetched under an exponential-backoff
    RetryPolicy (3 attempts by default; tune via
    PADDLE_TPU_DOWNLOAD_RETRY_* env vars) instead of hammering the
    mirror with immediate re-downloads."""
    from ..core.resilience import RetryPolicy, fault_injector

    dirname = os.path.join(data_home(), module_name)
    os.makedirs(dirname, exist_ok=True)
    filename = os.path.join(
        dirname, save_name if save_name else url.split("/")[-1])

    if os.path.exists(filename) and md5file(filename) == md5sum:
        return filename  # cached and valid: hashed exactly once

    policy = retry_policy or RetryPolicy.from_env(
        "DOWNLOAD_RETRY", max_attempts=3, base_delay=1.0, max_delay=30.0,
        deadline=600.0)
    state = policy.begin()
    while True:
        if _cache_only():
            raise RuntimeError(f"{filename} is not cached and downloads "
                               "are disabled (offline fallback probe)")
        try:
            fault_injector().fire("dataset.download")
            sys.stderr.write(f"Cache file {filename} not found, "
                             f"downloading {url}\n")
            tmp = filename + ".part"
            with urllib.request.urlopen(url, timeout=30) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            os.replace(tmp, filename)
            got = md5file(filename)
            if got != md5sum:
                raise IOError(f"md5 mismatch for {filename}: got {got}, "
                              f"want {md5sum}")
            return filename
        except Exception as e:
            state.record(e, what=f"Cannot download {url}")
            state.sleep()


def data_mode() -> str:
    mode = os.environ.get("PADDLE_TPU_DATASET", "auto").lower()
    if mode not in ("auto", "real", "synthetic"):
        raise ValueError(f"PADDLE_TPU_DATASET={mode!r}: expected "
                         "auto|real|synthetic")
    return mode


_offline_warned: set = set()
# Thread-local: download() raises instead of fetching when set.  Must be
# per-thread, not module-global — reader prefetch threads (xmap_readers /
# native_pipeline) can load datasets concurrently, and one call's
# cache-only window must not make another thread's first-time download
# raise and silently degrade to synthetic data.
_CACHE_ONLY = _threading.local()


def _cache_only() -> bool:
    return getattr(_CACHE_ONLY, "flag", False)


def fetch_real(module_name: str, fetch_fn):
    """Run `fetch_fn` (downloads, returns paths) under the dataset-mode
    policy.  Returns its result, or None meaning "serve synthetic".  In
    `auto` mode a failed download warns once per module; subsequent calls
    for that module still consult the on-disk cache (download()'s md5
    short-circuit) but never retry the network."""
    mode = data_mode()
    if mode == "synthetic":
        return None
    if mode == "auto" and module_name in _offline_warned:
        # a previous download failed — serve already-cached files if the
        # fetch can complete from disk alone, else fall back quietly
        try:
            _CACHE_ONLY.flag = True
            return fetch_fn()
        except Exception:
            return None
        finally:
            _CACHE_ONLY.flag = False
    try:
        return fetch_fn()
    except Exception as e:
        if mode == "real":
            raise
        if module_name not in _offline_warned:
            _offline_warned.add(module_name)
            sys.stderr.write(
                f"paddle_tpu_torch.dataset.{module_name}: download failed "
                f"({type(e).__name__}: {e}); serving synthetic data. "
                "Set PADDLE_TPU_DATASET=real to require the corpus.\n")
        return None


# ---------------------------------------------------------------------------
# synthetic helpers (zero-egress fallback generators)
# ---------------------------------------------------------------------------


def fixed_rng(tag: str) -> np.random.RandomState:
    """Deterministic per-dataset RNG (stable across processes/runs)."""
    return np.random.RandomState(zlib.crc32(tag.encode()) & 0x7FFFFFFF)


def cached(fn):
    """Memoize a dataset builder on its (hashable) arguments."""
    store = {}

    def wrapper(*args, **kwargs):
        k = (args, tuple(sorted(kwargs.items())))
        if k not in store:
            store[k] = fn(*args, **kwargs)
        return store[k]

    return wrapper


# ---------------------------------------------------------------------------
# cluster helpers (reference common.py split/cluster_files_reader)
# ---------------------------------------------------------------------------


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Materialize `reader` into numbered chunk files of `line_count`
    samples each; returns the number of files written."""
    import pickle

    dumper = dumper or pickle.dump
    lines = []
    index = 0
    for sample in reader():
        lines.append(sample)
        if len(lines) == line_count:
            with open(suffix % index, "wb") as f:
                dumper(lines, f)
            lines = []
            index += 1
    if lines:
        with open(suffix % index, "wb") as f:
            dumper(lines, f)
        index += 1
    return index


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Reader over this trainer's round-robin shard of chunk files."""
    import glob
    import pickle

    loader = loader or pickle.load

    def reader():
        file_list = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(file_list):
            if idx % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    for sample in loader(f):
                        yield sample

    return reader
