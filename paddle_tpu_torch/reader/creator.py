"""Reader creators (reference python/paddle/v2/reader/creator.py):
np_array, text_file and recordio (counterpart of
paddle_tpu/reader/creator.py).

`recordio` is the JAX package's self-contained record format (length-
prefixed pickled records), so either package reads the other's files.
`cloud_reader` pulls task chunks (recordio files) from the cloud master
(cloud/master.py): the same tasks, in the same order, as the JAX
package's reader gets from the same master.
"""
from __future__ import annotations

import glob
import pickle
import struct

__all__ = ["np_array", "text_file", "recordio", "cloud_reader",
           "write_recordio"]

_LEN = struct.Struct("<I")


def np_array(x):
    """Yield rows of a numpy array (reference creator.py:22)."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """Yield stripped lines of a text file (reference creator.py:42)."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def write_recordio(path, records) -> int:
    """Write pickled records length-prefixed; returns the record count
    (writer half of the recordio analogue)."""
    n = 0
    with open(path, "wb") as f:
        for r in records:
            payload = pickle.dumps(r)
            f.write(_LEN.pack(len(payload)))
            f.write(payload)
            n += 1
    return n


def _read_recordio_file(path):
    with open(path, "rb") as f:
        while True:
            head = f.read(_LEN.size)
            if len(head) < _LEN.size:
                return
            (n,) = _LEN.unpack(head)
            yield pickle.loads(f.read(n))


def _expand_paths(paths):
    """Comma-separated string or list -> concrete file list (glob
    patterns expanded; non-matching entries kept verbatim)."""
    if isinstance(paths, str):
        paths = paths.split(",")
    files = []
    for p in paths:
        files.extend(sorted(glob.glob(p)) or [p])
    return files


def recordio(paths, buf_size=100):
    """Reader over recordio file paths — comma-separated string, glob
    patterns supported (reference creator.py:60)."""
    from . import buffered

    files = _expand_paths(paths)

    def reader():
        for path in files:
            yield from _read_recordio_file(path)

    return buffered(reader, buf_size)


def cloud_reader(paths, master_endpoint, timeout_sec=5, buf_size=64):
    """Elastic cloud reader: the master shards the file list into tasks
    and hands them to trainers; any trainer may die/join (reference
    creator.py:91 cloud_reader over etcd; here the transport is the
    native master service, cloud/master.py)."""
    from ..cloud.master import MasterClient, task_record_reader
    from . import buffered

    files = _expand_paths(paths)
    client = MasterClient(master_endpoint, timeout=timeout_sec)
    client.set_dataset(files)

    def chunk_reader(chunk_path):
        yield from _read_recordio_file(chunk_path)

    reader = buffered(task_record_reader(client, chunk_reader), buf_size)
    # exposed so callers can release the connection (a live client blocks
    # a graceful master shutdown)
    reader.master_client = client
    return reader
