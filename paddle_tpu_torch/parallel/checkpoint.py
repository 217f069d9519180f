"""Sharded-training checkpoint and restore for the parallel executors.

Counterpart of paddle_tpu/parallel/checkpoint.py, with the same files.
Each process of the mesh writes the blocks of the states it holds (its
tensor-parallel blocks, its ZeRO-1 rows, its pipeline stage's states)
with their global index slices to its own `sharded_states.pK_of_N.npz`,
one copy of each block in the mesh; rank 0 then takes the md5 of the
directory and publishes it through io.py's meta / `__latest__` / GC
protocol.  A single process writes the whole states to one
`sharded_states.npz`, as the JAX package's single-process save does, so
a float32 checkpoint of the JAX package restores here.  Restore
assembles the global arrays from whichever layout the directory holds
and places them by THIS executor's layout, so a checkpoint saved by one
process count restores on another.
"""
from __future__ import annotations

import glob
import os
import uuid as uuid_mod
from typing import Dict

import numpy as np

STATES_FILENAME = "sharded_states.npz"
PSERVER_SHARD_FILENAME = "pserver_shard.npz"

__all__ = ["ShardedCheckpointMixin", "latest_pserver_shard"]


def latest_pserver_shard(snapshot_dir):
    """Newest md5-valid pserver shard snapshot under `snapshot_dir`:
    ``({name: host array}, round, meta)`` or ``(None, 0, None)``."""
    from .. import io as _io

    cp_dir, meta = _io.latest_checkpoint(snapshot_dir)
    if cp_dir is None or not os.path.exists(
            os.path.join(cp_dir, PSERVER_SHARD_FILENAME)):
        return None, 0, None
    with np.load(os.path.join(cp_dir, PSERVER_SHARD_FILENAME)) as z:
        data = {n: z[n] for n in z.files}
    rnd = int(meta.get("trainer_args", {}).get("round", 0))
    return data, rnd, meta


def _host(t) -> np.ndarray:
    import torch

    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            # npz has no bfloat16: its bits, read back by _from_bits
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(t)


class ShardedCheckpointMixin:
    """save_checkpoint / restore_checkpoint for an executor that gives
    `_ckpt_blocks()` -> [(name, local tensor, global shape, index slices
    ((start, stop) a dim), whether this rank writes the block)],
    `_ckpt_place({name: global array})`, `_ckpt_names()`, `_step` and
    `mesh`."""

    def _ckpt_collective(self):
        g = self.mesh.group
        if g is None:
            return None, 0, 1
        import torch.distributed as dist

        return g, dist.get_rank(g), dist.get_world_size(g)

    def save_checkpoint(self, dirname, trainer_args=None,
                        max_keep: int = 3) -> str:
        """Snapshot the training state (parameters and optimizer
        accumulators, ZeRO-1 rows and pipeline stages included) under
        `dirname` with {uuid, md5, timestamp} meta -> the uuid.  Every
        rank of the mesh calls it; the directory must be one that every
        process sees."""
        from .. import io as _io
        from ..core.resilience import fault_injector

        # chaos hook: a process dying mid-snapshot (the torn write the
        # md5-on-restore check catches)
        fault_injector().fire("checkpoint.save")
        group, pid, nproc = self._ckpt_collective()
        if group is not None:
            import torch.distributed as dist

            box = [uuid_mod.uuid4().hex if pid == 0 else None]
            dist.broadcast_object_list(box, src=dist.get_global_rank(
                group, 0), group=group)
            cp_uuid = box[0]
        else:
            cp_uuid = uuid_mod.uuid4().hex
        cp_dir = os.path.join(dirname, f"{_io.CHECKPOINT_PREFIX}_{cp_uuid}")
        os.makedirs(cp_dir, exist_ok=True)
        blocks = self._ckpt_blocks()
        if nproc == 1:
            np.savez(os.path.join(cp_dir, STATES_FILENAME),
                     **{n: _host(v) for n, v, _, _, _ in blocks})
        else:
            payload = {}
            for n, v, shape, idx, primary in blocks:
                payload[f"{n}//shape"] = np.asarray(shape, np.int64)
                payload[f"{n}//dtype"] = np.asarray(str(v.dtype).split(".")[-1])
                if primary:
                    payload[f"{n}//0//data"] = _host(v)
                    payload[f"{n}//0//index"] = np.asarray(idx, np.int64)
            np.savez(os.path.join(
                cp_dir, f"sharded_states.p{pid}_of_{nproc}.npz"), **payload)
            # every shard file exists before rank 0 hashes the directory
            dist.barrier(group)
        if pid == 0:
            args = dict(trainer_args or {})
            args.setdefault("step", self._step)
            args.setdefault("mesh_axes", dict(self.mesh.shape))
            args.setdefault("n_processes", nproc)
            _io.publish_checkpoint(dirname, cp_uuid, cp_dir, args, max_keep)
        if group is not None:
            dist.barrier(group)
        return cp_uuid

    @staticmethod
    def _has_sharded_states(d) -> bool:
        if os.path.exists(os.path.join(d, STATES_FILENAME)):
            return True
        return any(n.startswith("sharded_states.p") and n.endswith(".npz")
                   for n in os.listdir(d))

    @staticmethod
    def _load_shard_files(cp_dir) -> Dict[str, np.ndarray]:
        """{name: global array} from the per-process files of a
        multi-process save (any process count)."""
        files = sorted(glob.glob(
            os.path.join(cp_dir, "sharded_states.p*_of_*.npz")))
        n_expect = int(files[0].rsplit("_of_", 1)[1].split(".")[0])
        if len(files) != n_expect:
            raise RuntimeError(
                f"checkpoint {cp_dir} holds {len(files)} shard files but "
                f"was written by {n_expect} processes — incomplete "
                "snapshot")
        shapes, dtypes, pieces = {}, {}, {}
        for f in files:
            with np.load(f) as z:
                for key in z.files:
                    head, kind = key.rsplit("//", 1)
                    if kind == "shape":
                        shapes[head] = tuple(int(x) for x in z[key])
                    elif kind == "dtype":
                        dtypes[head] = str(z[key])
                    elif kind == "data":
                        name = head.rsplit("//", 1)[0]
                        pieces.setdefault(name, []).append(
                            (z[head + "//index"], z[key]))
        out = {}
        for n, shape in shapes.items():
            parts = pieces.get(n, [])
            full = np.empty(shape, parts[0][1].dtype if parts else np.float32)
            seen = np.zeros(shape, bool)
            for idx, data in parts:
                sl = tuple(slice(int(a), int(b)) for a, b in idx)
                full[sl] = data
                seen[sl] = True
            if not seen.all():
                raise RuntimeError(
                    f"checkpoint var {n!r}: the shard files do not cover "
                    "the whole array (corrupt or partial save)")
            out[n] = (full, dtypes[n])
        return out

    def restore_checkpoint(self, dirname):
        """Restore the newest md5-valid snapshot under `dirname` onto this
        executor's layout (any process count), the step counter too ->
        its meta, or None when the directory holds none."""
        from .. import io as _io

        cp_dir, meta = _io.latest_checkpoint(dirname)
        if cp_dir is None:
            if (not os.path.isdir(dirname)
                    or not _io._checkpoints_by_time(dirname)):
                return None
        if cp_dir is None or not self._has_sharded_states(cp_dir):
            raise RuntimeError(
                f"no snapshot under {dirname} carries {STATES_FILENAME} — "
                "it holds serial Executor saves only; restore those with "
                "io.load_checkpoint")
        path = os.path.join(cp_dir, STATES_FILENAME)
        if os.path.exists(path):
            with np.load(path) as z:
                data = {n: (z[n], None) for n in z.files}
        else:
            data = self._load_shard_files(cp_dir)
        names = self._ckpt_names()
        missing = sorted(set(names) - set(data))
        if missing:
            raise RuntimeError(
                f"checkpoint {meta['uuid']} lacks state var(s) {missing} — "
                "was it saved from a different program/strategy?")
        bad = [(n, data[n][0].shape, names[n]) for n in names
               if tuple(data[n][0].shape) != tuple(names[n])]
        if bad:
            raise RuntimeError(
                f"checkpoint {meta['uuid']} shape mismatch (saved vs "
                f"current): {bad} — same names, different architecture?")
        self._ckpt_place({n: _from_bits(*data[n]) for n in names})
        self._step = int(meta.get("trainer_args", {}).get("step",
                                                          self._step))
        return meta


def _from_bits(arr, dtype):
    """A saved array as a tensor: bfloat16 states come back from their
    int16 bits."""
    import torch

    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == "bfloat16" or (dtype is None and arr.dtype == np.int16):
        return t.view(torch.bfloat16)
    return t
