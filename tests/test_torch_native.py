"""The port's native runtime (paddle_tpu_torch/native): channels, thread
pool, buddy allocator and the loader behind `reader.native_pipeline`,
each case of tests/test_native.py held on the port's build, and the
loader held to the JAX package's: the same C++ sources, so the same
seeded shuffle and the same batches bit for bit.

The port builds its library with g++ into native/_build/ (keyed by the
sources, flags and toolchain), never into its source directory.
"""
import os
import struct
import threading
import time

import numpy as np
import pytest

import paddle_tpu.native as jnative
import paddle_tpu.reader as jreader

import paddle_tpu_torch.reader as treader
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch.native import (BuddyAllocator, Channel, NativeLoader,
                                     ThreadPool)


def pack(i):
    return struct.pack("<q", i)


def unpack(b):
    return struct.unpack("<q", b)[0]


def _code(path):
    """A C++ source's lines without its comment lines."""
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines()
                if not ln.lstrip().startswith("//")]


def test_library_builds_into_its_build_directory():
    lib = tnative.lib()
    assert os.path.dirname(lib._name) == tnative.BUILD_DIR
    assert os.path.basename(lib._name).startswith("_native-")
    src = os.listdir(tnative.SRC_DIR)
    assert not [f for f in src if f.endswith((".so", ".o"))]
    # the same sources as the JAX package's, comments aside
    jsrc = os.path.join(os.path.dirname(jnative.__file__), "src")
    for f in tnative.NATIVE_SOURCES:
        assert _code(os.path.join(tnative.SRC_DIR, f)) == \
            _code(os.path.join(jsrc, f)), f


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed to build"):
        tnative._build("bad", [str(bad)], "g++",
                       (*tnative.CXXFLAGS, "-shared"))


class TestChannel:
    def test_buffered_fifo(self):
        ch = Channel(8, capacity=4)
        for i in range(4):
            assert ch.send(pack(i))
        assert len(ch) == 4
        got = [unpack(ch.recv()) for _ in range(4)]
        assert got == [0, 1, 2, 3]

    @pytest.mark.parametrize("capacity", [1, 0],
                             ids=["buffered_blocks_when_full",
                                  "unbuffered_rendezvous"])
    def test_sender_blocks_until_received(self, capacity):
        ch = Channel(8, capacity=capacity)
        if capacity:
            ch.send(pack(0))        # the channel is full
        state = {"sent": False}

        def sender():
            ch.send(pack(42))
            state["sent"] = True

        t = threading.Thread(target=sender)
        t.start()
        time.sleep(0.05)
        assert not state["sent"]  # blocked: full, or no receiver yet
        want = [0, 42] if capacity else [42]
        assert unpack(ch.recv()) == want[0]
        t.join(timeout=5)
        assert state["sent"]
        if capacity:
            assert unpack(ch.recv()) == 42

    def test_close_wakes_receiver_and_drains(self):
        ch = Channel(8, capacity=4)
        ch.send(pack(7))
        ch.close()
        assert not ch.send(pack(8))  # send on closed fails
        assert unpack(ch.recv()) == 7  # drain buffered element
        assert ch.recv() is None  # then recv fails
        assert ch.closed

    def test_close_wakes_blocked_receiver(self):
        ch = Channel(8, capacity=0)
        out = {}

        def receiver():
            out["v"] = ch.recv()

        t = threading.Thread(target=receiver)
        t.start()
        time.sleep(0.05)
        ch.close()
        t.join(timeout=5)
        assert out["v"] is None

    def test_many_producers_consumers(self):
        ch = Channel(8, capacity=16)
        n_prod, per = 4, 50
        results = []
        res_lock = threading.Lock()

        def producer(base):
            for i in range(per):
                ch.send(pack(base + i))

        def consumer():
            while True:
                v = ch.recv()
                if v is None:
                    return
                with res_lock:
                    results.append(unpack(v))

        producers = [threading.Thread(target=producer, args=(k * 1000,))
                     for k in range(n_prod)]
        consumers = [threading.Thread(target=consumer) for _ in range(3)]
        for t in producers + consumers:
            t.start()
        for t in producers:
            t.join(timeout=10)
        ch.close()
        for t in consumers:
            t.join(timeout=10)
        assert sorted(results) == sorted(
            k * 1000 + i for k in range(n_prod) for i in range(per))

    def test_wrong_element_size_raises(self):
        with pytest.raises(ValueError, match="8 bytes"):
            Channel(8).send(b"abc")


class TestThreadPool:
    def test_runs_all_tasks(self):
        pool = ThreadPool(4)
        assert pool.num_threads == 4
        counter = {"n": 0}
        lock = threading.Lock()

        def job():
            with lock:
                counter["n"] += 1

        for _ in range(100):
            pool.submit(job)
        pool.wait()
        assert counter["n"] == 100

    def test_parallel_execution(self):
        pool = ThreadPool(4)
        t0 = time.time()
        for _ in range(4):
            pool.submit(lambda: time.sleep(0.2))
        pool.wait()
        # 4 x 0.2s sleeps on 4 threads should take ~0.2s, not 0.8s
        assert time.time() - t0 < 0.6


class TestBuddyAllocator:
    def test_alloc_free_reuse(self):
        a = BuddyAllocator(min_block_log2=6, chunk_log2=20)  # 1 MiB chunks
        p1 = a.alloc(100)
        p2 = a.alloc(100)
        assert p1 != p2
        assert a.stats()["in_use"] == 2 * 128  # rounded to next pow2
        a.free(p1)
        p3 = a.alloc(64)  # fits in the freed 128-block
        assert a.stats()["in_use"] == 128 + 64
        a.free(p2)
        a.free(p3)
        assert a.stats()["in_use"] == 0

    def test_coalescing(self):
        a = BuddyAllocator(min_block_log2=6, chunk_log2=16)  # 64 KiB chunks
        n = (1 << 16) // 64
        ptrs = [a.alloc(64) for _ in range(n)]
        assert a.stats()["num_chunks"] == 1
        for p in ptrs:
            a.free(p)
        assert a.stats()["in_use"] == 0
        big = a.alloc(1 << 16)
        assert a.stats()["num_chunks"] == 1  # buddies coalesced
        a.free(big)

    def test_huge_fallback(self):
        a = BuddyAllocator(min_block_log2=6, chunk_log2=16)
        p = a.alloc(1 << 20)  # larger than chunk -> system path
        arr = a.view(p, (1 << 20,), np.uint8)
        arr[:] = 7
        assert int(arr.sum()) == 7 << 20
        a.free(p)
        assert a.stats()["in_use"] == 0

    def test_view_roundtrip(self):
        a = BuddyAllocator()
        p = a.alloc(4 * 16)
        arr = a.view(p, (4, 4), np.float32)
        arr[:] = np.arange(16, dtype=np.float32).reshape(4, 4)
        arr2 = a.view(p, (16,), np.float32)
        np.testing.assert_array_equal(arr2, np.arange(16, dtype=np.float32))
        a.free(p)

    def test_stats_peak(self):
        a = BuddyAllocator(min_block_log2=6, chunk_log2=16)
        p1 = a.alloc(1024)
        p2 = a.alloc(1024)
        a.free(p1)
        a.free(p2)
        s = a.stats()
        assert s["peak_in_use"] == 2048
        assert s["in_use"] == 0


def _int_samples(n):
    def rd():
        for i in range(n):
            yield (np.array([i], np.int32),)

    return rd


class TestNativeLoader:
    def test_fifo_batching_and_remainder(self):
        ld = NativeLoader([((4,), np.float32), ((1,), np.int32)],
                          batch_size=8)

        def rd():
            for i in range(30):
                yield np.full(4, i, np.float32), np.array([i], np.int32)

        batches = list(ld.run(rd))
        assert [b[0].shape[0] for b in batches] == [8, 8, 8, 6]
        got = np.concatenate([b[1][:, 0] for b in batches])
        np.testing.assert_array_equal(got, np.arange(30))
        np.testing.assert_array_equal(batches[0][0][3], np.full(4, 3))

    def test_multi_epoch_reuse(self):
        ld = NativeLoader([((1,), np.int32)], batch_size=8)
        for _ in range(3):
            batches = list(ld.run(_int_samples(20)))
            assert [b[0].shape[0] for b in batches] == [8, 8, 4]

    def test_shuffle_is_seeded_permutation(self):
        def perm(seed):
            ld = NativeLoader([((1,), np.int32)], batch_size=10,
                              shuffle_buf=64, seed=seed)
            return np.concatenate(
                [b[0][:, 0] for b in ld.run(_int_samples(50))])

        p7a, p7b, p8 = perm(7), perm(7), perm(8)
        assert sorted(p7a.tolist()) == list(range(50))
        assert p7a.tolist() != list(range(50))  # actually shuffled
        np.testing.assert_array_equal(p7a, p7b)  # deterministic
        assert p7a.tolist() != p8.tolist()  # seed-dependent

    def test_drop_last(self):
        ld = NativeLoader([((1,), np.int32)], batch_size=8, drop_last=True)
        batches = list(ld.run(_int_samples(30)))
        assert [b[0].shape[0] for b in batches] == [8, 8, 8]

    def test_reader_native_pipeline(self):
        rd = treader.native_pipeline(_int_samples(25), [((1,), np.int32)],
                                     batch_size=10, shuffle_buf=32, seed=1)
        sizes = [b[0].shape[0] for b in rd()]
        assert sizes == [10, 10, 5]
        assert isinstance(rd.loader, NativeLoader)

    def test_backpressure_bounded(self):
        ld = NativeLoader([((128,), np.float32)], batch_size=4,
                          prefetch_depth=1)

        def rd():
            for i in range(200):
                yield (np.full(128, i, np.float32),)

        total = 0
        for b in ld.run(rd):
            total += b[0].shape[0]
            time.sleep(0.001)
        assert total == 200

    def test_wrong_sample_shape_raises(self):
        ld = NativeLoader([((4,), np.float32)], batch_size=2)
        with pytest.raises(ValueError, match="expected shape"):
            ld.push(np.zeros(5, np.float32))
        with pytest.raises(ValueError, match="1 slots"):
            ld.push(np.zeros(4, np.float32), np.zeros(4, np.float32))


def _mixed_samples(n, seed=3):
    r = np.random.RandomState(seed)
    imgs = r.standard_normal((n, 3, 5, 5)).astype(np.float32)
    ids = r.randint(0, 1 << 40, (n, 2)).astype(np.int64)

    def rd():
        for i in range(n):
            yield imgs[i], ids[i]

    return rd


@pytest.mark.parametrize("shuffle_buf,seed,drop_last",
                         [(0, 0, False), (16, 7, False), (64, 11, True),
                          (5, 123, False)])
def test_native_pipeline_yields_the_jax_packages_batches(shuffle_buf, seed,
                                                         drop_last):
    """Same sources, same seed: the port's batches are the JAX
    package's, bit for bit, slot by slot."""
    slots = [((3, 5, 5), np.float32), ((2,), np.int64)]
    kw = dict(batch_size=6, shuffle_buf=shuffle_buf, seed=seed,
              drop_last=drop_last)
    got = list(treader.native_pipeline(_mixed_samples(40), slots, **kw)())
    want = list(jreader.native_pipeline(_mixed_samples(40), slots, **kw)())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == 2
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


def test_buddy_allocator_matches_the_jax_packages_accounting():
    sizes = [100, 64, 4096, 70000, 1 << 18, 3, 1000]
    stats = []
    for cls in (BuddyAllocator, jnative.BuddyAllocator):
        a = cls(min_block_log2=6, chunk_log2=16)
        ptrs = [a.alloc(n) for n in sizes]
        mid = a.stats()
        for p in ptrs[::2]:
            a.free(p)
        stats.append((mid, a.stats()))
    assert stats[0] == stats[1]
