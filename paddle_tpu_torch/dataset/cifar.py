"""CIFAR-10/100: 3072 floats (3x32x32) in [0, 1] -> int label.

Reference: Paddle's python/paddle/v2/dataset/cifar.py — downloads
the python-pickle tarballs from cs.toronto.edu, yields
(sample/255 float32[3072], int label) batch-file by batch-file.
Real corpus under PADDLE_TPU_DATASET=auto|real; synthetic fallback
matches the [0, 1] range.
"""
from __future__ import annotations

import pickle
import tarfile

import numpy as np

from . import common
from .common import cached, fixed_rng

__all__ = ["train10", "test10", "train100", "test100", "reader_creator",
           "fetch"]

URL_PREFIX = "https://www.cs.toronto.edu/~kriz/"
CIFAR10_URL = URL_PREFIX + "cifar-10-python.tar.gz"
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"
CIFAR100_URL = URL_PREFIX + "cifar-100-python.tar.gz"
CIFAR100_MD5 = "eb9058c3a382ffc7106e4002c42a8d85"

_N_TRAIN, _N_TEST = 1024, 256  # synthetic-fallback sizes


def reader_creator(filename, sub_name):
    """Real parser: members of the tarball whose name contains `sub_name`
    are python pickles holding {'data': uint8 [N, 3072], 'labels' or
    'fine_labels': [N]}; yields (data/255 float32, int label)."""

    def read_batch(batch):
        data = batch[b"data"]
        labels = batch.get(b"labels", batch.get(b"fine_labels"))
        assert labels is not None, "batch has neither labels nor fine_labels"
        for sample, label in zip(data, labels):
            yield (sample / 255.0).astype(np.float32), int(label)

    def reader():
        with tarfile.open(filename, mode="r") as f:
            names = sorted(m.name for m in f if sub_name in m.name)
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                yield from read_batch(batch)

    return reader


def fetch():
    common.download(CIFAR10_URL, "cifar", CIFAR10_MD5)
    common.download(CIFAR100_URL, "cifar", CIFAR100_MD5)


# -- synthetic fallback ------------------------------------------------------


@cached
def _templates():
    r = fixed_rng("cifar")
    return r.rand(100, 3072).astype(np.float32)


def _synthetic_reader(tag, n, num_classes):
    def reader():
        t = _templates()
        r = fixed_rng(f"cifar/{tag}/{num_classes}")
        for _ in range(n):
            label = int(r.randint(0, num_classes))
            img = t[label] + 0.25 * r.randn(3072).astype(np.float32)
            yield np.clip(img, 0.0, 1.0).astype(np.float32), label

    return reader


def _make(url, md5, sub_name, tag, n_synth, num_classes):
    path = common.fetch_real("cifar",
                             lambda: common.download(url, "cifar", md5))
    if path is None:
        return _synthetic_reader(tag, n_synth, num_classes)
    return reader_creator(path, sub_name)


def train10():
    return _make(CIFAR10_URL, CIFAR10_MD5, "data_batch", "train",
                 _N_TRAIN, 10)


def test10():
    return _make(CIFAR10_URL, CIFAR10_MD5, "test_batch", "test",
                 _N_TEST, 10)


def train100():
    return _make(CIFAR100_URL, CIFAR100_MD5, "train", "train",
                 _N_TRAIN, 100)


def test100():
    return _make(CIFAR100_URL, CIFAR100_MD5, "test", "test",
                 _N_TEST, 100)
