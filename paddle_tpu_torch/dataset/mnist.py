"""MNIST: 784 floats in [-1, 1] -> int label 0..9.

Reference: Paddle's python/paddle/v2/dataset/mnist.py — downloads
the IDX-format ubyte gzips, yields (img/255*2-1 float32[784], int label).
Real corpus under PADDLE_TPU_DATASET=auto|real; deterministic synthetic
gaussian-blob fallback offline (common.py policy).
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

from . import common
from .common import cached, fixed_rng

__all__ = ["train", "test", "reader_creator", "fetch"]

URL_PREFIX = "https://storage.googleapis.com/cvdf-datasets/mnist/"
TEST_IMAGE_MD5 = "9fb629c4189551a2d022fa330f9573f3"
TEST_LABEL_MD5 = "ec29112dd5afa0611ce80d1b7f02629c"
TRAIN_IMAGE_MD5 = "f68b3c2dcbeaaa9fbdd348bbdeb94873"
TRAIN_LABEL_MD5 = "d53e105ee54ea40749a09fcbcd1e9432"

_N_TRAIN, _N_TEST = 2048, 512  # synthetic-fallback sizes


def reader_creator(image_filename, label_filename, buffer_size=100):
    """Real IDX parser: gzip'd images (magic 2051) + labels (magic 2049);
    yields (float32[784] in [-1, 1], int label)."""

    def reader():
        with gzip.open(image_filename, "rb") as imgf, \
                gzip.open(label_filename, "rb") as lblf:
            magic, n_img, rows, cols = struct.unpack(">IIII", imgf.read(16))
            if magic != 2051:
                raise ValueError(f"{image_filename}: bad IDX image magic "
                                 f"{magic}")
            magic, n_lbl = struct.unpack(">II", lblf.read(8))
            if magic != 2049:
                raise ValueError(f"{label_filename}: bad IDX label magic "
                                 f"{magic}")
            if n_img != n_lbl:
                raise ValueError(f"image/label count mismatch: "
                                 f"{n_img} vs {n_lbl}")
            px = rows * cols
            remaining = n_img
            while remaining > 0:
                k = min(buffer_size, remaining)
                imgs = np.frombuffer(imgf.read(k * px), np.uint8)
                lbls = np.frombuffer(lblf.read(k), np.uint8)
                imgs = imgs.reshape(k, px).astype(np.float32)
                imgs = imgs / 255.0 * 2.0 - 1.0
                for i in range(k):
                    yield imgs[i, :], int(lbls[i])
                remaining -= k

    return reader


def _fetch(tag):
    img_md5, lbl_md5 = ((TRAIN_IMAGE_MD5, TRAIN_LABEL_MD5) if tag == "train"
                        else (TEST_IMAGE_MD5, TEST_LABEL_MD5))
    stem = "train" if tag == "train" else "t10k"
    return (common.download(f"{URL_PREFIX}{stem}-images-idx3-ubyte.gz",
                            "mnist", img_md5),
            common.download(f"{URL_PREFIX}{stem}-labels-idx1-ubyte.gz",
                            "mnist", lbl_md5))


def fetch():
    _fetch("train")
    _fetch("test")


# -- synthetic fallback ------------------------------------------------------


@cached
def _templates():
    r = fixed_rng("mnist")
    return r.randn(10, 784).astype(np.float32)


def _synthetic_reader(tag, n):
    def reader():
        t = _templates()
        r = fixed_rng("mnist/" + tag)
        for _ in range(n):
            label = int(r.randint(0, 10))
            img = t[label] + 0.5 * r.randn(784).astype(np.float32)
            img = np.clip(img, -1.0, 1.0).astype(np.float32)
            yield img, label

    return reader


def _make(tag, n_synth):
    paths = common.fetch_real("mnist", lambda: _fetch(tag))
    if paths is None:
        return _synthetic_reader(tag, n_synth)
    return reader_creator(*paths)


def train():
    return _make("train", _N_TRAIN)


def test():
    return _make("test", _N_TEST)
