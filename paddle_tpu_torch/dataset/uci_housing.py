"""uci_housing: 13 normalized float features -> 1 float target.

Reference: Paddle's python/paddle/v2/dataset/uci_housing.py —
downloads housing.data (506 rows x 14 space-separated floats), mean-
centers each feature scaled by its range, splits 80/20 train/test.
Real corpus under PADDLE_TPU_DATASET=auto|real; linear-ground-truth
synthetic fallback offline (common.py policy).
"""
from __future__ import annotations

import numpy as np

from . import common
from .common import cached, fixed_rng

__all__ = ["train", "test", "feature_names", "load_data", "fetch"]

URL = ("https://archive.ics.uci.edu/ml/machine-learning-databases/"
       "housing/housing.data")
MD5 = "d4accdce7a25600298819f8e28e8d593"

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]


def load_data(filename, feature_num=14, ratio=0.8):
    """Parse + normalize the real corpus: (x - avg) / (max - min) per
    feature column (target column untouched); 80/20 row split.  Returns
    (train_rows, test_rows) as float32 [n, 14] arrays."""
    data = np.fromfile(filename, sep=" ", dtype=np.float32)
    if data.size % feature_num != 0:
        raise ValueError(
            f"{filename}: {data.size} values is not a multiple of "
            f"{feature_num} columns")
    data = data.reshape(-1, feature_num)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.mean(axis=0)
    for i in range(feature_num - 1):
        data[:, i] = (data[:, i] - avgs[i]) / (maximums[i] - minimums[i])
    offset = int(data.shape[0] * ratio)
    return data[:offset], data[offset:]


def fetch():
    return common.download(URL, "uci_housing", MD5)


# -- synthetic fallback ------------------------------------------------------


@cached
def _synthetic():
    r = fixed_rng("uci_housing")
    n = 506
    x = r.randn(n, 13).astype(np.float32)
    w = r.randn(13, 1).astype(np.float32)
    y = (x @ w + 0.1 * r.randn(n, 1)).astype(np.float32)
    return x, y


def _synthetic_reader(lo, hi):
    def reader():
        x, y = _synthetic()
        for i in range(lo, hi):
            yield x[i], y[i]

    return reader


@cached
def _real_split():
    path = common.fetch_real("uci_housing", fetch)
    if path is None:
        return None
    return load_data(path)


def _make(part):
    split = _real_split()
    if split is None:
        return _synthetic_reader(0, 406) if part == 0 else \
            _synthetic_reader(406, 506)
    rows = split[part]

    def reader():
        for row in rows:
            yield row[:-1], row[-1:]

    return reader


def train():
    return _make(0)


def test():
    return _make(1)
