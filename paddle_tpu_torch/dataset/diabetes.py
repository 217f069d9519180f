"""diabetes: REAL regression corpus, available fully offline.

The Efron et al. diabetes study — 442 real patients, 10 standardized
physiological/serum features, disease-progression target — ships inside
scikit-learn (`sklearn.datasets.load_diabetes`), so it needs no egress.
It is this repo's offline `data: real` stand-in for the reference's
fit-a-line corpus (uci_housing.py downloads housing.data when the
network allows; reference python/paddle/v2/dataset/uci_housing.py).

Samples follow the uci_housing convention: (features float32 [10],
target float32 [1]); the target is standardized to zero mean / unit
variance over the TRAIN split so an mse threshold reads as a fraction
of target variance.  Deterministic 80/20 split.
"""
from __future__ import annotations

import numpy as np

from .common import cached

__all__ = ["train", "test", "load_data", "feature_dim"]

feature_dim = 10


@cached
def load_data():
    from sklearn.datasets import load_diabetes

    d = load_diabetes()
    # sklearn ships columns scaled to unit NORM (variance ~1/n);
    # restandardize to unit variance so SGD steps are well-conditioned
    x = d.data.astype(np.float32)
    y = d.target.astype(np.float32)[:, None]
    idx = np.random.RandomState(42).permutation(len(y))
    x, y = x[idx], y[idx]
    n_train = int(len(y) * 0.8)
    x = (x - x[:n_train].mean(0)) / x[:n_train].std(0)
    mu, sd = y[:n_train].mean(), y[:n_train].std()
    y = (y - mu) / sd
    return (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])


def _reader(part):
    def reader():
        xs, ys = load_data()[part]
        for i in range(len(ys)):
            yield xs[i], ys[i]

    return reader


def train():
    """353 real patient rows as (features[10], standardized target[1])."""
    return _reader(0)


def test():
    """89 held-out rows."""
    return _reader(1)
