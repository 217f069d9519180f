"""Dataset package with the reference's `paddle.v2.dataset` surface.

The port's own copy of paddle_tpu/dataset (numpy and the standard
library; sklearn, nltk, scipy and PIL imported lazily where a module
needs them), with the same environment variables, so a user's
`PADDLE_TPU_DATASET` and `PADDLE_TPU_DATA_HOME` carry over.

Reference: Paddle's python/paddle/v2/dataset/ (uci_housing, mnist,
cifar, imdb, imikolov, movielens, conll05, wmt14, wmt16, sentiment,
flowers, voc2012, mq2007).

mnist/cifar/imdb/imikolov/wmt16 download, md5-verify, cache and parse the
real corpora (reference common.py machinery, see `common.py`); when the
network is unavailable — or `PADDLE_TPU_DATASET=synthetic` — every module
serves DETERMINISTIC SYNTHETIC data with the same schema
(shapes/dtypes/vocab accessors), so models and book tests exercise
identical code paths offline.  `PADDLE_TPU_DATASET=real` makes a failed
download an error instead of a fallback.

Two REAL corpora need no network at all (they ship inside scikit-learn):
`uci_digits` (1,797 real 8x8 handwritten digits) and `diabetes` (442
real patient regression rows) — the offline `data: real` convergence
evidence (benchmark/run_book.py tags every row with its data source).
"""
from . import (  # noqa: F401
    cifar,
    conll05,
    diabetes,
    flowers,
    imdb,
    imikolov,
    mnist,
    movielens,
    mq2007,
    sentiment,
    uci_digits,
    uci_housing,
    voc2012,
    wmt14,
    wmt16,
)

__all__ = [
    "uci_housing",
    "mnist",
    "cifar",
    "flowers",
    "voc2012",
    "imdb",
    "imikolov",
    "movielens",
    "mq2007",
    "conll05",
    "wmt14",
    "wmt16",
    "sentiment",
]
