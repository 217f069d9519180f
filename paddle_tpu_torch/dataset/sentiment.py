"""sentiment (NLTK movie_reviews): word-id sequence -> 0/1 polarity
(neg=0, pos=1).

Reference: Paddle's python/paddle/v2/dataset/sentiment.py — the
nltk movie_reviews corpus (downloaded into DATA_HOME), a frequency-
sorted word dict over the whole corpus, neg/pos files interleaved, the
first 1600 samples as train and the last 400 as test.  Real corpus
under PADDLE_TPU_DATASET=auto|real (also served when the corpus is
already cached in DATA_HOME or on nltk's default path); synthetic
half-vocab fallback offline.
"""
from __future__ import annotations

import collections
from itertools import chain

from . import common
from .common import cached, fixed_rng

__all__ = ["get_word_dict", "train", "test"]

NUM_TRAINING_INSTANCES = 1600
NUM_TOTAL_INSTANCES = 2000

_VOCAB = 3000  # synthetic vocab


def _movie_reviews():
    """The nltk movie_reviews corpus reader, or None offline (download
    lands in DATA_HOME like every other corpus here)."""

    def fetch():
        import nltk
        from nltk.corpus import movie_reviews

        home = common.data_home()
        if home not in nltk.data.path:
            nltk.data.path.append(home)
        try:
            movie_reviews.categories()
        except LookupError:
            if not nltk.download("movie_reviews", download_dir=home,
                                 quiet=True):
                raise RuntimeError("nltk movie_reviews download failed")
            movie_reviews.categories()
        return movie_reviews

    return common.fetch_real("sentiment", fetch)


@cached
def _real_data():
    movie_reviews = _movie_reviews()
    if movie_reviews is None:
        return None
    word_freq = collections.defaultdict(int)
    for category in movie_reviews.categories():
        for fid in movie_reviews.fileids(category):
            for w in movie_reviews.words(fid):
                word_freq[w.lower()] += 1
    # frequency-sorted dict (ties by word for reproducibility; the
    # reference's py2 sort left ties unspecified)
    ranked = sorted(word_freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_dict = {w: i for i, (w, _) in enumerate(ranked)}
    # interleave neg/pos files (reference sort_files)
    files = list(chain.from_iterable(
        zip(movie_reviews.fileids("neg"), movie_reviews.fileids("pos"))))
    data = []
    for fid in files:
        label = 0 if "neg" in fid else 1
        data.append(([word_dict[w.lower()]
                      for w in movie_reviews.words(fid)], label))
    return word_dict, data


# -- synthetic fallback ------------------------------------------------------


def _synthetic_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _synthetic_reader(tag, n):
    def reader():
        r = fixed_rng("sentiment/" + tag)
        half = _VOCAB // 2
        for _ in range(n):
            label = int(r.randint(0, 2))
            ln = int(r.randint(10, 50))
            lo, hi = (0, half) if label == 0 else (half, _VOCAB)
            yield [int(t) for t in r.randint(lo, hi, ln)], label

    return reader


# -- public surface ----------------------------------------------------------


def get_word_dict():
    real = _real_data()
    return _synthetic_dict() if real is None else real[0]


def train():
    real = _real_data()
    if real is None:
        return _synthetic_reader("train", 1024)

    def reader():
        yield from real[1][:NUM_TRAINING_INSTANCES]

    return reader


def test():
    real = _real_data()
    if real is None:
        return _synthetic_reader("test", 256)

    def reader():
        yield from real[1][NUM_TRAINING_INSTANCES:NUM_TOTAL_INSTANCES]

    return reader
