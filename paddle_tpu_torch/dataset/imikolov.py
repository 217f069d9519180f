"""imikolov (PTB): n-gram tuples or (src, trg) sequences of word ids.

Reference: Paddle's python/paddle/v2/dataset/imikolov.py —
downloads simple-examples.tgz, build_dict(min_word_freq) over
ptb.train.txt + ptb.valid.txt ordered by (-freq, word) with trailing
<unk>; NGRAM readers pad with <s>/<e>.  Real corpus under
PADDLE_TPU_DATASET=auto|real; sticky-markov synthetic fallback offline.
"""
from __future__ import annotations

import collections
import tarfile

from . import common
from .common import cached, fixed_rng

__all__ = ["train", "test", "build_dict", "DataType", "fetch"]

URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"
MD5 = "30177ea32e27c525793142b6bf2c8e2d"

TRAIN_FILE = "./simple-examples/data/ptb.train.txt"
TEST_FILE = "./simple-examples/data/ptb.valid.txt"

_VOCAB = 2073  # synthetic-fallback dict size (~reference min_word_freq=50)


class DataType:
    NGRAM = 1
    SEQ = 2


def word_count(f, word_freq=None):
    """Accumulate word frequencies over a text stream; every line also
    counts one <s> and one <e> (reference imikolov.py word_count)."""
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for line in f:
        if isinstance(line, bytes):
            line = line.decode("utf-8", errors="replace")
        for w in line.strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def build_dict_from_tar(tar_path, min_word_freq=50):
    with tarfile.open(tar_path) as tf:
        word_freq = word_count(tf.extractfile(TEST_FILE),
                               word_count(tf.extractfile(TRAIN_FILE)))
    word_freq.pop("<unk>", None)  # re-added as the last index
    kept = [(w, f) for w, f in word_freq.items() if f > min_word_freq]
    kept.sort(key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def reader_creator(tar_path, filename, word_idx, n, data_type):
    """NGRAM: every n-gram of <s> + line + <e>; SEQ: (<s>+line, line+<e>)
    pairs, skipping sources longer than n when n > 0."""

    def reader():
        with tarfile.open(tar_path) as tf:
            UNK = word_idx["<unk>"]
            for line in tf.extractfile(filename):
                line = line.decode("utf-8", errors="replace")
                if data_type == DataType.NGRAM:
                    assert n > -1, "Invalid gram length"
                    words = ["<s>"] + line.strip().split() + ["<e>"]
                    if len(words) >= n:
                        ids = [word_idx.get(w, UNK) for w in words]
                        for i in range(n, len(ids) + 1):
                            yield tuple(ids[i - n:i])
                elif data_type == DataType.SEQ:
                    ids = [word_idx.get(w, UNK)
                           for w in line.strip().split()]
                    src_seq = [word_idx["<s>"]] + ids
                    trg_seq = ids + [word_idx["<e>"]]
                    if n > 0 and len(src_seq) > n:
                        continue
                    yield src_seq, trg_seq
                else:
                    raise ValueError(f"unknown data_type {data_type}")

    return reader


def fetch():
    common.download(URL, "imikolov", MD5)


# -- synthetic fallback ------------------------------------------------------


def _synthetic_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _synthetic_reader(tag, n_samples, word_idx, n,
                      data_type=DataType.NGRAM):
    v = len(word_idx)

    def chain(r, length):
        # sticky chain: next word near the previous one
        w = int(r.randint(0, v))
        seq = [w]
        for _ in range(length - 1):
            w = (w + int(r.randint(0, 5))) % v
            seq.append(w)
        return seq

    def reader():
        r = fixed_rng("imikolov/" + tag)
        for _ in range(n_samples):
            if data_type == DataType.SEQ:
                seq = chain(r, int(r.randint(3, max(4, n or 12))))
                yield [word_idx.get("<s>", 0)] + seq, \
                    seq + [word_idx.get("<e>", 1)]
            else:
                yield tuple(chain(r, n))

    return reader


@cached
def build_dict(min_word_freq=50):
    tar_path = common.fetch_real(
        "imikolov", lambda: common.download(URL, "imikolov", MD5))
    if tar_path is None:
        return _synthetic_dict()
    return build_dict_from_tar(tar_path, min_word_freq)


def _make(tag, filename, n_synth, word_idx, n,
          data_type=DataType.NGRAM):
    tar_path = common.fetch_real(
        "imikolov", lambda: common.download(URL, "imikolov", MD5))
    if tar_path is None:
        return _synthetic_reader(tag, n_synth, word_idx, n, data_type)
    return reader_creator(tar_path, filename, word_idx, n, data_type)


def train(word_idx, n, data_type=DataType.NGRAM):
    return _make("train", TRAIN_FILE, 2048, word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _make("test", TEST_FILE, 512, word_idx, n, data_type)
