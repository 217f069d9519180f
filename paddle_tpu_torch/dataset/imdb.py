"""IMDB sentiment: variable-length word-id sequence -> label (pos=0, neg=1).

Reference: Paddle's python/paddle/v2/dataset/imdb.py — streams the
aclImdb_v1 tarball, ad-hoc tokenization (strip punctuation, lowercase,
split), build_dict(pattern, cutoff) ordered by (-freq, word) with a
trailing <unk>.  Real corpus under PADDLE_TPU_DATASET=auto|real;
synthetic half-vocab fallback offline.
"""
from __future__ import annotations

import re
import string
import tarfile

from . import common
from .common import cached, fixed_rng

__all__ = ["build_dict", "word_dict", "train", "test", "tokenize", "fetch"]

URL = "https://ai.stanford.edu/~amaas/data/sentiment/aclImdb_v1.tar.gz"
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"

_VOCAB = 5148  # synthetic-fallback vocab size

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def tokenize(pattern, tar_path=None):
    """Yield one token list per tar member whose name matches `pattern`
    (sequential tar scan — extractfile-by-name random access thrashes)."""
    tar_path = tar_path or common.download(URL, "imdb", MD5)
    with tarfile.open(tar_path) as tarf:
        tf = tarf.next()
        while tf is not None:
            if bool(pattern.match(tf.name)):
                text = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="replace")
                yield (text.rstrip("\n\r").translate(_PUNCT_TABLE)
                       .lower().split())
            tf = tarf.next()


def build_dict(pattern, cutoff, tar_path=None):
    """Word -> zero-based id, most-frequent first (ties alphabetical),
    words with freq <= cutoff dropped, '<unk>' appended last."""
    import collections

    word_freq = collections.defaultdict(int)
    for doc in tokenize(pattern, tar_path):
        for word in doc:
            word_freq[word] += 1
    kept = [(w, f) for w, f in word_freq.items() if f > cutoff]
    kept.sort(key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def reader_creator(pos_pattern, neg_pattern, word_idx, tar_path=None):
    """ONE sequential tar scan (lazy, on first iteration) labels each
    matching doc pos=0 / neg=1 — the reference's two tokenize() passes
    re-decompress the 80MB tarball per pattern."""
    UNK = word_idx["<unk>"]
    ins = []
    loaded = [False]

    def _load():
        resolved = tar_path or common.download(URL, "imdb", MD5)
        with tarfile.open(resolved) as tarf:
            tf = tarf.next()
            while tf is not None:
                label = (0 if pos_pattern.match(tf.name)
                         else 1 if neg_pattern.match(tf.name) else None)
                if label is not None:
                    text = tarf.extractfile(tf).read().decode(
                        "utf-8", errors="replace")
                    doc = (text.rstrip("\n\r").translate(_PUNCT_TABLE)
                           .lower().split())
                    ins.append(([word_idx.get(w, UNK) for w in doc],
                                label))
                tf = tarf.next()
        # reference reader order: all pos docs, then all neg docs
        ins.sort(key=lambda rec: rec[1])
        loaded[0] = True

    def reader():
        if not loaded[0]:
            _load()
        yield from ins

    return reader


def fetch():
    common.download(URL, "imdb", MD5)


# -- synthetic fallback ------------------------------------------------------


def _synthetic_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _synthetic_reader(tag, n, vocab_size):
    def reader():
        r = fixed_rng("imdb/" + tag)
        v = vocab_size or _VOCAB
        half = v // 2
        for _ in range(n):
            label = int(r.randint(0, 2))
            ln = int(r.randint(8, 64))
            lo, hi = (0, half) if label == 0 else (half, v)
            seq = [int(t) for t in r.randint(lo, hi, ln)]
            yield seq, label

    return reader


@cached
def word_dict():
    """Full-corpus dictionary (reference imdb.py word_dict: cutoff 150
    over train+test docs)."""
    tar_path = common.fetch_real(
        "imdb", lambda: common.download(URL, "imdb", MD5))
    if tar_path is None:
        return _synthetic_dict()
    return build_dict(re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$"),
                      150, tar_path)


def _make(tag, n_synth, word_idx):
    tar_path = common.fetch_real(
        "imdb", lambda: common.download(URL, "imdb", MD5))
    if tar_path is None:
        return _synthetic_reader(
            tag, n_synth, len(word_idx) if word_idx else None)
    if word_idx is None:
        word_idx = word_dict()
    return reader_creator(
        re.compile(rf"aclImdb/{tag}/pos/.*\.txt$"),
        re.compile(rf"aclImdb/{tag}/neg/.*\.txt$"), word_idx, tar_path)


def train(word_idx=None):
    return _make("train", 1024, word_idx)


def test(word_idx=None):
    return _make("test", 256, word_idx)
