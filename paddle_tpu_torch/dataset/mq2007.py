"""mq2007: LETOR learning-to-rank surface — pointwise / pairwise /
listwise readers over 46-dim query-document feature vectors.

Reference: Paddle's python/paddle/v2/dataset/mq2007.py (gen_point,
gen_pair, gen_list over Query/QueryList records parsed from the LETOR
text format ``rel qid:N 1:v 2:v ... #docid = ...``).  The corpus ships
as a RAR archive (no rar extractor in this environment), so the REAL
path reads pre-extracted fold files from
``$DATA_HOME/mq2007/MQ2007/Fold1/{train,test}.txt`` when present
(`load_from_text` is the parser, fixture-tested); otherwise a
deterministic synthetic generator with learnable ranking signal serves
the same three formats.
"""
from __future__ import annotations

import os

import numpy as np

from . import common
from .common import cached, fixed_rng

__all__ = ["train", "test", "load_from_text"]


def load_from_text(filepath, fill_missing=-1.0):
    """Parse a LETOR-format file into [(feats [n_docs, 46] f32,
    rel [n_docs] int64)] grouped per qid (order preserved).  Missing
    feature ids get `fill_missing`."""
    queries = {}
    order = []
    with open(filepath) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            rel = int(parts[0])
            assert parts[1].startswith("qid:"), parts[1]
            qid = parts[1][4:]
            feats = np.full(NDIM, fill_missing, np.float32)
            for tok in parts[2:]:
                idx, val = tok.split(":")
                i = int(idx) - 1
                if 0 <= i < NDIM:
                    feats[i] = float(val)
            if qid not in queries:
                queries[qid] = ([], [])
                order.append(qid)
            queries[qid][0].append(feats)
            queries[qid][1].append(rel)
    return [(np.stack(queries[q][0]),
             np.asarray(queries[q][1], np.int64)) for q in order]


def _real_fold_file(which):
    path = os.path.join(common.data_home(), "mq2007", "MQ2007", "Fold1",
                        f"{which}.txt")
    return path if os.path.exists(path) else None

NDIM = 46
_N_QUERY = {"train": 120, "test": 30}
_DOCS_PER_QUERY = 8


@cached
def _weights():
    return fixed_rng("mq2007/w").randn(NDIM).astype(np.float32)


def _queries(tag):
    r = fixed_rng(f"mq2007/{tag}")
    w = _weights()
    out = []
    for _ in range(_N_QUERY[tag]):
        feats = r.randn(_DOCS_PER_QUERY, NDIM).astype(np.float32)
        score = feats @ w + 0.25 * r.randn(_DOCS_PER_QUERY)
        rel = np.digitize(score, np.percentile(score, [50, 80]))
        out.append((feats, rel.astype(np.int64)))
    return out


def _reader(tag, format):
    real = _real_fold_file(tag)

    def source():
        if real is not None:
            return load_from_text(real)
        return _queries(tag)

    def pointwise():
        for feats, rel in source():
            for f, y in zip(feats, rel):
                yield f, int(y)

    def pairwise():
        for feats, rel in source():
            for i in range(len(rel)):
                for j in range(len(rel)):
                    if rel[i] > rel[j]:
                        yield feats[i], feats[j]

    def listwise():
        for feats, rel in source():
            yield feats, rel

    table = {"pointwise": pointwise, "pairwise": pairwise,
             "listwise": listwise}
    if format not in table:
        raise ValueError(f"format must be one of {sorted(table)}, "
                         f"got {format!r}")
    return table[format]


def train(format="pairwise"):
    return _reader("train", format)


def test(format="pairwise"):
    return _reader("test", format)
