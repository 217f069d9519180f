"""conll05: semantic-role-labeling tuples (word, predicate contexts, mark,
IOB label sequence).

Reference: Paddle's python/paddle/v2/dataset/conll05.py — the
public CoNLL-2005 test split (gzipped parallel words/props streams inside
a tarball; props' bracketed spans converted to B-/I-/O tags) plus
downloaded word/verb/label dicts and a Wikipedia embedding table; the
reader emits 9 slots per (sentence, predicate) pair: word_ids, five
predicate-context id sequences (broadcast to sentence length), verb_ids,
a 5-token predicate-window mark, IOB label ids.  Real corpus under
PADDLE_TPU_DATASET=auto|real; synthetic fallback offline.
"""
from __future__ import annotations

import gzip
import tarfile

from . import common
from .common import cached, fixed_rng

__all__ = ["get_dict", "get_embedding", "test", "train", "fetch",
           "corpus_reader", "reader_creator", "load_dict"]

DATA_URL = "http://www.cs.upc.edu/~srlconll/conll05st-tests.tar.gz"
DATA_MD5 = "387719152ae52d60422c016e92a742fc"
_DICT_BASE = "http://paddlepaddle.bj.bcebos.com/demo/srl_dict_and_embedding/"
WORDDICT_URL = _DICT_BASE + "wordDict.txt"
WORDDICT_MD5 = "ea7fb7d4c75cc6254716f0177a506baa"
VERBDICT_URL = _DICT_BASE + "verbDict.txt"
VERBDICT_MD5 = "0d2977293bbb6cbefab5b0f97db1e77c"
TRGDICT_URL = _DICT_BASE + "targetDict.txt"
TRGDICT_MD5 = "d8c7f03ceb5fc2e5a0fa7503a4353751"
EMB_URL = _DICT_BASE + "emb"
EMB_MD5 = "bf436eb0faa1f6f9103017f8be57cdb7"

UNK_IDX = 0
WORDS_NAME = "conll05st-release/test.wsj/words/test.wsj.words.gz"
PROPS_NAME = "conll05st-release/test.wsj/props/test.wsj.props.gz"

_WORDS, _VERBS, _LABELS = 4000, 300, 59  # synthetic dims


def load_dict(filename):
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _props_to_iob(lbl):
    """One predicate's props column (e.g. ``(A0* * *) (V*) *``) ->
    B-/I-/O tag sequence (reference conll05.py:86-106)."""
    out = []
    cur = "O"
    in_bracket = False
    for token in lbl:
        if token == "*" and not in_bracket:
            out.append("O")
        elif token == "*" and in_bracket:
            out.append("I-" + cur)
        elif token == "*)":
            out.append("I-" + cur)
            in_bracket = False
        elif "(" in token and ")" in token:
            cur = token[1:token.find("*")]
            out.append("B-" + cur)
            in_bracket = False
        elif "(" in token:
            cur = token[1:token.find("*")]
            out.append("B-" + cur)
            in_bracket = True
        else:
            raise RuntimeError(f"Unexpected label: {token}")
    return out


def corpus_reader(data_path, words_name=WORDS_NAME,
                  props_name=PROPS_NAME):
    """Yield (sentence words, predicate, IOB tag sequence) per
    (sentence, predicate) pair of the gzipped parallel streams."""

    def reader():
        with tarfile.open(data_path) as tf, \
                gzip.GzipFile(fileobj=tf.extractfile(words_name)) as wf, \
                gzip.GzipFile(fileobj=tf.extractfile(props_name)) as pf:
            sentence = []
            columns = []  # one row per word: [verb-col, tag-col...]
            for wline, pline in zip(wf, pf):
                word = wline.decode().strip()
                fields = pline.decode().strip().split()
                if not fields:  # blank line: end of sentence
                    if columns:
                        n_cols = len(columns[0])
                        verbs = [row[0] for row in columns
                                 if row[0] != "-"]
                        for i in range(1, n_cols):
                            tags = _props_to_iob(
                                [row[i] for row in columns])
                            yield sentence, verbs[i - 1], tags
                    sentence = []
                    columns = []
                else:
                    sentence.append(word)
                    columns.append(fields)

    return reader


def reader_creator(corpus, word_dict, predicate_dict, label_dict):
    """9-slot samples with the predicate 5-token context window
    broadcast to sentence length and the window marked (reference
    conll05.py:130-178)."""

    def reader():
        for sentence, predicate, labels in corpus():
            n = len(sentence)
            v = labels.index("B-V")
            mark = [0] * n

            def ctx(off, fallback):
                i = v + off
                if 0 <= i < n:
                    mark[i] = 1
                    return sentence[i]
                return fallback

            ctx_n2 = ctx(-2, "bos")
            ctx_n1 = ctx(-1, "bos")
            ctx_0 = ctx(0, sentence[v])
            ctx_p1 = ctx(1, "eos")
            ctx_p2 = ctx(2, "eos")

            def widx(w):
                return word_dict.get(w, UNK_IDX)

            yield ([widx(w) for w in sentence],
                   [widx(ctx_n2)] * n, [widx(ctx_n1)] * n,
                   [widx(ctx_0)] * n, [widx(ctx_p1)] * n,
                   [widx(ctx_p2)] * n,
                   [predicate_dict.get(predicate, UNK_IDX)] * n,
                   mark,
                   [label_dict[t] for t in labels])

    return reader


def fetch():
    common.download(WORDDICT_URL, "conll05st", WORDDICT_MD5)
    common.download(VERBDICT_URL, "conll05st", VERBDICT_MD5)
    common.download(TRGDICT_URL, "conll05st", TRGDICT_MD5)
    common.download(EMB_URL, "conll05st", EMB_MD5)
    return common.download(DATA_URL, "conll05st", DATA_MD5)


# -- synthetic fallback ------------------------------------------------------


def _synthetic_dicts():
    return ({f"w{i}": i for i in range(_WORDS)},
            {f"v{i}": i for i in range(_VERBS)},
            {f"l{i}": i for i in range(_LABELS)})


def _synthetic_reader(tag, n):
    def reader():
        r = fixed_rng("conll05/" + tag)
        for _ in range(n):
            ln = int(r.randint(4, 12))
            words = [int(w) for w in r.randint(0, _WORDS, ln)]
            verb_pos = int(r.randint(0, ln))
            verb = int(r.randint(0, _VERBS))
            ctx = [words[max(0, min(ln - 1, verb_pos + d))]
                   for d in (-2, -1, 0, 1, 2)]
            mark = [1 if i == verb_pos else 0 for i in range(ln)]
            labels = [int(lab) for lab in r.randint(0, _LABELS, ln)]
            yield (words, [ctx[0]] * ln, [ctx[1]] * ln, [ctx[2]] * ln,
                   [ctx[3]] * ln, [ctx[4]] * ln, [verb] * ln, mark,
                   labels)

    return reader


@cached
def get_dict():
    """(word_dict, verb_dict, label_dict)."""
    paths = common.fetch_real("conll05st", lambda: (
        common.download(WORDDICT_URL, "conll05st", WORDDICT_MD5),
        common.download(VERBDICT_URL, "conll05st", VERBDICT_MD5),
        common.download(TRGDICT_URL, "conll05st", TRGDICT_MD5)))
    if paths is None:
        return _synthetic_dicts()
    return tuple(load_dict(p) for p in paths)


def get_embedding():
    """Path to the pretrained Wikipedia embedding table (raw file, as the
    reference returns), or None offline."""
    return common.fetch_real(
        "conll05st", lambda: common.download(EMB_URL, "conll05st",
                                             EMB_MD5))


def test():
    tar = common.fetch_real(
        "conll05st", lambda: common.download(DATA_URL, "conll05st",
                                             DATA_MD5))
    if tar is None:
        return _synthetic_reader("test", 256)
    word_dict, verb_dict, label_dict = get_dict()
    return reader_creator(corpus_reader(tar), word_dict, verb_dict,
                          label_dict)


def train():
    """CoNLL-2005 train is not freely distributable (reference ships only
    the public test split); offline and real mode both serve the
    synthetic generator here unless users repoint DATA_URL at their own
    licensed copy."""
    return _synthetic_reader("train", 1024)
