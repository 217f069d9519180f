"""wmt14: (src ids, trg ids, trg_next ids) translation triples.

Reference: Paddle's python/paddle/v2/dataset/wmt14.py — a shrunk
tarball whose members end in ``src.dict`` / ``trg.dict`` (one token per
line, first `dict_size` lines kept; <s>=0, <e>=1, <unk>=2) and
``train/train`` / ``test/test`` tab-separated parallel text; sequences
longer than 80 tokens are dropped.  Real corpus under
PADDLE_TPU_DATASET=auto|real; synthetic copy-task fallback offline.
"""
from __future__ import annotations

import tarfile

from . import common
from .common import fixed_rng

__all__ = ["train", "test", "get_dict", "reader_creator", "fetch",
           "start_id", "end_id", "unk_id"]

URL_TRAIN = ("http://paddlepaddle.cdn.bcebos.com/demo/"
             "wmt_shrinked_data/wmt14.tgz")
MD5_TRAIN = "0791583d57d5beb693b9414c5b36798c"

START = "<s>"
END = "<e>"
UNK = "<unk>"
start_id, end_id, unk_id = 0, 1, 2
UNK_IDX = unk_id
MAX_LEN = 80


def read_dicts(tar_file, dict_size):
    """(src_dict, trg_dict): first `dict_size` lines of the members
    ending in src.dict / trg.dict, token -> line number."""

    def to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.decode("utf-8", errors="replace").strip()] = i
        return out

    with tarfile.open(tar_file, mode="r") as f:
        src_names = [m.name for m in f if m.name.endswith("src.dict")]
        trg_names = [m.name for m in f if m.name.endswith("trg.dict")]
        assert len(src_names) == 1 and len(trg_names) == 1, \
            (src_names, trg_names)
        src_dict = to_dict(f.extractfile(src_names[0]), dict_size)
        trg_dict = to_dict(f.extractfile(trg_names[0]), dict_size)
    return src_dict, trg_dict


def reader_creator(tar_file, file_name, dict_size):
    def reader():
        src_dict, trg_dict = read_dicts(tar_file, dict_size)
        with tarfile.open(tar_file, mode="r") as f:
            names = [m.name for m in f if m.name.endswith(file_name)]
            for name in names:
                for line in f.extractfile(name):
                    parts = line.decode("utf-8", errors="replace") \
                        .strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_ids = [src_dict.get(w, UNK_IDX)
                               for w in [START] + parts[0].split() +
                               [END]]
                    trg_ids = [trg_dict.get(w, UNK_IDX)
                               for w in parts[1].split()]
                    if len(src_ids) > MAX_LEN or len(trg_ids) > MAX_LEN:
                        continue
                    yield (src_ids, [trg_dict[START]] + trg_ids,
                           trg_ids + [trg_dict[END]])

    return reader


def fetch():
    return common.download(URL_TRAIN, "wmt14", MD5_TRAIN)


def get_dict(dict_size, reverse=False):
    """(src_dict, trg_dict); reverse=True returns id -> token tables
    (reference wmt14.py get_dict)."""
    tar = common.fetch_real("wmt14", fetch)
    if tar is None:
        words = {START: start_id, END: end_id, UNK: unk_id}
        for i in range(3, dict_size):
            words[f"w{i}"] = i
        d = ({i: w for w, i in words.items()} if reverse else words)
        return d, dict(d)
    src_dict, trg_dict = read_dicts(tar, dict_size)
    if reverse:
        src_dict = {i: w for w, i in src_dict.items()}
        trg_dict = {i: w for w, i in trg_dict.items()}
    return src_dict, trg_dict


# -- synthetic fallback ------------------------------------------------------


def _synthetic_reader(tag, n, dict_size):
    def reader():
        r = fixed_rng("wmt14/" + tag)
        for _ in range(n):
            ln = int(r.randint(3, 10))
            src = [int(w) for w in r.randint(3, dict_size, ln)]
            trg = src  # copy task keeps convergence measurable
            yield src, [start_id] + trg, trg + [end_id]

    return reader


def _make(tag, file_name, n_synth, dict_size):
    tar = common.fetch_real("wmt14", fetch)
    if tar is None:
        return _synthetic_reader(tag, n_synth, dict_size)
    return reader_creator(tar, file_name, dict_size)


def train(dict_size):
    return _make("train", "train/train", 1024, dict_size)


def test(dict_size):
    return _make("test", "test/test", 256, dict_size)
