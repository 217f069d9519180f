"""wmt16: Multi30k-style en<->de translation — (src_ids, trg_ids,
trg_ids_next) with <s>/<e>/<unk> conventions.

Reference: Paddle's python/paddle/v2/dataset/wmt16.py — a tarball
whose wmt16/{train,val,test} members hold tab-separated "en\tde" lines;
dicts are built from the train split ordered by frequency, written to
DATA_HOME/wmt16/<lang>_<size>.dict with the three specials first, then
reused.  Real corpus under PADDLE_TPU_DATASET=auto|real; deterministic
affine-mapping synthetic fallback offline.
"""
from __future__ import annotations

import os
from collections import defaultdict

from . import common
from .common import fixed_rng

__all__ = ["train", "test", "validation", "get_dict", "fetch"]

DATA_URL = ("http://paddlepaddle.cdn.bcebos.com/demo/wmt_shrinked_data/"
            "wmt16.tar.gz")
DATA_MD5 = "0c38be43600334966403524a40dcd81e"

TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220

START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"

# special ids: <s>=0, <e>=1, <unk>=2 (dict files list them first)
START_ID, END_ID, UNK_ID = 0, 1, 2
_RESERVED = 3

_N = {"train": 2048, "test": 256, "validation": 256}  # synthetic sizes


def _build_dict(tar_file, dict_size, save_path, lang):
    import tarfile

    word_freq = defaultdict(int)
    with tarfile.open(tar_file, mode="r") as f:
        for line in f.extractfile("wmt16/train"):
            parts = line.decode("utf-8", errors="replace").strip() \
                .split("\t")
            if len(parts) != 2:
                continue
            sen = parts[0] if lang == "en" else parts[1]
            for w in sen.split():
                word_freq[w] += 1
    with open(save_path, "w") as fout:
        fout.write(f"{START_MARK}\n{END_MARK}\n{UNK_MARK}\n")
        for idx, (word, _) in enumerate(
                sorted(word_freq.items(), key=lambda x: x[1],
                       reverse=True)):
            if idx + _RESERVED == dict_size:
                break
            fout.write(word + "\n")


def _load_dict(tar_file, dict_size, lang, reverse=False):
    dict_dir = os.path.join(common.data_home(), "wmt16")
    os.makedirs(dict_dir, exist_ok=True)
    dict_path = os.path.join(dict_dir, f"{lang}_{dict_size}.dict")
    # the file name encodes (lang, dict_size), so an existing file is
    # authoritative — it may legitimately hold FEWER lines than dict_size
    # when the corpus vocab (+3 specials) is smaller; rebuilding on a
    # count mismatch would rescan the train split every call
    if not os.path.exists(dict_path):
        _build_dict(tar_file, dict_size, dict_path, lang)
    word_dict = {}
    with open(dict_path) as fdict:
        for idx, line in enumerate(fdict):
            if reverse:
                word_dict[idx] = line.strip()
            else:
                word_dict[line.strip()] = idx
    return word_dict


def _clip_size(n, lang="en"):
    total = TOTAL_EN_WORDS if lang == "en" else TOTAL_DE_WORDS
    return min(max(int(n), _RESERVED + 2), total)


def reader_creator(tar_file, file_name, src_dict_size, trg_dict_size,
                   src_lang):
    """Yield (src_ids incl. <s>/<e>, trg_ids with leading <s>,
    trg_ids_next with trailing <e>) per tab-separated line."""

    # dicts load once per creator, not once per epoch
    src_dict = _load_dict(tar_file, src_dict_size, src_lang)
    trg_dict = _load_dict(tar_file, trg_dict_size,
                          "de" if src_lang == "en" else "en")
    src_col = 0 if src_lang == "en" else 1

    def reader():
        import tarfile

        with tarfile.open(tar_file, mode="r") as f:
            for line in f.extractfile(file_name):
                parts = line.decode("utf-8", errors="replace").strip() \
                    .split("\t")
                if len(parts) != 2:
                    continue
                src_ids = [START_ID] + [
                    src_dict.get(w, UNK_ID)
                    for w in parts[src_col].split()] + [END_ID]
                trg_raw = [trg_dict.get(w, UNK_ID)
                           for w in parts[1 - src_col].split()]
                yield (src_ids, [START_ID] + trg_raw, trg_raw + [END_ID])

    return reader


def fetch():
    return common.download(DATA_URL, "wmt16", DATA_MD5, "wmt16.tar.gz")


# -- synthetic fallback ------------------------------------------------------


def _translate(tokens, trg_dict_size):
    # deterministic affine token mapping into the target vocab
    return [(_RESERVED + (7 * t + 3) % (trg_dict_size - _RESERVED))
            for t in tokens]


def _synthetic_reader(tag, src_dict_size, trg_dict_size, src_lang):
    def reader():
        r = fixed_rng(f"wmt16/{tag}/{src_lang}")
        for _ in range(_N[tag]):
            n = int(r.randint(3, 12))
            src = r.randint(_RESERVED, src_dict_size, n).tolist()
            trg = _translate(src, trg_dict_size)
            yield ([START_ID] + src + [END_ID], [START_ID] + trg,
                   trg + [END_ID])

    return reader


def _make(tag, file_name, src_dict_size, trg_dict_size, src_lang):
    src_dict_size = _clip_size(src_dict_size, src_lang)
    trg_dict_size = _clip_size(trg_dict_size,
                               "de" if src_lang == "en" else "en")
    tar = common.fetch_real("wmt16", fetch)
    if tar is None:
        return _synthetic_reader(tag, src_dict_size, trg_dict_size,
                                 src_lang)
    return reader_creator(tar, f"wmt16/{file_name}", src_dict_size,
                          trg_dict_size, src_lang)


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _make("train", "train", src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _make("test", "test", src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _make("validation", "val", src_dict_size, trg_dict_size,
                 src_lang)


def get_dict(lang, dict_size, reverse=False):
    """id<->token table.  Real mode loads/builds the cached dict file;
    synthetic tokens are '<lang>_<id>'."""
    dict_size = _clip_size(dict_size, lang)
    tar = common.fetch_real("wmt16", fetch)
    if tar is not None:
        return _load_dict(tar, dict_size, lang, reverse)
    words = {START_ID: "<s>", END_ID: "<e>", UNK_ID: "<unk>"}
    for i in range(_RESERVED, dict_size):
        words[i] = f"{lang}_{i}"
    if reverse:
        return words
    return {w: i for i, w in words.items()}
