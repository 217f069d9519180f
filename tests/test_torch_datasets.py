"""The port's dataset package against the JAX package's.

Each case builds its fixture files once, in the corpus's real on-disk
format (tests/test_dataset_parsers.py's builders: IDX gzips, cifar
pickle tarballs, aclImdb trees, PTB tgz, wmt tars, the ml-1m zip,
conll05 gzips in a tar, LETOR text, flowers jpgs with .mat files, a VOC
tar), reads them through the same entry points of `paddle_tpu.dataset`
and `paddle_tpu_torch.dataset`, and requires equal samples.  The
download layer goes through file:// URLs, the synthetic fallbacks run
under PADDLE_TPU_DATASET=synthetic, and each package gets a DATA_HOME
of its own: nothing touches the network.  One case a module, covering
test_dataset_parsers.py's 17 cases and test_datasets.py's 6.
"""
from __future__ import annotations

import importlib
import os
import re

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as tds
from test_dataset_parsers import (_write_cifar_tar, _write_conll05_tar,
                                  _write_idx, _write_imdb_tar,
                                  _write_ml1m_zip, _write_ptb_tar,
                                  _write_wmt14_tar, _write_wmt16_tar)


def _take(reader, n=3):
    out = []
    for i, rec in enumerate(reader()):
        if i >= n:
            break
        out.append(rec)
    return out


def _same(a, b, path="sample"):
    """Deep equality: numpy arrays by dtype, shape and value; tuples,
    lists and dicts element by element; everything else by ==."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, (path, a, b)


def _error(fn):
    """The exception type and message `fn()` raises."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001  (compared across packages)
        return type(e).__name__, str(e).replace("paddle_tpu_torch",
                                                "paddle_tpu")
    raise AssertionError("no exception")


# -- one case a module: (fixture builder, reader over a dataset package) ---


def _common(tmp, ds, home):
    src = tmp / "corpus.bin"
    if not src.exists():
        src.write_bytes(b"hello dataset")
    md5 = ds.common.md5file(str(src))
    url = "file://" + str(src)
    path = ds.common.download(url, "toy", md5)
    out = [open(path, "rb").read(), os.path.relpath(path, home),
           ds.common.download(url, "toy", md5) == path]
    with open(path, "wb") as f:
        f.write(b"corrupt")
    saved = src.read_bytes()
    src.unlink()     # corrupt cache, source gone: the retries fail
    resilience = importlib.import_module(
        ds.__name__.split(".")[0] + ".core.resilience")
    fast = resilience.RetryPolicy(max_attempts=2, base_delay=0.0,
                                  max_delay=0.0)
    with pytest.raises(Exception):
        ds.common.download(url, "toy", md5, retry_policy=fast)
    src.write_bytes(saved)
    os.environ["PADDLE_TPU_DATASET"] = "synthetic"
    calls = []
    out.append(ds.common.fetch_real("toy", lambda: calls.append(1)))
    out.append(list(calls))
    os.environ["PADDLE_TPU_DATASET"] = "real"
    out.append(_error(lambda: ds.common.fetch_real("toy", lambda: (
        _ for _ in ()).throw(RuntimeError("offline")))))
    os.environ["PADDLE_TPU_DATASET"] = "bogus"
    out.append(_error(ds.common.data_mode))
    os.environ["PADDLE_TPU_DATASET"] = "synthetic"
    rng = ds.common.fixed_rng("toy")
    out.append(rng.rand(4))
    return out


def _mnist(tmp, ds, home):
    r = np.random.RandomState(0)
    img, lbl = _write_idx(tmp, r.randint(0, 256, (5, 784), np.uint8),
                          [3, 1, 4, 1, 5])
    got = list(ds.mnist.reader_creator(img, lbl, buffer_size=2)())
    bad = tmp / "bad"
    bad.mkdir(exist_ok=True)
    bimg, blbl = _write_idx(bad, np.zeros((1, 784), np.uint8), [0])
    import gzip
    import struct

    with gzip.open(bimg, "wb") as f:
        f.write(struct.pack(">IIII", 1234, 1, 28, 28))
        f.write(bytes(784))
    err = _error(lambda: next(ds.mnist.reader_creator(bimg, blbl)()))
    return [got, err, _take(ds.mnist.train()), _take(ds.mnist.test())]


def _cifar(tmp, ds, home):
    out = []
    for key in (b"labels", b"fine_labels"):
        sub = tmp / key.decode()
        sub.mkdir(exist_ok=True)
        path, _ = _write_cifar_tar(sub, key)
        out.append(list(ds.cifar.reader_creator(path, "data_batch")()))
        out.append(list(ds.cifar.reader_creator(path, "test_batch")()))
    out += [_take(ds.cifar.train10()), _take(ds.cifar.test100())]
    return out


def _imdb(tmp, ds, home):
    path = _write_imdb_tar(tmp)
    docs = list(ds.imdb.tokenize(re.compile(r"aclImdb/train/pos/.*\.txt$"),
                                 tar_path=path))
    d = ds.imdb.build_dict(re.compile(r"aclImdb/train/.*\.txt$"), cutoff=1,
                           tar_path=path)
    idx = {"great": 0, "terrible": 1, "<unk>": 2}
    recs = list(ds.imdb.reader_creator(
        re.compile(r"aclImdb/train/pos/.*\.txt$"),
        re.compile(r"aclImdb/train/neg/.*\.txt$"), idx, tar_path=path)())
    wd = ds.imdb.word_dict()
    return [docs, d, recs, len(wd), _take(ds.imdb.train(wd))]


def _imikolov(tmp, ds, home):
    path = _write_ptb_tar(tmp)
    d = ds.imikolov.build_dict_from_tar(path, min_word_freq=1)
    grams = list(ds.imikolov.reader_creator(
        path, ds.imikolov.TRAIN_FILE, d, 3, ds.imikolov.DataType.NGRAM)())
    seqs = list(ds.imikolov.reader_creator(
        path, ds.imikolov.TRAIN_FILE, d, 0, ds.imikolov.DataType.SEQ)())
    wd = ds.imikolov.build_dict()
    return [d, grams, seqs, len(wd), _take(ds.imikolov.train(wd, 5))]


def _wmt16(tmp, ds, home):
    tar = _write_wmt16_tar(tmp)
    recs = list(ds.wmt16.reader_creator(tar, "wmt16/train", 8, 8, "en")())
    en = ds.wmt16._load_dict(tar, 8, "en")
    cached = os.path.exists(os.path.join(home, "wmt16", "en_8.dict"))
    small = list(ds.wmt16.reader_creator(tar, "wmt16/val", 5, 5, "en")())
    # test_datasets.py: the synthetic corpus and the dict orientation
    syn = _take(ds.wmt16.train(50, 60), n=5)
    return [recs, en, cached, small, syn, ds.wmt16.get_dict("en", 50),
            ds.wmt16.get_dict("en", 50, reverse=True),
            _take(ds.wmt16.train(50, 60), n=2)]


def _uci_housing(tmp, ds, home):
    r = np.random.RandomState(3)
    raw = np.abs(r.rand(10, 14)).astype(np.float32) * 10
    path = tmp / "housing.data"
    with open(path, "w") as f:
        for row in raw:
            f.write(" ".join(f"{v:.4f}" for v in row) + "\n")
    bad = tmp / "bad.data"
    bad.write_text("1.0 2.0 3.0\n")
    return [ds.uci_housing.load_data(str(path)),
            _error(lambda: ds.uci_housing.load_data(str(bad))),
            _take(ds.uci_housing.train()), _take(ds.uci_housing.test())]


def _movies(meta):
    movies, users, titles, cats = meta
    return [{k: (v.index, v.categories, v.title) for k, v in movies.items()},
            {k: (v.index, v.is_male, v.age, v.job_id)
             for k, v in users.items()}, titles, cats]


def _movielens(tmp, ds, home):
    path = _write_ml1m_zip(tmp)
    meta = ds.movielens.parse_meta(path)
    train = list(ds.movielens._ratings_reader(path, *meta, is_test=False)())
    test = list(ds.movielens._ratings_reader(path, *meta, is_test=True)())
    return [_movies(meta), train, test, _take(ds.movielens.train()),
            ds.movielens.max_user_id(), ds.movielens.max_movie_id()]


def _wmt14(tmp, ds, home):
    path = _write_wmt14_tar(tmp)
    return [ds.wmt14.read_dicts(path, 6),
            list(ds.wmt14.reader_creator(path, "train/train", 6)()),
            ds.wmt14.read_dicts(path, 4), _take(ds.wmt14.train(30))]


def _conll05(tmp, ds, home):
    path = _write_conll05_tar(tmp)
    recs = list(ds.conll05.corpus_reader(path)())
    word_dict = {w: i for i, w in enumerate(
        ["The", "cat", "sat", "Dogs", "bark", "bos", "eos"])}
    label_dict = {t: i for i, t in enumerate(
        ["B-A0", "I-A0", "B-V", "B-A1", "O"])}
    rows = list(ds.conll05.reader_creator(
        ds.conll05.corpus_reader(path), word_dict, {"sat": 0, "bark": 1},
        label_dict)())
    return [recs, rows, _take(ds.conll05.train())]


def _mq2007(tmp, ds, home):
    path = tmp / "train.txt"
    path.write_text("2 qid:10 1:0.5 2:0.25 46:1.0 #docid = D1\n"
                    "0 qid:10 1:0.1 2:0.0 #docid = D2\n"
                    "1 qid:11 1:0.9 #docid = D3\n")
    formats = [_take(ds.mq2007.train(format=f))
               for f in ("pointwise", "pairwise", "listwise")]
    return [ds.mq2007.load_from_text(str(path), fill_missing=-1.0),
            formats, ds.mq2007.NDIM,
            _error(lambda: ds.mq2007.train(format="bogus"))]


def _flowers_fixture(tmp):
    import io
    import tarfile

    import scipy.io as scio
    from PIL import Image

    tgz = tmp / "102flowers.tgz"
    with tarfile.open(tgz, "w:gz") as tar:
        for i, color in ((1, (255, 0, 0)), (2, (0, 255, 0)),
                         (3, (0, 0, 255))):
            buf = io.BytesIO()
            Image.new("RGB", (300, 280), color).save(buf, format="JPEG")
            data = buf.getvalue()
            ti = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data))
    scio.savemat(tmp / "imagelabels.mat", {"labels": np.array([[5, 9, 13]])})
    scio.savemat(tmp / "setid.mat", {"tstid": np.array([[1, 3]]),
                                     "trnid": np.array([[2]]),
                                     "valid": np.array([[2]])})
    return str(tgz), str(tmp / "imagelabels.mat"), str(tmp / "setid.mat")


def _flowers(tmp, ds, home):
    tgz, labels, setid = _flowers_fixture(tmp)
    test = list(ds.flowers.reader_creator(tgz, labels, setid, "tstid",
                                          ds.flowers.test_mapper)())
    raw = list(ds.flowers.reader_creator(tgz, labels, setid, "trnid",
                                         None)())
    # test_datasets.py: the synthetic schema, a mapper, determinism
    mapped = _take(ds.flowers.train(mapper=lambda s: (s[0][:12], s[1])))
    return [test, raw, _take(ds.flowers.train()), _take(ds.flowers.test()),
            _take(ds.flowers.valid()), mapped]


def _voc2012(tmp, ds, home):
    import io
    import tarfile

    from PIL import Image

    path = tmp / "VOCtrainval.tar"
    with tarfile.open(path, "w") as tar:
        def add(name, data):
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data))

        add(ds.voc2012.SET_FILE.format("train"), b"img1\n")
        buf = io.BytesIO()
        Image.new("RGB", (8, 6), (10, 20, 30)).save(buf, format="JPEG")
        add(ds.voc2012.DATA_FILE.format("img1"), buf.getvalue())
        mask = Image.new("L", (8, 6))
        mask.putpixel((0, 0), 7)
        buf = io.BytesIO()
        mask.save(buf, format="PNG")
        add(ds.voc2012.LABEL_FILE.format("img1"), buf.getvalue())
    return [list(ds.voc2012.reader_creator(str(path), "train")()),
            _take(ds.voc2012.train()), _take(ds.voc2012.val())]


def _sentiment(tmp, ds, home):
    d = ds.sentiment.get_word_dict()
    return [sorted(d.items())[:50], len(d), _take(ds.sentiment.train()),
            _take(ds.sentiment.test())]


def _uci_digits(tmp, ds, home):
    return [_take(ds.uci_digits.train(), 5), _take(ds.uci_digits.test(), 5)]


def _diabetes(tmp, ds, home):
    return [_take(ds.diabetes.train(), 5), _take(ds.diabetes.test(), 5),
            ds.diabetes.feature_dim]


CASES = {"common": _common, "mnist": _mnist, "cifar": _cifar,
         "imdb": _imdb, "imikolov": _imikolov, "wmt16": _wmt16,
         "uci_housing": _uci_housing, "movielens": _movielens,
         "wmt14": _wmt14, "conll05": _conll05, "mq2007": _mq2007,
         "flowers": _flowers, "voc2012": _voc2012,
         "sentiment": _sentiment, "uci_digits": _uci_digits,
         "diabetes": _diabetes}


@pytest.mark.parametrize("module", sorted(CASES))
def test_dataset_module_matches_the_jax_package(module, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATASET", "synthetic")
    fixtures = tmp_path / "fixtures"
    fixtures.mkdir()
    got = {}
    for tag, ds in (("jax", jds), ("port", tds)):
        home = str(tmp_path / f"home_{tag}")
        monkeypatch.setenv("PADDLE_TPU_DATA_HOME", home)
        got[tag] = CASES[module](fixtures, ds, home)
    _same(got["jax"], got["port"], module)


def test_every_module_has_a_case():
    assert set(CASES) == {"common", *tds.__all__, "uci_digits",
                          "diabetes"}
    assert set(tds.__all__) == set(jds.__all__)


def test_determinism():
    """test_datasets.py::test_determinism, on the port's package."""
    a = _take(tds.wmt16.train(50, 60), n=2)
    b = _take(tds.wmt16.train(50, 60), n=2)
    assert a == b
    fa, la = _take(tds.flowers.train())[0]
    fb, lb = _take(tds.flowers.train())[0]
    assert la == lb and np.array_equal(fa, fb)
