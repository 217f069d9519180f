"""The port's image preprocessing and Ploter against the JAX package's:
the same arrays in, the same arrays out, bit for bit
(tests/test_image_plot.py's 5 cases).  The random crop and flip draw
from numpy's global generator, so each package's call is made from the
same seed.
"""
import os

import numpy as np
import pytest

from paddle_tpu import image as jimage
from paddle_tpu import plot as jplot
from paddle_tpu_torch import image, plot


def _fake_im(h=64, w=48):
    rng = np.random.RandomState(0)
    return rng.randint(0, 255, (h, w, 3), np.uint8)


def _both(fn, seed=None):
    """fn(module) for the JAX package's module and the port's, each from
    numpy's global seed `seed` -> the port's result, held equal."""
    out = []
    for mod in (jimage, image):
        if seed is not None:
            np.random.seed(seed)
        out.append(fn(mod))
    want, got = out
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def test_resize_short_keeps_aspect():
    im = _both(lambda m: m.resize_short(_fake_im(64, 48), 32))
    assert im.shape[:2] == (42, 32)
    im = _both(lambda m: m.resize_short(_fake_im(48, 64), 32))
    assert im.shape[:2] == (32, 42)


def test_crops_and_flip():
    im = _fake_im(64, 64)
    c = _both(lambda m: m.center_crop(im, 32))
    np.testing.assert_array_equal(c, im[16:48, 16:48])
    r = _both(lambda m: m.random_crop(im, 32), seed=7)
    assert r.shape == (32, 32, 3)
    f = _both(lambda m: m.left_right_flip(im))
    np.testing.assert_array_equal(f, im[:, ::-1])
    _both(lambda m: m.to_chw(im))


@pytest.mark.parametrize("is_train", [False, True])
def test_simple_transform_chw_and_mean(is_train):
    im = _fake_im(64, 64)
    out = _both(lambda m: m.simple_transform(im, 48, 32, is_train=is_train,
                                             mean=[1.0, 2.0, 3.0]), seed=3)
    assert out.shape == (3, 32, 32) and out.dtype == np.float32


def test_load_roundtrip(tmp_path):
    import pickle
    import tarfile

    from PIL import Image

    p = str(tmp_path / "x.png")
    Image.fromarray(_fake_im(16, 16)).save(p)
    im = _both(lambda m: m.load_image(p))
    assert im.shape == (16, 16, 3)
    gray = _both(lambda m: m.load_image(p, is_color=False))
    assert gray.shape == (16, 16)
    out = _both(lambda m: m.load_and_transform(p, 16, 8, is_train=True),
                seed=5)
    assert out.shape == (3, 8, 8)
    # batch_images_from_tar: the same pickled batches from one tar
    tar = str(tmp_path / "imgs.tar")
    with tarfile.open(tar, "w") as tf:
        for i in range(3):
            tf.add(p, arcname=f"img{i}.png")
    labels = {f"img{i}.png": i for i in range(3)}
    metas = []
    for tag, mod in (("jax", jimage), ("port", image)):
        sub = tmp_path / tag
        sub.mkdir()
        copy = str(sub / "imgs.tar")
        with open(tar, "rb") as src, open(copy, "wb") as dst:
            dst.write(src.read())
        meta = mod.batch_images_from_tar(copy, "toy", labels,
                                         num_per_batch=2)
        names = open(meta).read().split("\n")
        metas.append([pickle.load(open(os.path.join(
            os.path.dirname(meta), n), "rb")) for n in names])
    want, got = metas
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["label"] == w["label"]
        for a, b in zip(g["data"], w["data"]):
            np.testing.assert_array_equal(a, b)


def test_ploter_collect_and_save(tmp_path, monkeypatch):
    monkeypatch.delenv("DISABLE_PLOT", raising=False)
    for mod in (jplot, plot):
        p = mod.Ploter("train", "test")
        p.append("train", 0, 1.0)
        p.append("train", 1, 0.5)
        p.append("test", 0, 1.2)
        assert p.__plot_data__["train"].step == [0, 1]
        assert p.__plot_data__["train"].value == [1.0, 0.5]
        if p.plt is not None:
            out = str(tmp_path / f"curve_{mod.__name__}.png")
            p.plot(out)
            assert os.path.exists(out)
        p.reset()
        assert p.__plot_data__["train"].step == []
    assert (plot.Ploter("a").plt is None) == (jplot.Ploter("a").plt is None)

    monkeypatch.setenv("DISABLE_PLOT", "True")
    p2 = plot.Ploter("a")
    assert p2.plt is None
    p2.append("a", 0, 1.0)
    p2.plot()  # no-op, must not raise
