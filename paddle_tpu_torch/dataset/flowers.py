"""flowers: 102-category Oxford flowers — (flattened CHW float image,
int label in [1, 102]).

Reference: Paddle's python/paddle/v2/dataset/flowers.py —
102flowers.tgz (jpg/image_XXXXX.jpg) + imagelabels.mat (1-based labels)
+ setid.mat split indices; the reference swaps trnid/tstid (tstid is the
larger set, used for training).  Default mapper: resize-short 256,
224-crop (random for train), CHW float32 minus the BGR mean, flattened.
Real corpus under PADDLE_TPU_DATASET=auto|real; synthetic
class-template fallback offline.
"""
from __future__ import annotations

import functools
import tarfile

import numpy as np

from . import common
from .common import cached, fixed_rng

__all__ = ["train", "test", "valid", "reader_creator"]

DATA_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
            "102flowers.tgz")
LABEL_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
             "imagelabels.mat")
SETID_URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
             "setid.mat")
DATA_MD5 = "33bfc11892f1e405ca193ae9a9f2a118"
LABEL_MD5 = "e0620be6f572b9609742df49c70aed4d"
SETID_MD5 = "a5357ecc9cb78c4bef273ce3793fc85c"
# official readme calls tstid test, but tstid is the larger split — the
# reference swaps them so training has more images
TRAIN_FLAG = "tstid"
TEST_FLAG = "trnid"
VALID_FLAG = "valid"

_CLASSES = 102
_N = {"train": 512, "test": 128, "valid": 128}  # synthetic sizes


def default_mapper(is_train, sample):
    from .. import image

    img_bytes, label = sample
    img = image.load_image_bytes(img_bytes)
    img = image.simple_transform(img, 256, 224, is_train,
                                 mean=[103.94, 116.78, 123.68])
    return img.flatten().astype("float32"), label


train_mapper = functools.partial(default_mapper, True)
test_mapper = functools.partial(default_mapper, False)


def reader_creator(data_file, label_file, setid_file, dataset_name,
                   mapper):
    """Real parser: yields mapper((jpg bytes, 1-based label)) for every
    image index in setid.mat[dataset_name]."""
    import scipy.io as scio

    labels = scio.loadmat(label_file)["labels"][0]
    indexes = scio.loadmat(setid_file)[dataset_name][0]

    def reader():
        with tarfile.open(data_file) as tf:
            members = {m.name: m for m in tf.getmembers()}
            for idx in indexes:
                name = f"jpg/image_{int(idx):05d}.jpg"
                data = tf.extractfile(members[name]).read()
                sample = (data, int(labels[int(idx) - 1]))
                yield mapper(sample) if mapper is not None else sample

    return reader


def _fetch():
    return (common.download(DATA_URL, "flowers", DATA_MD5),
            common.download(LABEL_URL, "flowers", LABEL_MD5),
            common.download(SETID_URL, "flowers", SETID_MD5))


# -- synthetic fallback ------------------------------------------------------


@cached
def _templates():
    r = fixed_rng("flowers")
    # low-res class templates upsampled: keeps memory small but images
    # class-separable like the real data
    return r.randn(_CLASSES, 3, 8, 8).astype(np.float32)


def _synthetic_reader(tag, mapper):
    # synthetic samples are already decoded flat float images, so the
    # jpeg-decoding DEFAULT mappers don't apply — but a user-supplied
    # mapper still does (same contract as the real path)
    apply = mapper if mapper not in (None, train_mapper, test_mapper) \
        else None

    def reader():
        t = _templates()
        r = fixed_rng(f"flowers/{tag}")
        for _ in range(_N[tag]):
            label = int(r.randint(0, _CLASSES))
            img = np.kron(t[label], np.ones((28, 28), np.float32))
            img = img + 0.3 * r.randn(3, 224, 224).astype(np.float32)
            sample = (np.clip(img, -2.0, 2.0).astype(np.float32).ravel(),
                      label)
            yield apply(sample) if apply is not None else sample

    return reader


def _make(tag, flag, mapper):
    paths = common.fetch_real("flowers", _fetch)
    if paths is None:
        return _synthetic_reader(tag, mapper)
    return reader_creator(*paths, flag, mapper)


def train(mapper=train_mapper, buffered_size=1024, use_xmap=True):
    return _make("train", TRAIN_FLAG, mapper)


def test(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    return _make("test", TEST_FLAG, mapper)


def valid(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    return _make("valid", VALID_FLAG, mapper)
