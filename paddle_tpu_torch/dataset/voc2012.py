"""voc2012: segmentation — (HWC image array, HxW class-index mask).

Reference: Paddle's python/paddle/v2/dataset/voc2012.py — the
VOCtrainval tar's ImageSets/Segmentation/{train,trainval,val}.txt name
lists select JPEGImages/<name>.jpg + SegmentationClass/<name>.png pairs,
decoded to numpy (the palette PNG decodes to class indices).  Real
corpus under PADDLE_TPU_DATASET=auto|real; synthetic blocky-mask
fallback offline (same (image, mask) contract, float CHW image).
"""
from __future__ import annotations

import io
import tarfile

import numpy as np

from . import common
from .common import fixed_rng

__all__ = ["train", "test", "val", "reader_creator"]

VOC_URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
           "VOCtrainval_11-May-2012.tar")
VOC_MD5 = "6cd6e144f989b92b3379bac3b3de84fd"
SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"

_CLASSES = 21
_H = _W = 64
_N = {"train": 256, "test": 64, "val": 64}  # synthetic sizes

# reference split selection: train -> 'trainval', test -> 'train',
# val -> 'val' (voc2012.py train/test/val docstrings)
_SPLIT = {"train": "trainval", "test": "train", "val": "val"}


def reader_creator(filename, sub_name):
    """Real parser over the VOC tar: (np.array(jpg), np.array(png))
    per name in the split's ImageSets list."""
    from PIL import Image

    def reader():
        with tarfile.open(filename) as tf:
            members = {m.name: m for m in tf.getmembers()}
            sets = tf.extractfile(members[SET_FILE.format(sub_name)])
            for line in sets:
                name = line.decode().strip()
                if not name:
                    continue
                data = tf.extractfile(
                    members[DATA_FILE.format(name)]).read()
                label = tf.extractfile(
                    members[LABEL_FILE.format(name)]).read()
                yield (np.array(Image.open(io.BytesIO(data))),
                       np.array(Image.open(io.BytesIO(label))))

    return reader


def _fetch():
    return common.download(VOC_URL, "voc2012", VOC_MD5)


# -- synthetic fallback ------------------------------------------------------


def _sample(r):
    mask = np.zeros((_H, _W), np.int64)
    for _ in range(int(r.randint(1, 4))):
        c = int(r.randint(1, _CLASSES))
        y0, x0 = r.randint(0, _H // 2, 2)
        h, w = r.randint(_H // 8, _H // 2, 2)
        mask[y0:y0 + h, x0:x0 + w] = c
    img = (mask[None, :, :] / float(_CLASSES)
           + 0.1 * r.randn(3, _H, _W)).astype(np.float32)
    return img, mask


def _synthetic_reader(tag):
    def reader():
        r = fixed_rng(f"voc2012/{tag}")
        for _ in range(_N[tag]):
            yield _sample(r)

    return reader


def _make(tag):
    path = common.fetch_real("voc2012", _fetch)
    if path is None:
        return _synthetic_reader(tag)
    return reader_creator(path, _SPLIT[tag])


def train():
    return _make("train")


def test():
    return _make("test")


def val():
    return _make("val")
