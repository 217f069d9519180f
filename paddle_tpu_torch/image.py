"""Image preprocessing utilities (reference python/paddle/v2/image.py;
the port's copy of paddle_tpu/image.py).

The reference implements these over cv2; here they are PIL + numpy (cv2
is not a dependency of this package).  Channel conventions match the
reference: HWC uint8 RGB in, `to_chw` for the CHW training layout.
"""
from __future__ import annotations

import io
import os
import tarfile

import numpy as np

__all__ = [
    "batch_images_from_tar",
    "load_image_bytes",
    "load_image",
    "resize_short",
    "to_chw",
    "center_crop",
    "random_crop",
    "left_right_flip",
    "simple_transform",
    "load_and_transform",
]


def _pil():
    from PIL import Image
    return Image


def load_image_bytes(bytes_, is_color=True):
    """Decode raw encoded image bytes -> HWC (or HW for gray) uint8 array
    (reference image.py:111)."""
    im = _pil().open(io.BytesIO(bytes_))
    im = im.convert("RGB" if is_color else "L")
    return np.asarray(im)


def load_image(file, is_color=True):
    """Load an image file (reference image.py:135)."""
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color=is_color)


def _resize(im: np.ndarray, w: int, h: int) -> np.ndarray:
    pil_im = _pil().fromarray(im)
    return np.asarray(pil_im.resize((w, h), _pil().BILINEAR))


def resize_short(im, size):
    """Resize so the SHORTER edge equals `size`, keeping aspect ratio
    (reference image.py:163)."""
    h, w = im.shape[:2]
    if h > w:
        h_new, w_new = size * h // w, size
    else:
        h_new, w_new = size, size * w // h
    return _resize(im, w_new, h_new)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference image.py:189)."""
    assert len(im.shape) == len(order)
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    """Crop the center size×size patch (reference image.py:213)."""
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start:h_start + size, w_start:w_start + size]


def random_crop(im, size, is_color=True):
    """Crop a random size×size patch (reference image.py:241)."""
    h, w = im.shape[:2]
    h_start = np.random.randint(0, h - size + 1)
    w_start = np.random.randint(0, w - size + 1)
    return im[h_start:h_start + size, w_start:w_start + size]


def left_right_flip(im, is_color=True):
    """Mirror horizontally (reference image.py:269)."""
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """resize_short -> (random crop + random flip | center crop) ->
    CHW float32 -> optional mean subtraction (reference image.py:291)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if len(im.shape) == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.array(mean, dtype=np.float32)
        if mean.ndim == 1 and len(im.shape) == 3:
            mean = mean[:, np.newaxis, np.newaxis]
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    """load_image + simple_transform (reference image.py:348)."""
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pack images from a tar file into pickled numpy batches
    (reference image.py:48): each batch file holds {'data': [flattened
    uint8 arrays], 'label': [...]}.  Returns the batch-list meta file."""
    import pickle

    out_path = f"{data_file}_{dataset_name}_batch"
    meta_file = os.path.join(out_path, "batch_list")
    if os.path.exists(meta_file):
        return meta_file
    os.makedirs(out_path, exist_ok=True)

    tf = tarfile.open(data_file)
    data, labels, file_id, names = [], [], 0, []
    for mem in tf.getmembers():
        if mem.name not in img2label:
            continue
        data.append(load_image_bytes(tf.extractfile(mem).read()).flatten())
        labels.append(img2label[mem.name])
        if len(data) == num_per_batch:
            output = {"label": labels, "data": data}
            name = f"batch_{file_id}"
            with open(os.path.join(out_path, name), "wb") as f:
                pickle.dump(output, f, protocol=2)
            names.append(name)
            file_id += 1
            data, labels = [], []
    if data:
        name = f"batch_{file_id}"
        with open(os.path.join(out_path, name), "wb") as f:
            pickle.dump({"label": labels, "data": data}, f, protocol=2)
        names.append(name)
    with open(meta_file, "w") as f:
        f.write("\n".join(names))
    return meta_file
