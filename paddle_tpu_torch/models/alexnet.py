"""AlexNet, the image benchmark's default model (counterpart of
paddle_tpu/models/alexnet.py): 227x227, grouped convs through `groups`,
LRN after conv1 and conv2, dropout before the last two fc layers."""
from __future__ import annotations

from .. import layers

__all__ = ["alexnet"]


def alexnet(input, class_dim=1000, groups=1, is_test=False):
    """[N, 3, 227, 227] NCHW input -> softmax over class_dim."""
    conv1 = layers.conv2d(input=input, num_filters=96, filter_size=11,
                          stride=4, padding=1, act="relu")
    norm1 = layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(input=norm1, pool_size=3, pool_stride=2,
                          pool_type="max")

    conv2 = layers.conv2d(input=pool1, num_filters=256, filter_size=5,
                          padding=2, groups=groups, act="relu")
    norm2 = layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(input=norm2, pool_size=3, pool_stride=2,
                          pool_type="max")

    conv3 = layers.conv2d(input=pool2, num_filters=384, filter_size=3,
                          padding=1, act="relu")
    conv4 = layers.conv2d(input=conv3, num_filters=384, filter_size=3,
                          padding=1, groups=groups, act="relu")
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3,
                          padding=1, groups=groups, act="relu")
    pool5 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2,
                          pool_type="max")

    fc6 = layers.fc(input=pool5, size=4096, act="relu")
    drop6 = layers.dropout(fc6, dropout_prob=0.5, is_test=is_test)
    fc7 = layers.fc(input=drop6, size=4096, act="relu")
    drop7 = layers.dropout(fc7, dropout_prob=0.5, is_test=is_test)
    return layers.fc(input=drop7, size=class_dim, act="softmax")
