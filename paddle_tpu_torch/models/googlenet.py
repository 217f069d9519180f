"""GoogLeNet (Inception-v1) and SmallNet, image benchmark models
(counterpart of paddle_tpu/models/googlenet.py): 224x224, inception
towers joined channel-wise, no auxiliary heads; SmallNet for 32x32."""
from __future__ import annotations

from .. import layers

__all__ = ["inception", "googlenet", "smallnet_mnist_cifar"]


def _conv(input, num_filters, filter_size, stride=1, padding=0):
    return layers.conv2d(input=input, num_filters=num_filters,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act="relu")


def inception(input, f1, f3r, f3, f5r, f5, proj):
    """One inception tower: 1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | 3x3 max pool
    -> 1x1, joined on the channel axis in that order."""
    c1 = _conv(input, f1, 1)
    c3 = _conv(_conv(input, f3r, 1), f3, 3, padding=1)
    c5 = _conv(_conv(input, f5r, 1), f5, 5, padding=2)
    pj = _conv(layers.pool2d(input=input, pool_size=3, pool_stride=1,
                             pool_padding=1, pool_type="max"), proj, 1)
    return layers.concat([c1, c3, c5, pj], axis=1)


def googlenet(input, class_dim=1000, is_test=False):
    """[N, 3, 224, 224] NCHW input -> softmax over class_dim."""
    conv1 = _conv(input, 64, 7, stride=2, padding=3)
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_type="max")
    conv2 = _conv(_conv(pool1, 64, 1), 192, 3, padding=1)
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2,
                          pool_type="max")

    i3a = inception(pool2, 64, 96, 128, 16, 32, 32)
    i3b = inception(i3a, 128, 128, 192, 32, 96, 64)
    pool3 = layers.pool2d(input=i3b, pool_size=3, pool_stride=2,
                          pool_type="max")

    i4a = inception(pool3, 192, 96, 208, 16, 48, 64)
    i4b = inception(i4a, 160, 112, 224, 24, 64, 64)
    i4c = inception(i4b, 128, 128, 256, 24, 64, 64)
    i4d = inception(i4c, 112, 144, 288, 32, 64, 64)
    i4e = inception(i4d, 256, 160, 320, 32, 128, 128)
    pool4 = layers.pool2d(input=i4e, pool_size=3, pool_stride=2,
                          pool_type="max")

    i5a = inception(pool4, 256, 160, 320, 32, 128, 128)
    i5b = inception(i5a, 384, 192, 384, 48, 128, 128)
    pool5 = layers.pool2d(input=i5b, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool5, dropout_prob=0.4, is_test=is_test)
    return layers.fc(input=drop, size=class_dim, act="softmax")


def smallnet_mnist_cifar(input, class_dim=10):
    """SmallNet: 3 conv/pool stages + 2 fc for 32x32 inputs."""
    c1 = layers.conv2d(input=input, num_filters=32, filter_size=5,
                       padding=2, act="relu")
    p1 = layers.pool2d(input=c1, pool_size=3, pool_stride=2,
                       pool_padding=1, pool_type="max")
    c2 = layers.conv2d(input=p1, num_filters=32, filter_size=5,
                       padding=2, act="relu")
    p2 = layers.pool2d(input=c2, pool_size=3, pool_stride=2,
                       pool_padding=1, pool_type="avg")
    c3 = layers.conv2d(input=p2, num_filters=64, filter_size=3,
                       padding=1, act="relu")
    p3 = layers.pool2d(input=c3, pool_size=3, pool_stride=2,
                       pool_padding=1, pool_type="avg")
    f1 = layers.fc(input=p3, size=64, act="relu")
    return layers.fc(input=f1, size=class_dim, act="softmax")
