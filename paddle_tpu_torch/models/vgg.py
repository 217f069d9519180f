"""VGG model family on the layers DSL (counterpart of
paddle_tpu/models/vgg.py): the book's CIFAR-10 VGG-16 with batch norm
and dropout, and plain VGG-11/13/16/19."""
from __future__ import annotations

from .. import layers, nets

__all__ = ["vgg16_bn_drop", "vgg"]


def _conv_block(input, num_filter, groups, dropouts):
    return nets.img_conv_group(
        input=input,
        pool_size=2,
        pool_stride=2,
        conv_num_filter=[num_filter] * groups,
        conv_filter_size=3,
        conv_act="relu",
        conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=dropouts,
        pool_type="max")


def vgg16_bn_drop(input, class_dim=10, is_test=False):
    """VGG-16 with batch norm + dropout (the book CIFAR model)."""
    conv1 = _conv_block(input, 64, 2, [0.3, 0.0])
    conv2 = _conv_block(conv1, 128, 2, [0.4, 0.0])
    conv3 = _conv_block(conv2, 256, 3, [0.4, 0.4, 0.0])
    conv4 = _conv_block(conv3, 512, 3, [0.4, 0.4, 0.0])
    conv5 = _conv_block(conv4, 512, 3, [0.4, 0.4, 0.0])
    drop = layers.dropout(x=conv5, dropout_prob=0.5, is_test=is_test)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_dim, act="softmax")


def vgg(input, class_dim=1000, depth=16):
    """Plain VGG (no batch norm), dropout between its fc layers."""
    cfg = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
           16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}[depth]
    chans = [64, 128, 256, 512, 512]
    tmp = input
    for c, g in zip(chans, cfg):
        for _ in range(g):
            tmp = layers.conv2d(input=tmp, num_filters=c, filter_size=3,
                                padding=1, act="relu")
        tmp = layers.pool2d(input=tmp, pool_size=2, pool_stride=2,
                            pool_type="max")
    fc1 = layers.fc(input=tmp, size=4096, act="relu")
    drop1 = layers.dropout(x=fc1, dropout_prob=0.5)
    fc2 = layers.fc(input=drop1, size=4096, act="relu")
    drop2 = layers.dropout(x=fc2, dropout_prob=0.5)
    return layers.fc(input=drop2, size=class_dim, act="softmax")
