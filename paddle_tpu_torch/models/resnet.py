"""ResNet model family on the layers DSL (counterpart of
paddle_tpu/models/resnet.py): conv2d + batch_norm + elementwise_add
residual blocks, for 224x224 ImageNet (`resnet_imagenet`, depth
18/34/50/101/152, NCHW or NHWC) and the book's CIFAR-10 model
(`resnet_cifar10`, depth 6n + 2)."""
from __future__ import annotations

from .. import layers
from ..core.flags import get_flag

__all__ = ["resnet_imagenet", "resnet_cifar10"]


def _check_remat(remat):
    """remat=None reads the `remat` flag.  Rematerialized residual
    blocks need layers.recompute, which is not ported: asking raises."""
    if bool(get_flag("remat")) if remat is None else bool(remat):
        raise NotImplementedError(
            "remat needs layers.recompute, which is not ported yet "
            "(ROADMAP A4b); build with remat=False")


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  bias_attr=False, is_test=False, data_format="NCHW"):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=bias_attr,
                         data_format=data_format)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def _shortcut(input, ch_in, ch_out, stride, is_test=False,
              data_format="NCHW"):
    if stride != 1 or ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, data_format=data_format)
    return input


def _add_relu(a, b):
    return layers.relu(layers.elementwise_add(a, b))


def basicblock(input, ch_in, ch_out, stride, is_test=False,
               data_format="NCHW"):
    short = _shortcut(input, ch_in, ch_out, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format)
    return _add_relu(short, conv2)


def bottleneck(input, ch_in, ch_out, stride, is_test=False,
               data_format="NCHW"):
    short = _shortcut(input, ch_in, ch_out * 4, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, data_format=data_format)
    return _add_relu(short, conv3)


def _layer_warp(block_func, input, ch_in, ch_out, count, stride,
                is_test=False, data_format="NCHW"):
    res = block_func(input, ch_in, ch_out, stride, is_test, data_format)
    for _ in range(1, count):
        ch_in_cur = ch_out * (4 if block_func is bottleneck else 1)
        res = block_func(res, ch_in_cur, ch_out, 1, is_test, data_format)
    return res


_IMAGENET = {
    50: ([3, 4, 6, 3], bottleneck),
    101: ([3, 4, 23, 3], bottleneck),
    152: ([3, 8, 36, 3], bottleneck),
    18: ([2, 2, 2, 2], basicblock),
    34: ([3, 4, 6, 3], basicblock),
}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    data_format="NCHW", remat=None):
    """ResNet-18/34 (basic blocks) and 50/101/152 (bottlenecks) for
    224x224 input, softmax over `class_dim`; data_format "NHWC" keeps
    activations channels-last."""
    _check_remat(remat)
    stages, block = _IMAGENET[depth]
    conv1 = conv_bn_layer(input, 64, 7, 2, 3, is_test=is_test,
                          data_format=data_format)
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2,
                          pool_padding=1, pool_type="max",
                          data_format=data_format)
    expansion = 4 if block is bottleneck else 1
    res = pool1
    ch_in = 64
    for i, (count, ch_out) in enumerate(zip(stages, [64, 128, 256, 512])):
        stride = 1 if i == 0 else 2
        res = _layer_warp(block, res, ch_in, ch_out, count, stride, is_test,
                          data_format)
        ch_in = ch_out * expansion
    pool2 = layers.pool2d(input=res, pool_type="avg", global_pooling=True,
                          data_format=data_format)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False,
                   remat=None):
    """CIFAR ResNet (basic blocks), depth = 6n + 2 (the book model)."""
    if (depth - 2) % 6:
        raise ValueError(f"depth must be 6n + 2, got {depth}")
    _check_remat(remat)
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, 16, 3, 1, 1, is_test=is_test)
    res1 = _layer_warp(basicblock, conv1, 16, 16, n, 1, is_test)
    res2 = _layer_warp(basicblock, res1, 16, 32, n, 2, is_test)
    res3 = _layer_warp(basicblock, res2, 32, 64, n, 2, is_test)
    pool = layers.pool2d(input=res3, pool_type="avg", global_pooling=True)
    return layers.fc(input=pool, size=class_dim, act="softmax")
