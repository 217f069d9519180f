"""Model builders on the layers DSL (counterpart of paddle_tpu/models/)."""
from . import ctr  # noqa: F401
from .alexnet import alexnet  # noqa: F401
from .googlenet import googlenet, inception, smallnet_mnist_cifar  # noqa: F401
from .transformer import (  # noqa: F401
    build_lm_paged_decoder,
    transformer_decoder,
    transformer_encoder,
    transformer_lm,
    transformer_translate,
)
from .moe import active_param_count, build_moe_lm  # noqa: F401
from .resnet import resnet_cifar10, resnet_imagenet  # noqa: F401
from .vgg import vgg, vgg16_bn_drop  # noqa: F401
