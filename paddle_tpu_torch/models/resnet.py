"""ResNet family (parity: the reference's image-classification models —
tests/book/test_image_classification.py resnet_cifar10 and the
benchmark/fleet SE-ResNeXt / ResNet-50 configs).

Counterpart of paddle_tpu/models/resnet.py, built from the layers API
under the same names: each conv and batch norm is one op the lowering
runs as plain PyTorch (``F.conv2d``, cuDNN on the card).  The JAX
package's batch-norm statistics reduce over the GLOBAL batch under a
data mesh (sync-BN); the port's mesh planner refuses ``batch_norm``
until sync-BN is ported (ROADMAP.md Queue 1 item 5)."""
from __future__ import annotations

from .. import layers

__all__ = ["resnet_cifar10", "resnet", "ResNetConfig"]


def _conv_bn(x, ch_out, filter_size, stride, padding, act="relu"):
    conv = layers.conv2d(x, ch_out, filter_size, stride=stride,
                         padding=padding, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _shortcut(x, ch_out, stride):
    ch_in = x.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, 0, act=None)
    return x


def _basic_block(x, ch_out, stride):
    conv1 = _conv_bn(x, ch_out, 3, stride, 1)
    conv2 = _conv_bn(conv1, ch_out, 3, 1, 1, act=None)
    short = _shortcut(x, ch_out, stride)
    return layers.relu(layers.elementwise_add(conv2, short))


def _bottleneck(x, ch_out, stride):
    conv1 = _conv_bn(x, ch_out, 1, 1, 0)
    conv2 = _conv_bn(conv1, ch_out, 3, stride, 1)
    conv3 = _conv_bn(conv2, ch_out * 4, 1, 1, 0, act=None)
    short = _shortcut(x, ch_out * 4, stride)
    return layers.relu(layers.elementwise_add(conv3, short))


def resnet_cifar10(img, label, depth=20, class_num=10):
    """3-stage basic-block ResNet (depth = 6n+2: 20/32/44/56/110) —
    parity: book/test_image_classification.py resnet_cifar10."""
    assert (depth - 2) % 6 == 0, "cifar resnet depth must be 6n+2"
    n = (depth - 2) // 6
    x = _conv_bn(img, 16, 3, 1, 1)
    for i in range(n):
        x = _basic_block(x, 16, 1)
    for i in range(n):
        x = _basic_block(x, 32, 2 if i == 0 else 1)
    for i in range(n):
        x = _basic_block(x, 64, 2 if i == 0 else 1)
    pool = layers.pool2d(x, pool_size=8, pool_type="avg",
                         pool_stride=1, global_pooling=True)
    logits = layers.fc(pool, class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc


class ResNetConfig:
    """ImageNet-style depths (50/101/152 use bottleneck blocks)."""

    DEPTHS = {
        18: ([2, 2, 2, 2], _basic_block),
        34: ([3, 4, 6, 3], _basic_block),
        50: ([3, 4, 6, 3], _bottleneck),
        101: ([3, 4, 23, 3], _bottleneck),
        152: ([3, 8, 36, 3], _bottleneck),
    }


def resnet(img, label, depth=50, class_num=1000):
    """ImageNet ResNet (parity: the fleet/benchmark ResNet-50 config)."""
    stages, block = ResNetConfig.DEPTHS[depth]
    x = _conv_bn(img, 64, 7, 2, 3)
    x = layers.pool2d(x, 3, "max", 2, pool_padding=1)
    for si, (reps, ch) in enumerate(zip(stages, [64, 128, 256, 512])):
        for i in range(reps):
            x = block(x, ch, 2 if i == 0 and si > 0 else 1)
    pool = layers.pool2d(x, pool_size=7, pool_type="avg",
                         pool_stride=1, global_pooling=True)
    logits = layers.fc(pool, class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc
