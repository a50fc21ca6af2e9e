"""MobileNet-v1 (parity: the reference's mobilenet deployment example —
r/example/mobilenet.r and go/demo drive an exported mobilenet through
the inference API; the architecture follows the classic depthwise-
separable stack).  Counterpart of paddle_tpu/models/mobilenet.py: the
depthwise 3x3 stages dispatch to the ``depthwise_conv2d`` op
(layers.conv2d with groups == channels), a grouped ``F.conv2d``."""
from __future__ import annotations

from .. import layers

__all__ = ["mobilenet_v1"]


def _conv_bn(x, ch_out, filter_size, stride, padding, groups=1):
    conv = layers.conv2d(x, ch_out, filter_size, stride=stride,
                         padding=padding, groups=groups, bias_attr=False)
    return layers.batch_norm(conv, act="relu")


def _depthwise_separable(x, ch_out, stride, scale=1.0):
    ch_in = x.shape[1]
    dw = _conv_bn(x, int(ch_in), 3, stride, 1, groups=int(ch_in))
    return _conv_bn(dw, int(ch_out * scale), 1, 1, 0)


# (output channels, stride) per depthwise-separable block, v1 layout
_V1_BLOCKS = [
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
    (1024, 1),
]


def mobilenet_v1(img, label, class_num=1000, scale=1.0):
    """Standard MobileNet-v1: 3x3/s2 stem, 13 depthwise-separable
    blocks, global average pool, linear classifier.  ``scale`` is the
    width multiplier.  Returns (logits, loss, accuracy)."""
    x = _conv_bn(img, int(32 * scale), 3, 2, 1)
    for ch_out, stride in _V1_BLOCKS:
        x = _depthwise_separable(x, ch_out, stride, scale=scale)
    pool = layers.pool2d(x, pool_size=7, pool_type="avg",
                         global_pooling=True)
    logits = layers.fc(pool, class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc
