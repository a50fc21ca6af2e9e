"""SE-ResNeXt (parity: the reference's distributed/ParallelExecutor
workhorse model — tests/unittests/dist_se_resnext.py:49 and
test_parallel_executor_seresnext.py): cardinality-grouped bottlenecks
with squeeze-excitation gating.  Counterpart of
paddle_tpu/models/se_resnext.py; the grouped 3x3 convs are ``conv2d``
ops with ``groups=cardinality`` (``F.conv2d``'s grouped convolution)."""
from __future__ import annotations

from .. import layers

__all__ = ["se_resnext"]

_DEPTHS = {
    50: ([3, 4, 6, 3], 32),
    101: ([3, 4, 23, 3], 32),
    152: ([3, 8, 36, 3], 64),
}


def _conv_bn(x, ch_out, filter_size, stride=1, groups=1, act=None):
    conv = layers.conv2d(x, ch_out, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _squeeze_excitation(x, num_channels, reduction_ratio):
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(pool, num_channels // reduction_ratio, act="relu")
    excitation = layers.fc(squeeze, num_channels, act="sigmoid")
    # gate each channel: [N,C,H,W] * [N,C] broadcast from the batch axis
    return layers.elementwise_mul(x, excitation, axis=0)


def _bottleneck(x, num_filters, stride, cardinality, reduction_ratio):
    conv0 = _conv_bn(x, num_filters, 1, act="relu")
    conv1 = _conv_bn(conv0, num_filters, 3, stride=stride,
                     groups=cardinality, act="relu")
    conv2 = _conv_bn(conv1, num_filters * 2, 1, act=None)
    scale = _squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    ch_in = x.shape[1]
    if ch_in != num_filters * 2 or stride != 1:
        short = _conv_bn(x, num_filters * 2, 1, stride=stride)
    else:
        short = x
    return layers.elementwise_add(short, scale, act="relu")


def se_resnext(img, label, depth=50, class_num=1000, reduction_ratio=16,
               num_filters=(128, 256, 512, 1024)):
    """SE-ResNeXt-{50,101,152}.  Returns (logits, loss, accuracy)."""
    blocks, cardinality = _DEPTHS[depth]
    if depth == 152:
        x = _conv_bn(img, 64, 3, stride=2, act="relu")
        x = _conv_bn(x, 64, 3, act="relu")
        x = _conv_bn(x, 128, 3, act="relu")
    else:
        x = _conv_bn(img, 64, 7, stride=2, act="relu")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    for stage, n_blocks in enumerate(blocks):
        for i in range(n_blocks):
            x = _bottleneck(x, num_filters[stage],
                            stride=2 if i == 0 and stage > 0 else 1,
                            cardinality=cardinality,
                            reduction_ratio=reduction_ratio)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    drop = layers.dropout(pool, dropout_prob=0.2)
    logits = layers.fc(drop, class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc
