"""VGG with batch-norm + dropout (parity: the reference book's second
image-classification net — tests/book/test_image_classification.py
vgg16_bn_drop, built on nets.img_conv_group / fluid nets.py:138)."""
from __future__ import annotations

from .. import layers, nets

__all__ = ["vgg_bn_drop"]


def _conv_block(x, num_filter, groups, dropouts):
    return nets.img_conv_group(
        x,
        conv_num_filter=[num_filter] * groups,
        pool_size=2,
        pool_stride=2,
        conv_filter_size=3,
        conv_act="relu",
        conv_with_batchnorm=True,
        conv_batchnorm_drop_rate=dropouts,
        pool_type="max",
    )


def vgg_bn_drop(img, label, class_num=10, depth_cfg=None):
    """VGG-16-style tower.  ``depth_cfg`` is a list of
    (num_filter, conv_count, drop_rates) triples; the default is the
    book test's 5-block VGG-16 for 32x32 inputs.  Returns
    (logits, loss, accuracy) like the other zoo builders."""
    if depth_cfg is None:
        depth_cfg = [
            (64, 2, [0.3, 0.0]),
            (128, 2, [0.4, 0.0]),
            (256, 3, [0.4, 0.4, 0.0]),
            (512, 3, [0.4, 0.4, 0.0]),
            (512, 3, [0.4, 0.4, 0.0]),
        ]
    x = img
    for num_filter, groups, drops in depth_cfg:
        x = _conv_block(x, num_filter, groups, drops)

    x = layers.dropout(x, dropout_prob=0.5)
    fc1 = layers.fc(x, 512)
    bn = layers.batch_norm(fc1, act="relu")
    drop2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop2, 512)
    logits = layers.fc(fc2, class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc
