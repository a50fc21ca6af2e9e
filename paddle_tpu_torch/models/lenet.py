"""LeNet-5 (parity: the reference book test's CNN,
tests/book/test_recognize_digits.py conv_net)."""
from __future__ import annotations

from .. import layers


def lenet(img, label, class_num=10):
    conv1 = layers.conv2d(img, num_filters=6, filter_size=5, padding=2,
                          act="relu")
    pool1 = layers.pool2d(conv1, 2, "max", 2)
    conv2 = layers.conv2d(pool1, num_filters=16, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, 2, "max", 2)
    fc1 = layers.fc(pool2, 120, act="relu")
    fc2 = layers.fc(fc1, 84, act="relu")
    logits = layers.fc(fc2, class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return logits, loss, acc
