"""Composite network helpers (parity: python/paddle/fluid/nets.py:28-548
— simple_img_conv_pool, img_conv_group, sequence_conv_pool, glu,
scaled_dot_product_attention; same signatures, layers-level bodies).

Counterpart of paddle_tpu/nets.py.  Sequence batches are padded plus a
lengths Variable (``seq_len``), as in the JAX package."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group",
           "sequence_conv_pool", "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """conv2d -> pool2d (nets.py:28)."""
    conv_out = layers.conv2d(
        input, num_filters, filter_size, stride=conv_stride,
        padding=conv_padding, dilation=conv_dilation, groups=conv_groups,
        param_attr=param_attr, bias_attr=bias_attr, act=act)
    return layers.pool2d(
        conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """(conv2d [-> batch_norm -> dropout])* -> pool2d — the VGG block
    builder (nets.py:138)."""
    assert isinstance(conv_num_filter, (list, tuple))

    def extend(obj):
        if not hasattr(obj, "__len__"):
            return [obj] * len(conv_num_filter)
        assert len(obj) == len(conv_num_filter)
        return list(obj)

    conv_padding = extend(conv_padding)
    conv_filter_size = extend(conv_filter_size)
    param_attr = extend(param_attr)
    conv_with_batchnorm = extend(conv_with_batchnorm)
    conv_batchnorm_drop_rate = extend(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None   # activation moves after the BN
        tmp = layers.conv2d(
            tmp, conv_num_filter[i], conv_filter_size[i],
            padding=conv_padding[i], param_attr=param_attr[i],
            act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(tmp, dropout_prob=drop_rate)
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None,
                       seq_len=None):
    """sequence_conv -> sequence_pool (nets.py:251).  ``seq_len`` is the
    lengths Variable this framework's dense-padded sequence policy uses
    in place of the reference's implicit LoD."""
    conv_out = layers.sequence_conv(
        input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, bias_attr=bias_attr, act=act,
        seq_len=seq_len)
    return layers.sequence_pool(conv_out, pool_type=pool_type,
                                seq_len=seq_len)


def glu(input, dim=-1):
    """Gated Linear Unit: split in two along `dim`, a * sigmoid(b)
    (nets.py:319)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled-dot-product attention over 3-D [B, T, H]
    inputs (nets.py:360): optional per-head linear projections when
    num_heads > 1, softmax(QK^T / sqrt(d)) V, heads re-combined."""
    if not (len(queries.shape) == len(keys.shape)
            == len(values.shape) == 3):
        raise ValueError(
            "Inputs queries, keys and values should all be 3-D tensors.")
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError(
            "The hidden size of queries and keys should be the same.")
    if keys.shape[-2] != values.shape[-2]:
        raise ValueError(
            "The max sequence length in query batch and in key batch "
            "should be the same.")
    if keys.shape[-1] % num_heads != 0:
        raise ValueError(
            f"The hidden size of keys ({keys.shape[-1]}) must be "
            f"divisible by the number of attention heads ({num_heads}).")
    if values.shape[-1] % num_heads != 0:
        raise ValueError(
            f"The hidden size of values ({values.shape[-1]}) must be "
            f"divisible by the number of attention heads ({num_heads}).")

    q, k, v = queries, keys, values
    if num_heads > 1:
        q = layers.fc(queries, queries.shape[-1], num_flatten_dims=2)
        k = layers.fc(keys, keys.shape[-1], num_flatten_dims=2)
        v = layers.fc(values, values.shape[-1], num_flatten_dims=2)

    def split_heads(x):
        if num_heads == 1:
            return x
        hidden = int(x.shape[-1])
        reshaped = layers.reshape(
            x, [0, 0, num_heads, hidden // num_heads])
        return layers.transpose(reshaped, [0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        trans = layers.transpose(x, [0, 2, 1, 3])
        return layers.reshape(
            trans, [0, 0, int(trans.shape[2]) * int(trans.shape[3])])

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    d_head = int(keys.shape[-1]) // num_heads
    scaled_q = layers.scale(qh, scale=d_head ** -0.5)
    product = layers.matmul(scaled_q, kh, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx = layers.matmul(weights, vh)
    return combine_heads(ctx)
