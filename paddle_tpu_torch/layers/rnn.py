"""RNN layers of the port (parity: fluid/layers/rnn.py dynamic_lstm/
dynamic_gru and operators/cudnn_lstm_op.cu via layers.lstm).

Counterpart of paddle_tpu/layers/rnn.py, copied close to verbatim so
that both packages build the same ops and parameters under the same
names (``lstm`` names its per-layer projections and LSTMs
``<helper>.l<layer>.proj`` and ``<helper>.l<layer>`` through
unique_name, so weights carry across by name).  Sequences are padded
batch-major [B, T, ...] (+ optional ``sequence_length``) instead of LoD
ragged batches.
"""
from __future__ import annotations

from ..core import unique_name
from .helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru", "lstm"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 sequence_length=None):
    """LSTM over pre-projected gate inputs [B, T, 4H]; size = 4H.

    Returns (hidden, cell), each [B, T, H].
    """
    hidden, cell, _, _ = _lstm_full(
        input, size, h_0, c_0, param_attr, bias_attr, use_peepholes,
        is_reverse, gate_activation, cell_activation, candidate_activation,
        dtype, name, sequence_length)
    return hidden, cell


def _lstm_full(input, size, h_0=None, c_0=None, param_attr=None,
               bias_attr=None, use_peepholes=True, is_reverse=False,
               gate_activation="sigmoid", cell_activation="tanh",
               candidate_activation="tanh", dtype="float32", name=None,
               sequence_length=None):
    """dynamic_lstm plus the final states: returns
    (hidden [B,T,H], cell [B,T,H], last_h [B,H], last_c [B,H])."""
    helper = LayerHelper("lstm", name=name)
    H = size // 4
    weight = helper.create_parameter(
        param_attr, shape=[H, 4 * H], dtype=dtype)
    bias_size = [1, 7 * H] if use_peepholes else [1, 4 * H]
    bias = helper.create_parameter(
        bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input.name], "Weight": [weight.name]}
    if bias is not None:
        ins["Bias"] = [bias.name]
    if h_0 is not None:
        ins["H0"] = [h_0.name]
    if c_0 is not None:
        ins["C0"] = [c_0.name]
    if sequence_length is not None:
        ins["SequenceLength"] = [sequence_length.name]
    helper.append_op(
        type="lstm",
        inputs=ins,
        outputs={"Hidden": [hidden.name], "Cell": [cell.name],
                 "LastHidden": [last_h.name], "LastCell": [last_c.name]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    return hidden, cell, last_h, last_c


def dynamic_gru(input, size, h_0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", dtype="float32", name=None,
                sequence_length=None, origin_mode=False):
    """GRU over pre-projected inputs [B, T, 3H]; size = H.

    Returns hidden [B, T, H].  origin_mode=False (the reference default,
    fluid/layers/nn.py dynamic_gru) computes h = (1-u)*h_prev + u*c;
    origin_mode=True the original-paper h = u*h_prev + (1-u)*c.
    """
    helper = LayerHelper("gru", name=name)
    weight = helper.create_parameter(
        param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(
        bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input.name], "Weight": [weight.name]}
    if bias is not None:
        ins["Bias"] = [bias.name]
    if h_0 is not None:
        ins["H0"] = [h_0.name]
    if sequence_length is not None:
        ins["SequenceLength"] = [sequence_length.name]
    helper.append_op(
        type="gru",
        inputs=ins,
        outputs={"Hidden": [hidden.name], "LastHidden": [last_h.name]},
        attrs={
            "is_reverse": is_reverse,
            "origin_mode": origin_mode,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
        },
    )
    return hidden


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size=None,
         num_layers=1, dropout_prob=0.0, is_bidirec=False, dtype="float32",
         is_test=False, name=None, param_attr=None, bias_attr=None,
         sequence_length=None):
    """Multi-layer (optionally bidirectional) LSTM over raw inputs
    [B, T, D] — parity with layers.lstm / cudnn_lstm_op.cu, where cuDNN's
    fused multi-layer kernel becomes stacked lstm ops.

    Returns (output [B,T,H or 2H], last_hidden [B,H or 2H], last_cell
    [B,H or 2H]) — last states are the top layer's final carry per
    direction (so they respect sequence_length and the backward direction's
    time order), concatenated over directions.
    """
    from . import nn as nn_layers
    from .tensor import concat

    helper = LayerHelper("cudnn_lstm", name=name)
    x = input
    for layer in range(num_layers):
        def one_dir(xin, reverse):
            proj = nn_layers.fc(
                xin, size=4 * hidden_size, num_flatten_dims=2,
                bias_attr=False, param_attr=param_attr,
                name=unique_name.generate(f"{helper.name}.l{layer}.proj"))
            return _lstm_full(
                proj, 4 * hidden_size, use_peepholes=False,
                is_reverse=reverse, dtype=dtype, param_attr=param_attr,
                bias_attr=bias_attr, sequence_length=sequence_length,
                name=unique_name.generate(f"{helper.name}.l{layer}"))
        fwd_h, fwd_c, fwd_lh, fwd_lc = one_dir(x, False)
        if is_bidirec:
            bwd_h, bwd_c, bwd_lh, bwd_lc = one_dir(x, True)
            x = concat([fwd_h, bwd_h], axis=2)
            last_h = concat([fwd_lh, bwd_lh], axis=1)
            last_c = concat([fwd_lc, bwd_lc], axis=1)
        else:
            x = fwd_h
            last_h, last_c = fwd_lh, fwd_lc
        if dropout_prob and not is_test and layer < num_layers - 1:
            x = nn_layers.dropout(x, dropout_prob)
    return x, last_h, last_c
