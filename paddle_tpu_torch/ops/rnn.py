"""Recurrent ops of the port: ``lstm`` and ``gru`` over a padded batch.

Counterpart of paddle_tpu/ops/rnn.py (parity: operators/lstm_op.cc with
math/lstm_compute, gru_op.cc with math/gru_compute).  The JAX package
runs each recurrence as one ``lax.scan`` whose VJP XLA derives; it
reaches no Pallas kernel.  Here the recurrence is a plain loop over the
time steps, one ``addmm`` and a few pointwise ops a step (``addcmul``
where a product and a sum meet), and autograd differentiates it.

Neither op is cuDNN's: Paddle's GRU applies the reset gate before the
candidate product (``cand_act(x_c + (r * h_prev) @ w_c)``), and a step
past a row's length carries the state through unchanged, so ``Hidden``
holds the carried state at padded positions (a packed cuDNN sequence
gives zeros there).  Sequences are batch-major [B, T, ...] with an
optional per-row length tensor in place of LoD.
"""
from __future__ import annotations

import torch

from ..core.registry import out, register_op, single

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _act(name):
    return _ACTS[name]


def _live_masks(seq_len, T, device):
    """T [B, 1] bool masks: step t is inside row b (None without
    lengths)."""
    if seq_len is None:
        return None
    steps = torch.arange(T, device=device)
    return (steps[:, None] < seq_len.reshape(-1)[None, :].to(device))[
        ..., None].unbind(0)


def _time_order(T, is_reverse):
    return range(T - 1, -1, -1) if is_reverse else range(T)


@register_op("lstm", inputs=("Input", "Weight", "Bias", "H0", "C0",
                             "SequenceLength"),
             outputs=("Hidden", "Cell", "LastHidden", "LastCell"),
             no_grad_slots=("SequenceLength",))
def lstm(ctx, inputs, attrs):
    """LSTM over a padded batch.

    Input: [B, T, 4H] pre-projected gate inputs; Weight: [H, 4H]
    hidden-to-gate; Bias: [1, 4H] (or [1, 7H] with peepholes: + W_ic,
    W_fc, W_oc).  Gate order: i, f, c~, o.  Hidden/Cell [B, T, H];
    LastHidden/LastCell [B, H] are the final carry — under a
    SequenceLength mask it freezes at each row's last live step, and for
    is_reverse it is the state after the (time-order) first step."""
    x = single(inputs, "Input")
    w = single(inputs, "Weight")
    b = single(inputs, "Bias")
    h0 = single(inputs, "H0")
    c0 = single(inputs, "C0")
    seq_len = single(inputs, "SequenceLength")

    B, T, H4 = x.shape
    H = H4 // 4
    if x.device.type == "meta":
        seq = x.new_empty((B, T, H))
        last = x.new_empty((B, H))
        return out(Hidden=seq, Cell=seq.clone(), LastHidden=last,
                   LastCell=last.clone())
    use_peepholes = bool(attrs.get("use_peepholes", False))
    is_reverse = bool(attrs.get("is_reverse", False))
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))

    if b is not None:
        bias = b.reshape(-1)
        xb = x + bias[: 4 * H]
        if use_peepholes:
            w_if = bias[4 * H: 6 * H].reshape(2, H)
            w_oc = bias[6 * H: 7 * H]
    else:
        xb = x
        use_peepholes = False

    h = h0 if h0 is not None else x.new_zeros((B, H))
    c = c0 if c0 is not None else x.new_zeros((B, H))
    # one unbind (not a slice a step): a slice's backward writes a
    # whole-input gradient for every step
    xs = xb.unbind(1)
    live = _live_masks(seq_len, T, x.device)
    hs, cs = [None] * T, [None] * T
    for t in _time_order(T, is_reverse):
        gates = torch.addmm(xs[t], h, w)
        if use_peepholes:
            g_if, g_c, g_o = gates.split([2 * H, H, H], dim=1)
            i, f = gate_act(torch.addcmul(g_if.reshape(B, 2, H),
                                          c[:, None, :], w_if)).unbind(1)
            c_new = torch.addcmul(f * c, i, cand_act(g_c))
            o = gate_act(torch.addcmul(g_o, c_new, w_oc))
        else:
            g_c = gates[:, 2 * H: 3 * H]
            i, f, _, o = gate_act(gates).split(H, dim=1)
            c_new = torch.addcmul(f * c, i, cand_act(g_c))
        h_new = o * cell_act(c_new)
        if live is not None:
            h_new = torch.where(live[t], h_new, h)
            c_new = torch.where(live[t], c_new, c)
        h, c = h_new, c_new
        hs[t], cs[t] = h, c
    return out(Hidden=torch.stack(hs, dim=1), Cell=torch.stack(cs, dim=1),
               LastHidden=h, LastCell=c)


@register_op("gru", inputs=("Input", "Weight", "Bias", "H0",
                            "SequenceLength"),
             outputs=("Hidden", "LastHidden"),
             no_grad_slots=("SequenceLength",))
def gru(ctx, inputs, attrs):
    """GRU over a padded batch (parity: gru_op.cc / dynamic_gru).

    Input: [B, T, 3H] pre-projected; Weight: [H, 3H] laid out as the
    reference does — [:, :2H] update+reset, [:, 2H:] candidate; Bias
    [1, 3H].  origin_mode=False (the reference's gru_finalOutput):
    h_t = (1-u)*h_prev + u*c~; origin_mode=True: h_t = u*h_prev +
    (1-u)*c~."""
    x = single(inputs, "Input")
    w = single(inputs, "Weight")
    b = single(inputs, "Bias")
    h0 = single(inputs, "H0")
    seq_len = single(inputs, "SequenceLength")

    B, T, H3 = x.shape
    H = H3 // 3
    if x.device.type == "meta":
        return out(Hidden=x.new_empty((B, T, H)),
                   LastHidden=x.new_empty((B, H)))
    is_reverse = bool(attrs.get("is_reverse", False))
    origin_mode = bool(attrs.get("origin_mode", False))
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cand_act = _act(attrs.get("activation", "tanh"))

    xb = x + b.reshape(-1) if b is not None else x
    w_ur, w_c = w.split([2 * H, H], dim=1)
    h = h0 if h0 is not None else x.new_zeros((B, H))
    xs = xb.unbind(1)
    live = _live_masks(seq_len, T, x.device)
    hs = [None] * T
    for t in _time_order(T, is_reverse):
        x_ur, x_c = xs[t].split([2 * H, H], dim=1)
        u, r = gate_act(torch.addmm(x_ur, h, w_ur)).split(H, dim=1)
        c = cand_act(torch.addmm(x_c, r * h, w_c))
        if origin_mode:
            h_new = torch.addcmul((1.0 - u) * c, u, h)
        else:
            h_new = torch.addcmul((1.0 - u) * h, u, c)
        if live is not None:
            h_new = torch.where(live[t], h_new, h)
        h = h_new
        hs[t] = h
    return out(Hidden=torch.stack(hs, dim=1), LastHidden=h)
