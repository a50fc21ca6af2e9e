"""Fused operators and RNN units of the port (parity: fc_op.cc,
gru_unit_op.h, lstm_unit_op.h, lstmp_op.cc, cudnn_lstm_op.cc,
fused/fusion_lstm_op.cc, fused/fusion_gru_op.cc,
fused/fused_embedding_seq_pool_op.cc, fused/fused_elemwise_activation_op.cc,
fused/fused_fc_elementwise_layernorm_op.cc, fused/fused_batch_norm_act_op.cc,
fused/fusion_repeated_fc_relu_op.cc, fused/fusion_seqconv_eltadd_relu_op.cc,
fused/fusion_seqexpand_concat_fc_op.cc, fused/fusion_seqpool_concat_op.cc,
fused/fusion_seqpool_cvm_concat_op.cc, fused/fusion_squared_mat_sub_op.cc,
fused/fusion_transpose_flatten_concat_op.cc, fused/multihead_matmul_op.cu,
fused/conv2d_fusion_op.cc).

Counterpart of paddle_tpu/ops/fused.py, op for op.  These exist for
program-level parity (a reference program using fusion_gru must load and
run); each body is the plain composition, as the JAX package's is, in
plain PyTorch.  None is routed to the port's kernels.  Sequence inputs
use the padded dense layout ([B, T, ...]).
"""
from __future__ import annotations

import math

import torch

from ..core.registry import out, register_op, single
from .rnn import _act, _time_order
from .tensor import embedding_rows


@register_op("fc", inputs=("Input", "W", "Bias"), outputs=("Out",))
def fc(ctx, inputs, attrs):
    """fc_op.cc: flatten to in_num_col_dims, matmul, bias, activation."""
    x = single(inputs, "Input")
    w = single(inputs, "W")
    b = single(inputs, "Bias")
    ncd = int(attrs.get("in_num_col_dims", 1))
    lead = tuple(x.shape[:ncd])
    y = x.reshape(math.prod(lead), -1) @ w
    if b is not None:
        y = y + b.reshape(1, -1)
    act = attrs.get("activation_type", "")
    if act:
        y = _act(act)(y)
    return out(Out=y.reshape(lead + (w.shape[1],)))


_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


def _unit_act(attrs, key, default):
    """gru_unit's activations: an int code of the reference's enum or a
    name."""
    v = attrs.get(key, default)
    return _act(_ACT_CODES.get(v, _ACT_CODES[default])
                if isinstance(v, int) else v)


@register_op("gru_unit", inputs=("Input", "HiddenPrev", "Weight", "Bias"),
             outputs=("Gate", "ResetHiddenPrev", "Hidden"))
def gru_unit(ctx, inputs, attrs):
    """gru_unit_op.h: one GRU step.  Input [B, 3D] pre-projected; Weight
    [D, 3D] ([:, :2D] u,r / [:, 2D:] candidate).  origin_mode picks
    h = c + u(h_prev - c) vs h = u(c - h_prev) + h_prev."""
    x = single(inputs, "Input")
    h_p = single(inputs, "HiddenPrev")
    w = single(inputs, "Weight")
    b = single(inputs, "Bias")
    D = h_p.shape[1]
    gate_act = _unit_act(attrs, "gate_activation", 1)
    cand_act = _unit_act(attrs, "activation", 2)
    g = x + b.reshape(1, -1) if b is not None else x
    ur = gate_act(g[:, :2 * D] + h_p @ w[:, :2 * D])
    u, r = ur[:, :D], ur[:, D:]
    r_h_p = r * h_p
    c = cand_act(g[:, 2 * D:] + r_h_p @ w[:, 2 * D:])
    if attrs.get("origin_mode", False):
        h = c + u * (h_p - c)
    else:
        h = u * (c - h_p) + h_p
    return out(Gate=torch.cat([u, r, c], dim=1), ResetHiddenPrev=r_h_p,
               Hidden=h)


@register_op("lstm_unit", inputs=("X", "C_prev"), outputs=("C", "H"))
def lstm_unit(ctx, inputs, attrs):
    """lstm_unit_op.h: X [B, 4D] in (i, f, o, g) order; forget_bias added
    to f pre-sigmoid."""
    x = single(inputs, "X")
    c_prev = single(inputs, "C_prev")
    D = c_prev.shape[1]
    fb = float(attrs.get("forget_bias", 0.0))
    i = torch.sigmoid(x[:, :D])
    f = torch.sigmoid(x[:, D:2 * D] + fb)
    o = torch.sigmoid(x[:, 2 * D:3 * D])
    g = torch.tanh(x[:, 3 * D:])
    c = f * c_prev + i * g
    return out(C=c, H=o * torch.tanh(c))


@register_op("lstmp", inputs=("Input", "H0", "C0", "Weight", "ProjWeight",
                              "Bias"),
             outputs=("Projection", "Cell", "BatchGate", "BatchCellPreAct",
                      "BatchHidden"))
def lstmp(ctx, inputs, attrs):
    """lstmp_op.cc: LSTM with a recurrent projection layer.  Padded dense
    Input [B, T, 4H]; Weight [P, 4H] maps the PROJECTED state to gates;
    ProjWeight [H, P].  Gate order i, f, c~, o (lstm_op layout).  A
    plain loop over time, as ops/rnn.py's."""
    x = single(inputs, "Input")
    w = single(inputs, "Weight")
    pw = single(inputs, "ProjWeight")
    b = single(inputs, "Bias")
    h0 = single(inputs, "H0")
    c0 = single(inputs, "C0")
    B, T, H4 = x.shape
    H = H4 // 4
    P = pw.shape[1]
    if x.device.type == "meta":
        return out(Projection=x.new_empty((B, T, P)),
                   Cell=x.new_empty((B, T, H)), BatchGate=x.new_empty(
                       (B, T, H4)), BatchCellPreAct=x.new_empty((B, T, H)),
                   BatchHidden=x.new_empty((B, T, H)))
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cell_act = _act(attrs.get("cell_activation", "tanh"))
    cand_act = _act(attrs.get("candidate_activation", "tanh"))
    proj_act = _act(attrs.get("proj_activation", "identity"))
    cell_clip = float(attrs.get("cell_clip", 0.0))
    proj_clip = float(attrs.get("proj_clip", 0.0))
    xb = x + b.reshape(-1)[:4 * H] if b is not None else x

    p = h0 if h0 is not None else x.new_zeros((B, P))
    c = c0 if c0 is not None else x.new_zeros((B, H))
    xs = xb.unbind(1)
    ps, cs, gs, hs = ([None] * T for _ in range(4))
    for t in _time_order(T, bool(attrs.get("is_reverse", False))):
        gates = torch.addmm(xs[t], p, w)
        i = gate_act(gates[:, :H])
        f = gate_act(gates[:, H:2 * H])
        c = f * c + i * cand_act(gates[:, 2 * H:3 * H])
        if cell_clip > 0:
            c = c.clamp(-cell_clip, cell_clip)
        h = gate_act(gates[:, 3 * H:]) * cell_act(c)
        p = proj_act(h @ pw)
        if proj_clip > 0:
            p = p.clamp(-proj_clip, proj_clip)
        ps[t], cs[t], gs[t], hs[t] = p, c, gates, h
    cell = torch.stack(cs, dim=1)
    return out(Projection=torch.stack(ps, dim=1), Cell=cell,
               BatchGate=torch.stack(gs, dim=1), BatchCellPreAct=cell,
               BatchHidden=torch.stack(hs, dim=1))


@register_op("cudnn_lstm", inputs=("Input", "InitH", "InitC", "W", "Cache"),
             outputs=("Out", "last_h", "last_c"))
def cudnn_lstm(ctx, inputs, attrs):
    """cudnn_lstm_op.cc: a multi-layer time-major LSTM from one packed
    weight blob, per layer W_i|W_f|W_c|W_o input projection [4H, Din],
    then the recurrent [4H, H], then the input and the recurrent bias
    [4H] each — the JAX package's order, element for element.  Each
    layer is the ``lstm`` op's loop over time (not cuDNN)."""
    x = single(inputs, "Input")                   # [T, B, D]
    h0 = single(inputs, "InitH")
    c0 = single(inputs, "InitC")
    w = single(inputs, "W").reshape(-1)
    T, B, D = x.shape
    H = int(attrs["hidden_size"])
    L = int(attrs.get("num_layers", 1))
    if attrs.get("is_bidirec", False):
        raise NotImplementedError(
            "cudnn_lstm: is_bidirec=True has no packed layout in "
            "paddle_tpu_torch; build the backward direction as a second "
            "lstm op with is_reverse=True (layers.lstm(is_bidirec=True) "
            "does) and concatenate")
    if x.device.type == "meta":
        return out(Out=x.new_empty((T, B, H)), last_h=x.new_empty((L, B, H)),
                   last_c=x.new_empty((L, B, H)))

    off = 0

    def take(n, *shape):
        nonlocal off
        part = w[off:off + n].reshape(*shape)
        off += n
        return part

    from .rnn import lstm

    hs = x
    last_h, last_c = [], []
    for layer in range(L):
        din = D if layer == 0 else H
        wi = take(4 * H * din, 4 * H, din)
        wh = take(4 * H * H, 4 * H, H)
        bias = take(4 * H, 4 * H) + take(4 * H, 4 * H)
        res = lstm(ctx, {"Input": [(torch.matmul(hs, wi.t()) + bias)
                                   .transpose(0, 1)],
                         "Weight": [wh.t()], "H0": [h0[layer]],
                         "C0": [c0[layer]]}, {})
        hs = res["Hidden"][0].transpose(0, 1)
        last_h.append(res["LastHidden"][0])
        last_c.append(res["LastCell"][0])
    return out(Out=hs, last_h=torch.stack(last_h),
               last_c=torch.stack(last_c))


def _projected(inputs):
    """fusion_lstm/fusion_gru's inputs with X projected by WeightX: the
    rnn op's slots (Input = XX, Weight = WeightH) and XX."""
    xx = torch.matmul(single(inputs, "X"), single(inputs, "WeightX"))
    sub = dict(inputs)
    sub["Input"] = [xx]
    sub["Weight"] = inputs.get("WeightH", [])
    return sub, xx


@register_op("fusion_lstm", inputs=("X", "WeightX", "WeightH", "Bias",
                                    "H0", "C0"),
             outputs=("Hidden", "Cell", "XX"))
def fusion_lstm(ctx, inputs, attrs):
    """fused/fusion_lstm_op.cc: x-projection + LSTM in one op (the
    composition; only the user-visible slots Hidden, Cell, XX)."""
    from .rnn import lstm

    sub, xx = _projected(inputs)
    res = lstm(ctx, sub, attrs)
    return out(Hidden=res["Hidden"][0], Cell=res["Cell"][0], XX=xx)


@register_op("fusion_gru", inputs=("X", "H0", "WeightX", "WeightH", "Bias"),
             outputs=("Hidden", "XX"))
def fusion_gru(ctx, inputs, attrs):
    """fused/fusion_gru_op.cc: x-projection + GRU in one op."""
    from .rnn import gru

    sub, xx = _projected(inputs)
    res = gru(ctx, sub, attrs)
    return out(Hidden=res["Hidden"][0], XX=xx)


@register_op("fused_embedding_seq_pool", inputs=("W", "Ids"),
             outputs=("Out",), no_grad_slots=("Ids",))
def fused_embedding_seq_pool(ctx, inputs, attrs):
    """fused/fused_embedding_seq_pool_op.cc: lookup + sum-pool over the
    sequence dim.  Padded dense Ids [B, T] (or [B, T, 1]) with
    padding_idx rows zeroed.  Only ``combiner="sum"``, as the
    reference."""
    if attrs.get("combiner", "sum") != "sum":
        raise NotImplementedError(
            f"fused_embedding_seq_pool: combiner "
            f"{attrs.get('combiner')!r} is not supported; the op sums "
            f"the looked-up rows only (combiner='sum')")
    w = single(inputs, "W")
    ids = single(inputs, "Ids")
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    emb = embedding_rows(w, ids)                  # [B, T, D]
    pad = attrs.get("padding_idx", None)
    if pad is not None and pad >= 0:
        emb = emb.masked_fill((ids == pad)[..., None], 0.0)
    return out(Out=torch.sum(emb, dim=1))


_UNARY = {"relu": torch.relu, "sigmoid": torch.sigmoid,
          "tanh": torch.tanh}


@register_op("fused_elemwise_activation", inputs=("X", "Y"),
             outputs=("Out", "IntermediateOut"))
def fused_elemwise_activation(ctx, inputs, attrs):
    """fused/fused_elemwise_activation_op.cc: functor_list [f1, f2]
    computes Out = f1(X, f2(Y)) for binary f1 / unary f2, or
    Out = f1(f2(X, Y)) for unary f1 / binary f2."""
    x = single(inputs, "X")
    y = single(inputs, "Y")
    f1, f2 = attrs["functor_list"]
    scale = float(attrs.get("scale", 1.0))

    def unary(name, v):
        return v * scale if name == "scale" else _UNARY[name](v)

    def binary(name, a, b):
        return a + b if name == "elementwise_add" else a * b

    if f1.startswith("elementwise"):
        mid = unary(f2, y)
        res = binary(f1, x, mid)
    else:
        mid = binary(f2, x, y)
        res = unary(f1, mid)
    return out(Out=res, IntermediateOut=mid)


@register_op("fused_fc_elementwise_layernorm",
             inputs=("X", "W", "Bias0", "Y", "Scale", "Bias1"),
             outputs=("Out", "Mean", "Variance"))
def fused_fc_elementwise_layernorm(ctx, inputs, attrs):
    """fused/fused_fc_elementwise_layernorm_op.cc:
    layer_norm(fc(x) + y), in plain PyTorch (not kernel #10)."""
    x = single(inputs, "X")
    w = single(inputs, "W")
    b0 = single(inputs, "Bias0")
    y = single(inputs, "Y")
    ncd = int(attrs.get("x_num_col_dims", 1))
    eps = float(attrs.get("epsilon", 1e-5))
    lead = tuple(x.shape[:ncd])
    z = x.reshape(math.prod(lead), -1) @ w
    if b0 is not None:
        z = z + b0.reshape(1, -1)
    z = z.reshape(y.shape) + y
    axis = int(attrs.get("begin_norm_axis", 1))
    flat = z.reshape(math.prod(z.shape[:axis]), -1)
    mean = flat.mean(dim=1, keepdim=True)
    var = flat.var(dim=1, unbiased=False, keepdim=True)
    norm = (flat - mean) / torch.sqrt(var + eps)
    scale = single(inputs, "Scale")
    b1 = single(inputs, "Bias1")
    if scale is not None:
        norm = norm * scale.reshape(1, -1)
    if b1 is not None:
        norm = norm + b1.reshape(1, -1)
    return out(Out=norm.reshape(z.shape), Mean=mean[:, 0],
               Variance=var[:, 0])


@register_op("fused_batch_norm_act",
             inputs=("X", "Scale", "Bias", "Mean", "Variance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance", "ReserveSpace"))
def fused_batch_norm_act(ctx, inputs, attrs):
    """fused/fused_batch_norm_act_op.cc: batch_norm + activation."""
    from .nn import batch_norm

    return bn_act_outputs(batch_norm(ctx, inputs, attrs), attrs)


def bn_act_outputs(res, attrs):
    """fused_batch_norm_act's outputs from batch_norm's ``res`` (here, or
    sync-BN's under a data mesh: core/spmd.py): Y through the op's
    activation, an empty ReserveSpace."""
    res["Y"] = [_act(attrs.get("act_type", "relu"))(res["Y"][0])]
    res["ReserveSpace"] = [torch.zeros((0,), dtype=torch.float32,
                                       device=res["Y"][0].device)]
    return res


@register_op("fusion_repeated_fc_relu", inputs=("X", "W", "Bias"),
             outputs=("ReluOut", "Out"))
def fusion_repeated_fc_relu(ctx, inputs, attrs):
    """fused/fusion_repeated_fc_relu_op.cc: a chain of fc + relu, relu at
    every hop."""
    ws, bs = inputs["W"], inputs["Bias"]
    relus = []
    h = single(inputs, "X")
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = torch.relu(h @ w + b.reshape(1, -1))
        if i < len(ws) - 1:
            relus.append(h)
    return {"ReluOut": relus, "Out": [h]}


@register_op("fusion_seqconv_eltadd_relu", inputs=("X", "Filter", "Bias"),
             outputs=("Out", "ColMat"))
def fusion_seqconv_eltadd_relu(ctx, inputs, attrs):
    """fused/fusion_seqconv_eltadd_relu_op.cc: sequence conv (context
    window, zero past the batch's time axis) + bias + relu.  Padded
    dense X [B, T, D]; Filter [contextLength·D, M]; the default
    contextStart is -(contextLength // 2)."""
    x = single(inputs, "X")
    w = single(inputs, "Filter")
    b = single(inputs, "Bias")
    clen = int(attrs.get("contextLength", 1))
    cstart = int(attrs.get("contextStart", -(clen // 2)))
    B, T, D = x.shape
    cols = []
    for i in range(clen):
        off = cstart + i
        if off < 0:
            seg = torch.cat([x.new_zeros((B, min(-off, T), D)),
                             x[:, :max(T + off, 0)]], dim=1)
        elif off > 0:
            seg = torch.cat([x[:, off:], x.new_zeros((B, min(off, T), D))],
                            dim=1)
        else:
            seg = x
        cols.append(seg)
    col = torch.cat(cols, dim=2)                  # [B, T, clen*D]
    y = torch.relu(torch.matmul(col, w) + b.reshape(1, 1, -1))
    return out(Out=y, ColMat=col)


@register_op("fusion_seqexpand_concat_fc", inputs=("X", "FCWeight",
                                                   "FCBias"),
             outputs=("Out", "FCOut"))
def fusion_seqexpand_concat_fc(ctx, inputs, attrs):
    """fused/fusion_seqexpand_concat_fc_op.cc: X[0] is [B, T, D0], the
    rest are [B, Di] broadcast over T; concat features then fc + act."""
    xs = inputs["X"]
    ref = xs[0]
    B, T = ref.shape[0], ref.shape[1]
    feats = [ref] + [v[:, None, :].expand(B, T, v.shape[-1])
                     for v in xs[1:]]
    cat = torch.cat(feats, dim=2)
    fc_out = torch.matmul(cat, single(inputs, "FCWeight"))
    b = single(inputs, "FCBias")
    if b is not None:
        fc_out = fc_out + b.reshape(1, 1, -1)
    act = _act(attrs.get("fc_activation", "identity"))
    return out(Out=act(fc_out), FCOut=fc_out)


def _seq_pool(x, ptype):
    """Pool [B, T, D] over all of T (these fused ops take no lengths)."""
    if ptype in ("SUM", "sum"):
        return torch.sum(x, dim=1)
    if ptype in ("AVERAGE", "average", "AVG"):
        return torch.mean(x, dim=1)
    if ptype in ("SQRT", "sqrt"):
        return torch.sum(x, dim=1) / math.sqrt(x.shape[1])
    raise NotImplementedError(f"seqpool type {ptype}")


@register_op("fusion_seqpool_concat", inputs=("X",), outputs=("Out",))
def fusion_seqpool_concat(ctx, inputs, attrs):
    """fused/fusion_seqpool_concat_op.cc: pool each [B, T, D] input over T
    and concat."""
    pools = [_seq_pool(x, attrs.get("pooltype", "SUM"))
             for x in inputs["X"]]
    return out(Out=torch.cat(pools, dim=1))


def _cvm(x, use_cvm):
    """operators/cvm_op.h's show/click transform (the JAX package's
    ``cvm`` op): y[:, 0] = log(x0 + 1), y[:, 1] = log(x1 + 1) - y[:, 0];
    without use_cvm the two columns are dropped."""
    if not use_cvm:
        return x[:, 2:]
    c0 = torch.log(x[:, :1] + 1.0)
    c1 = torch.log(x[:, 1:2] + 1.0) - c0
    return torch.cat([c0, c1, x[:, 2:]], dim=1)


@register_op("fusion_seqpool_cvm_concat", inputs=("X", "CVM"),
             outputs=("Out",), no_grad_slots=("CVM",))
def fusion_seqpool_cvm_concat(ctx, inputs, attrs):
    """fused/fusion_seqpool_cvm_concat_op.cc: seqpool + cvm transform +
    concat."""
    use_cvm = attrs.get("use_cvm", True)
    pools = [_cvm(_seq_pool(x, attrs.get("pooltype", "SUM")), use_cvm)
             for x in inputs["X"]]
    return out(Out=torch.cat(pools, dim=1))


@register_op("fusion_squared_mat_sub", inputs=("X", "Y"),
             outputs=("SquaredX", "SquaredY", "SquaredXY", "Out"))
def fusion_squared_mat_sub(ctx, inputs, attrs):
    """fused/fusion_squared_mat_sub_op.cc:
    Out = scalar · ((XY)² - X²Y²)."""
    x = single(inputs, "X")
    y = single(inputs, "Y")
    scalar = float(attrs.get("scalar", 1.0))
    sx, sy = torch.square(x), torch.square(y)
    sxy = torch.square(x @ y)
    return out(SquaredX=sx, SquaredY=sy, SquaredXY=sxy,
               Out=scalar * (sxy - sx @ sy))


@register_op("fusion_transpose_flatten_concat", inputs=("X",),
             outputs=("Out",))
def fusion_transpose_flatten_concat(ctx, inputs, attrs):
    """fused/fusion_transpose_flatten_concat_op.cc: per input transpose
    by trans_axis, flatten from flatten_axis, then concat."""
    trans = tuple(attrs["trans_axis"])
    fax = int(attrs["flatten_axis"])
    parts = []
    for x in inputs["X"]:
        t = x.permute(trans)
        parts.append(t.reshape(math.prod(t.shape[:fax]), -1))
    return out(Out=torch.cat(parts, dim=int(attrs["concat_axis"])))


@register_op("multihead_matmul", inputs=("Input", "W", "Bias", "BiasQK"),
             outputs=("Out",), no_grad_slots=("BiasQK",))
def multihead_matmul(ctx, inputs, attrs):
    """fused/multihead_matmul_op.cu: fused QKV projection + scaled-dot
    attention (no output projection), in plain PyTorch (not the flash
    kernels).  Input [B, S, D]; W [D, 3D] packed Q|K|V; BiasQK added to
    the attention logits."""
    x = single(inputs, "Input")
    w = single(inputs, "W")
    b = single(inputs, "Bias")
    bias_qk = single(inputs, "BiasQK")
    N = int(attrs["head_number"])
    alpha = float(attrs.get("alpha", 1.0))
    B, S, D = x.shape
    qkv = torch.matmul(x, w.reshape(D, -1))
    if b is not None:
        qkv = qkv + b.reshape(1, 1, -1)
    q, k, v = qkv.chunk(3, dim=2)
    H = D // N

    def heads(t):
        return t.reshape(B, S, N, H).transpose(1, 2)   # [B, N, S, H]

    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * alpha
    if bias_qk is not None:
        logits = logits + bias_qk.reshape(B, -1, S, S)
    attn = torch.softmax(logits, dim=-1)
    o = torch.matmul(attn, heads(v))
    return out(Out=o.transpose(1, 2).reshape(B, S, D))


@register_op("conv2d_fusion", inputs=("Input", "Filter", "Bias",
                                      "ResidualData"),
             outputs=("Output",))
def conv2d_fusion(ctx, inputs, attrs):
    """fused/conv2d_fusion_op.cc (cuDNN's fused conv + bias + act +
    residual), as the composition."""
    from .nn import conv2d

    y = conv2d(ctx, inputs, attrs)["Output"][0]
    r = single(inputs, "ResidualData")
    if r is not None:
        y = y + r
    act = attrs.get("activation", "relu")
    if act and act != "identity":
        y = _act(act)(y)
    return {"Output": [y]}


@register_op("gather_mm", inputs=("X", "Index"), outputs=("Out",),
             no_grad_slots=("Index",))
def gather_mm(ctx, inputs, attrs):
    """A row gather expressed as a one-hot matmul, as the JAX op is
    (exact: one-hot rows are 0/1).  Out = Index.shape + X.shape[1:];
    negative indices wrap, an index out of range gives a ZERO row."""
    x = single(inputs, "X")
    idx_in = single(inputs, "Index")
    idx = idx_in.reshape(-1).long()
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    onehot = (idx[:, None] == torch.arange(n, device=idx.device)[None, :]
              ).to(x.dtype)
    picked = onehot @ x.reshape(n, -1)
    return out(Out=picked.reshape(tuple(idx_in.shape) + tuple(x.shape[1:])))
