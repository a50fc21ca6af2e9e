"""BERT: the pretraining graph builders and the causal LM of the
generation path.

Counterpart of paddle_tpu/models/transformer.py:

* the graph builders ``encoder_layer``, ``bert_encoder``,
  ``bert_pretrain_loss`` and ``build_bert_pretrain`` (dense MLM head),
  and the causal LM's ``lm_layer``, ``build_lm_logits`` and
  ``build_lm_greedy_infer`` (one StaticRNN), built from the port's
  ``layers`` under the JAX package's deterministic parameter names, so
  one program description serves both packages; ``lm_params_from_scope``
  reads the LM's weights back out of a scope;
* the pure-tensor ``lm_*`` functions the generation engine composes with
  its KV cache.  Parameters are the same flat ``"lm.*"`` dict:
  ``lm_random_params`` makes the numpy arrays exactly as the JAX package
  does, and ``lm_params_from_numpy`` turns either package's dict into
  tensors on one device.  Layout is the JAX package's: packed heads,
  ``x [..., H]``, weights ``[in, out]``.

Numerics follow the reference: layer norm over the feature axis with the
population variance and eps 1e-5, exact-erf GELU, float32 matmuls.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import layers
from ..initializer import ConstantInitializer, TruncatedNormalInitializer
from ..ops.attention import attention_packed
from ..param_attr import ParamAttr

__all__ = ["BertConfig", "encoder_layer", "bert_encoder",
           "bert_pretrain_loss", "build_bert_pretrain", "lm_layer",
           "build_lm_logits", "build_lm_greedy_infer",
           "LM_PARAM_SUFFIXES", "lm_param_names", "lm_params_from_scope",
           "lm_random_params", "lm_params_from_numpy", "lm_embed",
           "lm_layer_qkv", "lm_layer_finish", "lm_logits", "lm_forward",
           "tp_sharding_rules"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    initializer_range: float = 0.02
    # the fused (flash) attention op — the hand-written kernels on the
    # card; off = the unfused matmul/softmax ops
    fused_attention: bool = True

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def large():
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          ffn_size=4096)

    @staticmethod
    def ernie_base():
        return BertConfig(vocab_size=18000, max_position=513)

    @staticmethod
    def ernie_large():
        return BertConfig(vocab_size=18000, max_position=513,
                          hidden_size=1024, num_layers=24, num_heads=16,
                          ffn_size=4096)

    @staticmethod
    def tiny():
        """For tests & dry runs."""
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, ffn_size=128, max_position=128)


# --------------------------------------------------------------------------
# Graph builders (the layers API): BERT pretraining
# --------------------------------------------------------------------------

def _w(name, cfg):
    return ParamAttr(
        name=name,
        initializer=TruncatedNormalInitializer(0.0, cfg.initializer_range))


def _b(name):
    return ParamAttr(name=name, initializer=ConstantInitializer(0.0))


def _fc(x, size, name, cfg, act=None, num_flatten_dims=2):
    return layers.fc(
        x, size, num_flatten_dims=num_flatten_dims,
        param_attr=_w(name + ".w", cfg), bias_attr=_b(name + ".b"), act=act)


def _graph_ln(x, name):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}.scale",
                             initializer=ConstantInitializer(1.0)),
        bias_attr=ParamAttr(name=f"{name}.bias",
                            initializer=ConstantInitializer(0.0)))


def encoder_layer(x, attn_bias, cfg: BertConfig, name: str, is_test=False):
    """Post-LN transformer layer, matching the original BERT."""
    h = cfg.hidden_size
    n_head = cfg.num_heads
    d_head = h // n_head

    qkv = _fc(x, 3 * h, f"{name}.attn.qkv", cfg)  # [B, L, 3H]
    if cfg.fused_attention:
        # packed layout: slice [B, L, 3H] into three strided [B, L, H]
        # views; the flash kernels read the heads by offset (no copies)
        q = layers.slice(qkv, [2], [0], [h])
        k = layers.slice(qkv, [2], [h], [2 * h])
        v = layers.slice(qkv, [2], [2 * h], [3 * h])
        ctxt = layers.fused_multihead_attention(
            q, k, v, attn_bias=attn_bias, dropout_rate=cfg.attn_dropout,
            sm_scale=1.0 / math.sqrt(d_head), is_test=is_test,
            num_heads=n_head)  # [B, L, H]
    else:
        qkv = layers.reshape(qkv, [0, 0, 3, n_head, d_head])
        qkv = layers.transpose(qkv, [2, 0, 3, 1, 4])  # [3, B, nh, L, dh]
        q = layers.squeeze(layers.slice(qkv, [0], [0], [1]), [0])
        k = layers.squeeze(layers.slice(qkv, [0], [1], [2]), [0])
        v = layers.squeeze(layers.slice(qkv, [0], [2], [3]), [0])
        scores = layers.matmul(q, k, transpose_y=True,
                               alpha=1.0 / math.sqrt(d_head))  # [B,nh,L,L]
        if attn_bias is not None:
            scores = layers.elementwise_add(scores, attn_bias)
        probs = layers.softmax(scores)
        if cfg.attn_dropout > 0:
            probs = layers.dropout(
                probs, cfg.attn_dropout, is_test=is_test,
                dropout_implementation="upscale_in_train")
        ctxt = layers.matmul(probs, v)  # [B, nh, L, dh]
        ctxt = layers.transpose(ctxt, [0, 2, 1, 3])
        ctxt = layers.reshape(ctxt, [0, 0, h])

    attn_out = _fc(ctxt, h, f"{name}.attn.out", cfg)
    if cfg.hidden_dropout > 0:
        attn_out = layers.dropout(
            attn_out, cfg.hidden_dropout, is_test=is_test,
            dropout_implementation="upscale_in_train")
    x = _graph_ln(layers.elementwise_add(x, attn_out), f"{name}.ln1")

    ffn = _fc(x, cfg.ffn_size, f"{name}.ffn.in", cfg, act="gelu")
    ffn = _fc(ffn, h, f"{name}.ffn.out", cfg)
    if cfg.hidden_dropout > 0:
        ffn = layers.dropout(ffn, cfg.hidden_dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return _graph_ln(layers.elementwise_add(x, ffn), f"{name}.ln2")


def bert_encoder(src_ids, input_mask, cfg: BertConfig, is_test=False,
                 boundaries=None):
    """src_ids: [B, L] int; input_mask: [B, L] float (1 = real token).
    Returns the [B, L, H] sequence output.

    If `boundaries` is a list, the embedding output and every layer output
    Variable are appended to it — the checkpoints RecomputeOptimizer
    takes (and the pipeline cut points of the JAX package)."""
    emb = layers.embedding(
        src_ids, (cfg.vocab_size, cfg.hidden_size),
        param_attr=_w("embeddings.word", cfg))
    pos = layers.range(0, cfg.max_position, 1, "int64")
    pos_emb_table = layers.embedding(
        pos, (cfg.max_position, cfg.hidden_size),
        param_attr=_w("embeddings.position", cfg))  # [max_pos, H]
    L = src_ids.shape[1]
    pos_emb = layers.slice(pos_emb_table, [0], [0], [L])  # [L, H]
    x = layers.elementwise_add(emb, pos_emb, axis=1)
    x = _graph_ln(x, "embeddings.ln")
    if cfg.hidden_dropout > 0:
        x = layers.dropout(x, cfg.hidden_dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")

    # additive attention bias: [B, 1, 1, L], 0 for keep, -1e4 for pad
    bias = layers.scale(input_mask, scale=1e4, bias=-1e4)
    attn_bias = layers.unsqueeze(bias, [1, 2])
    if boundaries is not None:
        boundaries.append(x)
    for i in range(cfg.num_layers):
        x = encoder_layer(x, attn_bias, cfg, f"encoder.layer{i}",
                          is_test=is_test)
        if boundaries is not None:
            boundaries.append(x)
    return x


def bert_pretrain_loss(seq_out, masked_labels, cfg: BertConfig):
    """MLM head: project to vocab, softmax-CE with ignore_index=-1 on
    unmasked positions (parity: ERNIE pretraining objective)."""
    logits = _fc(seq_out, cfg.vocab_size, "mlm.out", cfg)
    loss = layers.softmax_with_cross_entropy(
        logits, masked_labels, ignore_index=-1)
    total = layers.reduce_sum(loss)
    valid = layers.reduce_sum(
        layers.cast(layers.not_equal(masked_labels, -1), "float32"))
    return layers.elementwise_div(
        total, layers.elementwise_max(valid, 1.0))


def bert_pretrain_loss_masked(seq_out, mask_pos_flat, mask_labels, cfg):
    """MLM head over gathered masked positions ONLY (parity: ERNIE's
    mask_pos pipeline — the reference gathers ~15% masked positions with
    host-computed flat indices before the vocab projection, so the
    [B·L, vocab] logits tensor never exists).

    seq_out: [B, L, H]; mask_pos_flat: [n] int (position + b·L, computed
    host-side where B is known); mask_labels: [n, 1] int, -1 = padding
    slot (ignored)."""
    h = cfg.hidden_size
    flat = layers.reshape(seq_out, [-1, h])              # [B*L, H]
    picked = layers.gather(flat, mask_pos_flat)          # [n, H]
    logits = layers.fc(
        picked, cfg.vocab_size, num_flatten_dims=1,
        param_attr=_w("mlm.out.w", cfg), bias_attr=_b("mlm.out.b"))
    loss = layers.softmax_with_cross_entropy(
        logits, mask_labels, ignore_index=-1)
    total = layers.reduce_sum(loss)
    valid = layers.reduce_sum(
        layers.cast(layers.not_equal(mask_labels, -1), "float32"))
    return layers.elementwise_div(
        total, layers.elementwise_max(valid, 1.0))


def build_bert_pretrain(cfg: BertConfig, seq_len: int, is_test=False,
                        num_pipeline_stages=None, max_masked=None,
                        want_boundaries=False):
    """Declares feeds and builds the full pretrain graph.  Returns
    (loss, feeds dict); with num_pipeline_stages also returns the cut
    list (S+1 boundary Variables) for optimizer.PipelineOptimizer.

    max_masked: if set, use the masked-position head — feeds gain
    "mask_pos" ([B·max_masked] flat indices = pos + b·seq_len) and
    "masked_labels" becomes [B·max_masked, 1] (-1 pads); if None, the
    dense full-sequence head (labels [B, L, 1], -1 = unmasked).

    want_boundaries: also return the embedding and per-layer output
    Variables (e.g. as RecomputeOptimizer checkpoints)."""
    from ..core.program import data

    src_ids = data("src_ids", [None, seq_len], "int64")
    input_mask = data("input_mask", [None, seq_len], "float32")
    boundaries = [] if (num_pipeline_stages or want_boundaries) else None
    seq_out = bert_encoder(src_ids, input_mask, cfg, is_test=is_test,
                           boundaries=boundaries)
    if max_masked is not None:
        mask_pos = data("mask_pos", [None], "int64")
        masked_labels = data("masked_labels", [None, 1], "int64")
        loss = bert_pretrain_loss_masked(seq_out, mask_pos, masked_labels,
                                         cfg)
        feeds = {"src_ids": src_ids, "input_mask": input_mask,
                 "mask_pos": mask_pos, "masked_labels": masked_labels}
    else:
        masked_labels = data("masked_labels", [None, seq_len, 1], "int64")
        loss = bert_pretrain_loss(seq_out, masked_labels, cfg)
        feeds = {"src_ids": src_ids, "input_mask": input_mask,
                 "masked_labels": masked_labels}
    if not num_pipeline_stages:
        if want_boundaries:
            return loss, feeds, boundaries
        return loss, feeds
    S = num_pipeline_stages
    if cfg.num_layers % S:
        raise ValueError(f"{cfg.num_layers} layers not divisible into "
                         f"{S} pipeline stages")
    k = cfg.num_layers // S
    cut_list = [boundaries[i] for i in range(0, cfg.num_layers + 1, k)]
    return loss, feeds, cut_list


def tp_sharding_rules():
    """Megatron-style tensor-parallel placement over the `model` axis
    (the JAX package's rules).  Under a mesh with `model` > 1 each rank
    stores its shard (the fused qkv weight and bias head-grouped: its
    own heads' q, k and v columns) and computes its own heads, FFN
    columns and vocab rows: column-parallel qkv, `ffn.in` and MLM
    logits, row-parallel `attn.out` and `ffn.out` summed over `model`,
    the vocab-parallel embedding (core/spmd.py); no weight is gathered
    whole inside a step."""
    return [
        (r"\.attn\.qkv\.w$", (None, "model")),
        (r"\.attn\.qkv\.b$", ("model",)),
        (r"\.attn\.out\.w$", ("model", None)),
        (r"\.ffn\.in\.w$", (None, "model")),
        (r"\.ffn\.in\.b$", ("model",)),
        (r"\.ffn\.out\.w$", ("model", None)),
        (r"embeddings\.word$", ("model", None)),
        (r"mlm\.out\.w$", (None, "model")),
    ]


# --------------------------------------------------------------------------
# Decoder-only causal LM (the generation workload)
# --------------------------------------------------------------------------
#
# One parameter set, three execution forms, all sharing the "lm.*"
# parameter names so weights move freely between them (and between the
# packages):
#
#   1. `build_lm_logits`      — graph form (layers API): full-context
#      causal forward;
#   2. `build_lm_greedy_infer`— graph form: one StaticRNN whose every step
#      RE-RUNS the causal forward over the whole token buffer — the
#      uncached baseline the generation engine is measured against;
#   3. the `lm_*` tensor functions below — the CACHED decode path that
#      `generation.GenerationEngine` composes with its KV cache.
#
# Architecture: BERT-style post-LN blocks (gelu FFN) with causal
# attention and the output projection tied to the word embedding.


def lm_layer(x, cfg: BertConfig, name: str, is_test=True):
    """Post-LN transformer block with CAUSAL packed fused attention
    (graph form; parameters ``{name}.attn.qkv.w`` ... as
    ``lm_param_names``)."""
    h = cfg.hidden_size
    d_head = h // cfg.num_heads
    qkv = _fc(x, 3 * h, f"{name}.attn.qkv", cfg)
    q = layers.slice(qkv, [2], [0], [h])
    k = layers.slice(qkv, [2], [h], [2 * h])
    v = layers.slice(qkv, [2], [2 * h], [3 * h])
    ctxt = layers.fused_multihead_attention(
        q, k, v, causal=True, dropout_rate=cfg.attn_dropout,
        sm_scale=1.0 / math.sqrt(d_head), is_test=is_test,
        num_heads=cfg.num_heads)
    attn_out = _fc(ctxt, h, f"{name}.attn.out", cfg)
    if cfg.hidden_dropout > 0:
        attn_out = layers.dropout(
            attn_out, cfg.hidden_dropout, is_test=is_test,
            dropout_implementation="upscale_in_train")
    x = _graph_ln(layers.elementwise_add(x, attn_out), f"{name}.ln1")
    ffn = _fc(x, cfg.ffn_size, f"{name}.ffn.in", cfg, act="gelu")
    ffn = _fc(ffn, h, f"{name}.ffn.out", cfg)
    if cfg.hidden_dropout > 0:
        ffn = layers.dropout(ffn, cfg.hidden_dropout, is_test=is_test,
                             dropout_implementation="upscale_in_train")
    return _graph_ln(layers.elementwise_add(x, ffn), f"{name}.ln2")


def build_lm_logits(src_ids, cfg: BertConfig, is_test=True):
    """Full-context causal LM: src_ids [B, T] int -> logits [B, T, V]
    (projection tied to lm.word_emb)."""
    emb = layers.embedding(
        src_ids, (cfg.vocab_size, cfg.hidden_size),
        param_attr=_w("lm.word_emb", cfg))
    pos = layers.range(0, cfg.max_position, 1, "int64")
    pos_table = layers.embedding(
        pos, (cfg.max_position, cfg.hidden_size),
        param_attr=_w("lm.pos_emb", cfg))
    T = src_ids.shape[1]
    pos_emb = layers.slice(pos_table, [0], [0], [T])
    x = layers.elementwise_add(emb, pos_emb, axis=1)
    x = _graph_ln(x, "lm.emb_ln")
    if cfg.hidden_dropout > 0:
        x = layers.dropout(x, cfg.hidden_dropout, is_test=is_test,
                           dropout_implementation="upscale_in_train")
    for i in range(cfg.num_layers):
        x = lm_layer(x, cfg, f"lm.layer{i}", is_test=is_test)
    emb_var = x.block.program.global_block().var("lm.word_emb")
    return layers.matmul(x, emb_var, transpose_y=True)


def build_lm_greedy_infer(cfg: BertConfig, batch: int, prompt_len: int,
                          max_new: int):
    """Uncached greedy decoder: ONE StaticRNN whose every step re-runs
    the full causal LM over the whole padded token buffer and argmaxes
    the current position — the re-attend baseline that the KV-cached
    GenerationEngine must beat.

    Feeds: prompt_ids [batch, prompt_len] int64.  Returns the step
    outputs Variable: [max_new, batch] int64 generated tokens."""
    from ..core.program import data

    B, P, N = batch, prompt_len, max_new
    T = P + N
    if T > cfg.max_position:
        raise ValueError(f"prompt_len + max_new = {T} exceeds "
                         f"max_position {cfg.max_position}")
    prompt_ids = data("prompt_ids", [B, P], "int64")
    buf0 = layers.concat(
        [prompt_ids, layers.fill_constant([B, N], "int64", 0.0)], axis=1)

    eye = np.eye(T, dtype=np.float32)
    sel_rows = layers.assign(eye[P - 1:P - 1 + N])         # [N, T]
    put_rows = layers.assign(eye[P:P + N])                 # [N, T]

    rnn = layers.StaticRNN()
    with rnn.step():
        sel_row = rnn.step_input(sel_rows)                 # [T]
        put_row = rnn.step_input(put_rows)                 # [T]
        buf = rnn.memory(init=buf0)                        # [B, T]
        hid = build_lm_logits(buf, cfg, is_test=True)      # [B, T, V]
        logit_t = layers.reduce_sum(                       # [B, V]
            layers.elementwise_mul(
                hid, layers.reshape(sel_row, [1, T, 1])), dim=1)
        nxt = layers.cast(layers.argmax(logit_t, axis=-1), "int64")
        nxt2 = layers.reshape(nxt, [B, 1])                 # [B, 1]
        put = layers.reshape(put_row, [1, T])
        keep = layers.elementwise_sub(
            layers.fill_constant([1, T], "float32", 1.0), put)
        buf_new = layers.cast(
            layers.elementwise_add(
                layers.elementwise_mul(layers.cast(buf, "float32"), keep),
                layers.elementwise_mul(layers.cast(nxt2, "float32"), put)),
            "int64")
        rnn.update_memory(buf, buf_new)
        rnn.step_output(nxt)
    return rnn()                                           # [N, B]


LM_PARAM_SUFFIXES = (
    ".attn.qkv.w", ".attn.qkv.b", ".attn.out.w", ".attn.out.b",
    ".ln1.scale", ".ln1.bias", ".ffn.in.w", ".ffn.in.b",
    ".ffn.out.w", ".ffn.out.b", ".ln2.scale", ".ln2.bias",
)


def lm_param_names(cfg: BertConfig):
    names = ["lm.word_emb", "lm.pos_emb", "lm.emb_ln.scale",
             "lm.emb_ln.bias"]
    for i in range(cfg.num_layers):
        names.extend(f"lm.layer{i}{s}" for s in LM_PARAM_SUFFIXES)
    return names


def lm_params_from_scope(cfg: BertConfig, scope=None):
    """The LM parameters of a scope (after the startup program of a
    build_lm_* graph ran) as the flat dict of numpy arrays the JAX
    package's ``lm_params_from_scope`` returns; ``lm_params_from_numpy``
    puts them on a device for the engine."""
    from ..core.scope import global_scope

    scope = scope or global_scope()
    params = {}
    for n in lm_param_names(cfg):
        val = scope.find_var(n)
        if val is None:
            raise KeyError(
                f"LM parameter '{n}' not found in scope — run the "
                f"startup program of a build_lm_* graph first")
        params[n] = (val.detach().cpu().numpy() if torch.is_tensor(val)
                     else np.asarray(val))
    return params


def lm_random_params(cfg: BertConfig, rng):
    """numpy random init, draw for draw the JAX package's
    ``lm_random_params``: the same ``RandomState`` gives the same
    arrays in both packages."""
    h, f, v = cfg.hidden_size, cfg.ffn_size, cfg.vocab_size

    def trunc(*shape):
        return (rng.randn(*shape) * cfg.initializer_range).astype(
            np.float32)

    params = {"lm.word_emb": trunc(v, h),
              "lm.pos_emb": trunc(cfg.max_position, h),
              "lm.emb_ln.scale": np.ones(h, np.float32),
              "lm.emb_ln.bias": np.zeros(h, np.float32)}
    for i in range(cfg.num_layers):
        p = f"lm.layer{i}"
        params.update({
            f"{p}.attn.qkv.w": trunc(h, 3 * h),
            f"{p}.attn.qkv.b": np.zeros(3 * h, np.float32),
            f"{p}.attn.out.w": trunc(h, h),
            f"{p}.attn.out.b": np.zeros(h, np.float32),
            f"{p}.ln1.scale": np.ones(h, np.float32),
            f"{p}.ln1.bias": np.zeros(h, np.float32),
            f"{p}.ffn.in.w": trunc(h, f),
            f"{p}.ffn.in.b": np.zeros(f, np.float32),
            f"{p}.ffn.out.w": trunc(f, h),
            f"{p}.ffn.out.b": np.zeros(h, np.float32),
            f"{p}.ln2.scale": np.ones(h, np.float32),
            f"{p}.ln2.bias": np.zeros(h, np.float32),
        })
    return params


def lm_params_from_numpy(params, device, dtype=torch.float32):
    """The flat ``"lm.*"`` dict of arrays (``lm_random_params`` of either
    package, or ``lm_params_from_scope``) as tensors on ``device``.
    Tensors already there with that dtype are kept, not copied."""
    def tensor(p):
        return p if torch.is_tensor(p) else torch.from_numpy(
            np.ascontiguousarray(p))

    return {n: tensor(p).to(device=device, dtype=dtype)
            for n, p in params.items()}


def _dense(params, name, x, act=None):
    y = x @ params[name + ".w"] + params[name + ".b"]
    if act == "gelu":
        y = F.gelu(y, approximate="none")       # exact erf, as the reference
    return y


def _ln(params, name, x, eps=1e-5):
    """Layer norm over the feature axis, population variance."""
    return F.layer_norm(x, (x.shape[-1],), params[name + ".scale"],
                        params[name + ".bias"], eps)


def lm_embed(params, cfg: BertConfig, tokens, positions):
    """tokens/positions: int tensors of identical shape [...]; returns
    LN'd embeddings [..., H] (inference — no dropout)."""
    x = params["lm.word_emb"][tokens] + params["lm.pos_emb"][positions]
    return _ln(params, "lm.emb_ln", x)


def lm_layer_qkv(params, cfg: BertConfig, i, x):
    """x [..., H] -> (q, k, v) each [..., H] (packed head layout; views
    into one projection, so not contiguous)."""
    qkv = _dense(params, f"lm.layer{i}.attn.qkv", x)
    return qkv.chunk(3, dim=-1)


def lm_layer_finish(params, cfg: BertConfig, i, x, ctxt):
    """Post-attention half of the block: out proj + LN + FFN + LN."""
    p = f"lm.layer{i}"
    x = _ln(params, f"{p}.ln1", x + _dense(params, f"{p}.attn.out", ctxt))
    ffn = _dense(params, f"{p}.ffn.out",
                 _dense(params, f"{p}.ffn.in", x, act="gelu"))
    return _ln(params, f"{p}.ln2", x + ffn)


def lm_logits(params, cfg: BertConfig, x):
    """Tied output projection: x [..., H] -> [..., V]."""
    return x @ params["lm.word_emb"].T


def lm_forward(params, cfg: BertConfig, tokens):
    """Full-context causal recompute: tokens [B, T] int -> logits
    [B, T, V], with the plain causal attention of ops.attention."""
    B, T = tokens.shape
    d_head = cfg.hidden_size // cfg.num_heads
    pos = torch.arange(T, device=tokens.device).expand(B, T)
    x = lm_embed(params, cfg, tokens, pos)
    for i in range(cfg.num_layers):
        q, k, v = lm_layer_qkv(params, cfg, i, x)
        ctxt = attention_packed(q, k, v, cfg.num_heads, causal=True,
                                sm_scale=1.0 / math.sqrt(d_head))
        x = lm_layer_finish(params, cfg, i, x, ctxt)
    return lm_logits(params, cfg, x)
