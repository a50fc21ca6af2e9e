"""Transformer NMT (encoder-decoder) — the reference's "transformer-big"
machine-translation model.

Parity targets: the dist-transformer test model
(python/paddle/fluid/tests/unittests/dist_transformer.py — WMT En-De
Transformer with multi-head attention, label smoothing, weight-shared
embeddings) and the beam-search decode path of
book/test_machine_translation.py (while_op + beam_search +
beam_search_decode).

Counterpart of paddle_tpu/models/nmt_transformer.py, under the same
parameter and variable names (so the fusion plan and ``io.load_params``
line up); on the card the attention ops and the fused groups run the
port's flash and GEMM-epilogue kernels.  The design:
  * one weight-tied embedding table serves source embedding, target
    embedding AND the output projection (the reference's
    weight_sharing=True config) — a single [V, H] parameter whose
    gradient accumulates from all three uses through ordinary autodiff;
  * sinusoidal position encodings are a baked constant (no host loop);
  * attention runs the packed-layout fused (flash) kernel —
    causal self-attention in the decoder, padded cross-attention with
    Tq != Tk — so nothing materializes [B, heads, T, T] on HBM;
  * beam decode re-runs the causally-masked decoder over the growing
    prefix inside ONE StaticRNN (a Python loop over the steps here, a
    ``lax.scan`` in the JAX package): dense [B, K] beams, one
    beam_search op per step, one beam_search_decode backtrace.  (A
    KV-cache variant would carry per-layer [B·K, T, H] memories; the
    re-run form trades FLOPs for simplicity.)  The fusion pass plans the
    top level only, so the sub-block's attention ops run the packed
    flash forward.

Tensor-parallel placement: nmt_tp_sharding_rules() gives the Megatron
layout over the `model` mesh axis for every attention/ffn block in both
stacks (qkv/q/kv & ffn-in column-sharded, out row-sharded, embedding
row-sharded over vocab).  Under a mesh with `model` > 1 each rank
computes its own heads and FFN columns, looks up its own vocab rows
and projects the tied logits onto them, gathered along the vocab before
the smoothed cross-entropy (core/spmd.py).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .. import layers
from ..initializer import ConstantInitializer, TruncatedNormalInitializer
from ..param_attr import ParamAttr

__all__ = ["NMTConfig", "build_nmt_train", "build_nmt_beam_infer",
           "nmt_tp_sharding_rules"]


@dataclasses.dataclass
class NMTConfig:
    vocab_size: int = 30000          # shared src/tgt vocab (weight_sharing)
    d_model: int = 512
    num_heads: int = 8
    ffn_size: int = 2048
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    max_position: int = 256
    dropout: float = 0.1
    attn_dropout: float = 0.1
    label_smooth_eps: float = 0.1
    initializer_range: float = 0.02
    fused_attention: bool = True

    @staticmethod
    def base():
        return NMTConfig()

    @staticmethod
    def big():
        """Transformer-big (the reference's dist_transformer "big"
        hyperparameters: d_model 1024, 16 heads, ffn 4096)."""
        return NMTConfig(d_model=1024, num_heads=16, ffn_size=4096,
                         dropout=0.3)

    @staticmethod
    def tiny():
        return NMTConfig(vocab_size=96, d_model=32, num_heads=4,
                         ffn_size=64, num_encoder_layers=2,
                         num_decoder_layers=2, max_position=32,
                         dropout=0.0, attn_dropout=0.0)


def _w(name, cfg):
    return ParamAttr(name=name, initializer=TruncatedNormalInitializer(
        0.0, cfg.initializer_range))


def _b(name):
    return ParamAttr(name=name, initializer=ConstantInitializer(0.0))


def _dense(x, size, name, cfg, act=None):
    return layers.fc(x, size, num_flatten_dims=2,
                     param_attr=_w(name + ".w", cfg),
                     bias_attr=_b(name + ".b"), act=act)


def _ln(x, name):
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name=name + ".scale",
                             initializer=ConstantInitializer(1.0)),
        bias_attr=ParamAttr(name=name + ".bias",
                            initializer=ConstantInitializer(0.0)))


def _dropout(x, rate, is_test):
    if rate > 0:
        return layers.dropout(x, rate, is_test=is_test,
                              dropout_implementation="upscale_in_train")
    return x


def _attention(q_src, kv_src, bias, cfg, name, is_test, causal=False):
    """Multi-head attention block: q from `q_src`, k/v from `kv_src`
    (self-attention when they are the same Variable).  Packed [B, T, H]
    layout end-to-end; output projection included."""
    h, n_head = cfg.d_model, cfg.num_heads
    d_head = h // n_head
    if q_src is kv_src:
        qkv = _dense(q_src, 3 * h, f"{name}.qkv", cfg)
        q = layers.slice(qkv, [2], [0], [h])
        k = layers.slice(qkv, [2], [h], [2 * h])
        v = layers.slice(qkv, [2], [2 * h], [3 * h])
    else:
        q = _dense(q_src, h, f"{name}.q", cfg)
        kv = _dense(kv_src, 2 * h, f"{name}.kv", cfg)
        k = layers.slice(kv, [2], [0], [h])
        v = layers.slice(kv, [2], [h], [2 * h])
    if cfg.fused_attention:
        ctxt = layers.fused_multihead_attention(
            q, k, v, attn_bias=bias, causal=causal,
            dropout_rate=cfg.attn_dropout, is_test=is_test,
            sm_scale=1.0 / math.sqrt(d_head), num_heads=n_head)
    else:
        def split(x):
            x = layers.reshape(x, [0, 0, n_head, d_head])
            return layers.transpose(x, [0, 2, 1, 3])   # [B, nh, T, dh]

        qh, kh, vh = split(q), split(k), split(v)
        scores = layers.matmul(qh, kh, transpose_y=True,
                               alpha=1.0 / math.sqrt(d_head))
        if bias is not None:
            scores = layers.elementwise_add(scores, bias)
        if causal:
            T = q.shape[1]
            tri = np.triu(np.full((T, T), -1e9, np.float32), 1)
            scores = layers.elementwise_add(
                scores, layers.assign(tri.reshape(1, 1, T, T)))
        probs = layers.softmax(scores)
        probs = _dropout(probs, cfg.attn_dropout, is_test)
        ctxt = layers.matmul(probs, vh)
        ctxt = layers.reshape(layers.transpose(ctxt, [0, 2, 1, 3]),
                              [0, 0, h])
    return _dense(ctxt, h, f"{name}.out", cfg)


def _sinusoid_pos(max_len, d_model):
    """The AIAYN sinusoidal table, baked as an in-graph constant."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    dim = np.arange(0, d_model, 2).astype(np.float64)
    angle = pos / np.power(10000.0, dim / d_model)
    table = np.zeros((max_len, d_model), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


def _embed(ids, mask_len, cfg, is_test, name_hint):
    """Shared-table embedding × sqrt(d) + sinusoidal positions."""
    emb = layers.embedding(ids, (cfg.vocab_size, cfg.d_model),
                           param_attr=_w("nmt.word_emb", cfg))
    emb = layers.scale(emb, scale=math.sqrt(cfg.d_model))
    table = layers.assign(_sinusoid_pos(cfg.max_position, cfg.d_model))
    pos = layers.slice(table, [0], [0], [mask_len])        # [T, H]
    x = layers.elementwise_add(emb, pos, axis=1)
    return _dropout(x, cfg.dropout, is_test)


def _pad_bias(mask):
    """[B, T] 1/0 mask → additive [B, 1, 1, T] bias (0 keep, -1e4 pad)."""
    return layers.unsqueeze(layers.scale(mask, scale=1e4, bias=-1e4),
                            [1, 2])


def nmt_encoder(src_ids, src_mask, cfg, is_test=False):
    x = _embed(src_ids, src_ids.shape[1], cfg, is_test, "src")
    bias = _pad_bias(src_mask)
    for i in range(cfg.num_encoder_layers):
        name = f"nmt.enc{i}"
        att = _attention(x, x, bias, cfg, f"{name}.self", is_test)
        x = _ln(layers.elementwise_add(
            x, _dropout(att, cfg.dropout, is_test)), f"{name}.ln1")
        ffn = _dense(_dense(x, cfg.ffn_size, f"{name}.ffn.in", cfg,
                            act="relu"), cfg.d_model,
                     f"{name}.ffn.out", cfg)
        x = _ln(layers.elementwise_add(
            x, _dropout(ffn, cfg.dropout, is_test)), f"{name}.ln2")
    return x


def nmt_decoder(tgt_ids, enc_out, src_mask, cfg, is_test=False):
    """Causal decoder over the (full) target prefix; cross-attends the
    encoder output.  Returns [B, Tt, H] hidden states."""
    x = _embed(tgt_ids, tgt_ids.shape[1], cfg, is_test, "tgt")
    cross_bias = _pad_bias(src_mask)
    for i in range(cfg.num_decoder_layers):
        name = f"nmt.dec{i}"
        att = _attention(x, x, None, cfg, f"{name}.self", is_test,
                         causal=True)
        x = _ln(layers.elementwise_add(
            x, _dropout(att, cfg.dropout, is_test)), f"{name}.ln1")
        cross = _attention(x, enc_out, cross_bias, cfg, f"{name}.cross",
                           is_test)
        x = _ln(layers.elementwise_add(
            x, _dropout(cross, cfg.dropout, is_test)), f"{name}.ln2")
        ffn = _dense(_dense(x, cfg.ffn_size, f"{name}.ffn.in", cfg,
                            act="relu"), cfg.d_model,
                     f"{name}.ffn.out", cfg)
        x = _ln(layers.elementwise_add(
            x, _dropout(ffn, cfg.dropout, is_test)), f"{name}.ln3")
    return x


def _tied_logits(dec_out, cfg):
    """Output projection through the SHARED embedding table (the
    reference's weight_sharing=True: logits = h @ emb^T).  The table
    already exists — _embed created it — so fetch the Parameter by its
    deterministic name; its gradient accumulates from all three uses."""
    emb_var = dec_out.block.program.global_block().var("nmt.word_emb")
    return layers.matmul(dec_out, emb_var, transpose_y=True)


def build_nmt_train(cfg: NMTConfig, src_len: int, tgt_len: int,
                    is_test=False):
    """Feeds: src_ids [B,Ts], src_mask [B,Ts], tgt_ids [B,Tt] (shifted-in
    targets starting with BOS), tgt_mask [B,Tt], labels [B,Tt,1].
    Returns (loss, feeds) — label-smoothed CE averaged over real target
    tokens (parity: dist_transformer.py's smoothed objective)."""
    from ..core.program import data

    src_ids = data("src_ids", [None, src_len], "int64")
    src_mask = data("src_mask", [None, src_len], "float32")
    tgt_ids = data("tgt_ids", [None, tgt_len], "int64")
    tgt_mask = data("tgt_mask", [None, tgt_len], "float32")
    labels = data("labels", [None, tgt_len, 1], "int64")

    enc_out = nmt_encoder(src_ids, src_mask, cfg, is_test=is_test)
    dec_out = nmt_decoder(tgt_ids, enc_out, src_mask, cfg,
                          is_test=is_test)
    logits = _tied_logits(dec_out, cfg)                  # [B, Tt, V]

    if cfg.label_smooth_eps > 0:
        soft = layers.label_smooth(
            layers.one_hot(layers.squeeze(labels, [2]), cfg.vocab_size),
            epsilon=cfg.label_smooth_eps)
        tok_loss = layers.softmax_with_cross_entropy(
            logits, soft, soft_label=True)               # [B, Tt, 1]
    else:
        tok_loss = layers.softmax_with_cross_entropy(logits, labels)
    tok_loss = layers.elementwise_mul(
        layers.squeeze(tok_loss, [2]), tgt_mask)
    loss = layers.elementwise_div(
        layers.reduce_sum(tok_loss),
        layers.elementwise_max(layers.reduce_sum(tgt_mask), 1.0))
    feeds = {"src_ids": src_ids, "src_mask": src_mask,
             "tgt_ids": tgt_ids, "tgt_mask": tgt_mask, "labels": labels}
    return loss, feeds


def build_nmt_beam_infer(cfg: NMTConfig, src_len: int, batch: int,
                         max_out_len: int, beam_size=4, bos_id=0,
                         end_id=1):
    """Beam-search translation (parity: book/test_machine_translation.py
    decode built from while_op + beam_search + beam_search_decode).

    Dense [B, K] beams; each scan step re-runs the causal decoder over
    the padded token buffer and reads the current position's hidden
    state via a one-hot row (no dynamic-shape ops inside the loop).
    Returns (sentence_ids [T, B, K], sentence_scores [B, K])."""
    from ..core.program import data

    B, K, T = batch, beam_size, max_out_len
    src_ids = data("src_ids", [B, src_len], "int64")
    src_mask = data("src_mask", [B, src_len], "float32")

    enc_out = nmt_encoder(src_ids, src_mask, cfg, is_test=True)
    H = cfg.d_model
    # [B, Ts, H] → [B·K, Ts, H]: every beam of a sentence cross-attends
    # the same encoder states
    enc_bk = layers.reshape(
        layers.expand(layers.unsqueeze(enc_out, [1]), [1, K, 1, 1]),
        [B * K, src_len, H])
    mask_bk = layers.reshape(
        layers.expand(layers.unsqueeze(src_mask, [1]), [1, K, 1]),
        [B * K, src_len])

    # token buffer: [B·K, T] starting as BOS everywhere; position 0 is
    # the real BOS, later positions are overwritten as the beam grows
    # (causal masking makes the not-yet-written tail unobservable)
    tok0 = layers.fill_constant([B * K, T], "int64", float(bos_id))
    sc0 = layers.concat(
        [layers.fill_constant([B, 1], "float32", 0.0),
         layers.fill_constant([B, K - 1], "float32", -1e30)], axis=1)
    prev0 = layers.fill_constant([B * K, 1], "int64", float(bos_id))
    # step t's one-hot row selects hidden state t; row t+1 scatters the
    # new token (clamped at T-1 for the final step)
    eye = np.eye(T, dtype=np.float32)
    sel_rows = layers.assign(eye)                          # [T, T]
    put_rows = layers.assign(
        eye[np.minimum(np.arange(T) + 1, T - 1)])          # [T, T]
    bidx = layers.reshape(
        layers.expand(layers.reshape(
            layers.range(0, B, 1, "int32"), [B, 1, 1]), [1, K, 1]),
        [B, K, 1])

    rnn = layers.StaticRNN()
    with rnn.step():
        sel_row = rnn.step_input(sel_rows)                 # [T]
        put_row = rnn.step_input(put_rows)                 # [T]
        toks = rnn.memory(init=tok0)                       # [B·K, T]
        pre_sc = rnn.memory(init=sc0)                      # [B, K]
        prev_tok = rnn.memory(init=prev0)                  # [B·K, 1]

        dec = nmt_decoder(toks, enc_bk, mask_bk, cfg, is_test=True)
        h_t = layers.reduce_sum(                           # [B·K, H]
            layers.elementwise_mul(
                dec, layers.reshape(sel_row, [1, T, 1])), dim=1)
        emb_var = dec.block.program.global_block().var("nmt.word_emb")
        logits = layers.matmul(h_t, emb_var, transpose_y=True)
        probs = layers.reshape(layers.softmax(logits),
                               [B, K, cfg.vocab_size])
        pre_ids = layers.reshape(prev_tok, [B, K])
        sel_ids, sel_sc, parent = layers.beam_search(
            pre_ids, pre_sc, None, probs, beam_size=K, end_id=end_id,
            is_accumulated=False)
        # re-thread surviving beams' token buffers, then write the new
        # token at the next position
        toks3 = layers.reshape(toks, [B, K, T])
        idx = layers.concat(
            [bidx, layers.unsqueeze(layers.cast(parent, "int32"), [2])],
            axis=2)
        toks_re = layers.reshape(layers.gather_nd(toks3, idx), [B * K, T])
        new_tok = layers.reshape(sel_ids, [B * K, 1])
        put = layers.reshape(put_row, [1, T])
        keep = layers.elementwise_sub(
            layers.fill_constant([1, T], "float32", 1.0), put)
        toks_new = layers.cast(
            layers.elementwise_add(
                layers.elementwise_mul(layers.cast(toks_re, "float32"),
                                       keep),
                layers.elementwise_mul(layers.cast(new_tok, "float32"),
                                       put)),
            "int64")
        rnn.update_memory(toks, toks_new)
        rnn.update_memory(pre_sc, sel_sc)
        rnn.update_memory(prev_tok, new_tok)
        rnn.step_output(sel_ids)
        rnn.step_output(sel_sc)
        rnn.step_output(parent)
    ids_t, scores_t, parents_t = rnn()   # each [T, B, K]
    return layers.beam_search_decode(ids_t, scores_t, parents_t,
                                     beam_size=K, end_id=end_id)


def nmt_tp_sharding_rules():
    """Megatron placement over the `model` axis for both stacks (same
    contract as models.tp_sharding_rules for BERT: the split computes,
    no weight is gathered whole inside a step)."""
    return [
        (r"nmt\..*\.(self|cross)\.qkv\.w$", (None, "model")),
        (r"nmt\..*\.(self|cross)\.qkv\.b$", ("model",)),
        (r"nmt\..*\.cross\.q\.w$", (None, "model")),
        (r"nmt\..*\.cross\.q\.b$", ("model",)),
        (r"nmt\..*\.cross\.kv\.w$", (None, "model")),
        (r"nmt\..*\.cross\.kv\.b$", ("model",)),
        (r"nmt\..*\.(self|cross)\.out\.w$", ("model", None)),
        (r"nmt\..*\.ffn\.in\.w$", (None, "model")),
        (r"nmt\..*\.ffn\.in\.b$", ("model",)),
        (r"nmt\..*\.ffn\.out\.w$", ("model", None)),
        (r"nmt\.word_emb$", ("model", None)),
    ]
