"""Seq2seq encoder-decoder machine-translation model of the port
(parity: tests/book/test_machine_translation.py — GRU encoder,
attention-free teacher-forced decoder for training, greedy and beam
decoders for inference).

Counterpart of paddle_tpu/models/seq2seq.py, copied close to verbatim
so that both packages build the same program: fixed-length padded
batches (the reference used LoD ragged batches); the decoder is a
StaticRNN, and the greedy decoder carries its own previous prediction as
a loop memory where the reference needed a dynamic while_op + LoD
tensor-array machinery.  The decoder's fcs live in the StaticRNN's
sub-block, which the fusion pass does not plan, and the encoder's
projection has no bias: no path here launches a fused kernel."""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["seq2seq_train", "seq2seq_greedy_infer",
           "seq2seq_beam_search_infer"]


def _encoder(src, src_dict_size, embed_dim, hidden_dim):
    # every parameter is named so the separately-built inference program
    # resolves the SAME trained persistables from the scope (reference
    # convention in book/test_machine_translation.py)
    emb = layers.embedding(src, size=[src_dict_size, embed_dim],
                           param_attr=ParamAttr(name="src_emb"))
    proj = layers.fc(emb, hidden_dim * 3, num_flatten_dims=2,
                     param_attr=ParamAttr(name="enc_proj_w"),
                     bias_attr=False)
    enc = layers.dynamic_gru(proj, size=hidden_dim,
                             param_attr=ParamAttr(name="enc_gru_w"),
                             bias_attr=ParamAttr(name="enc_gru_b"))
    # last timestep as the thought vector [B, H]
    last = layers.slice(enc, axes=[1], starts=[-1], ends=[2 ** 31 - 1])
    return layers.reshape(last, [-1, hidden_dim])


def _decoder_cell(x_t, h_prev, hidden_dim):
    """GRU cell built from layers (shared weights via fixed param names)."""
    gates = layers.fc(layers.concat([x_t, h_prev], axis=1),
                      hidden_dim * 2, act="sigmoid",
                      param_attr=ParamAttr(name="dec_gate_w"),
                      bias_attr=ParamAttr(name="dec_gate_b"))
    u = layers.slice(gates, axes=[1], starts=[0], ends=[hidden_dim])
    r = layers.slice(gates, axes=[1], starts=[hidden_dim],
                     ends=[2 * hidden_dim])
    cand = layers.fc(
        layers.concat([x_t, layers.elementwise_mul(r, h_prev)], axis=1),
        hidden_dim, act="tanh",
        param_attr=ParamAttr(name="dec_cand_w"),
        bias_attr=ParamAttr(name="dec_cand_b"))
    return layers.elementwise_add(
        layers.elementwise_mul(u, h_prev),
        layers.elementwise_mul(layers.scale(u, -1.0, bias=1.0), cand))


def seq2seq_train(src, tgt_in, tgt_out, src_dict_size, tgt_dict_size,
                  embed_dim=32, hidden_dim=32):
    """src [B,S] int64, tgt_in/tgt_out [B,T] int64 (shifted pair).
    Returns (avg_loss, logits[T,B,V])."""
    thought = _encoder(src, src_dict_size, embed_dim, hidden_dim)
    tgt_emb = layers.embedding(tgt_in, size=[tgt_dict_size, embed_dim],
                               param_attr=ParamAttr(name="tgt_emb"))
    # time-major for the StaticRNN: [T, B, E]
    tgt_tm = layers.transpose(tgt_emb, [1, 0, 2])
    rnn = layers.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(tgt_tm)
        h_prev = rnn.memory(init=thought)
        h = _decoder_cell(x_t, h_prev, hidden_dim)
        rnn.update_memory(h_prev, h)
        score = layers.fc(h, tgt_dict_size,
                          param_attr=ParamAttr(name="dec_out_w"),
                          bias_attr=ParamAttr(name="dec_out_b"))
        rnn.step_output(score)
    logits = rnn()  # [T, B, V]
    labels_tm = layers.transpose(tgt_out, [1, 0])  # [T, B]
    loss = layers.mean(layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(labels_tm, axes=[2])))
    return loss, logits


def seq2seq_greedy_infer(src, src_dict_size, tgt_dict_size, max_len,
                         bos_id=0, embed_dim=32, hidden_dim=32):
    """Greedy decoding: the StaticRNN carries (h, prev_token) and feeds
    its own argmax back in.  Returns tokens [T, B, 1]."""
    thought = _encoder(src, src_dict_size, embed_dim, hidden_dim)
    # dummy step input just to set the trip count T = max_len
    ticks = layers.fill_constant([max_len, 1], "float32", 0.0)
    bsz_ref = thought
    prev_init = layers.fill_constant_batch_size_like(
        bsz_ref, [-1, 1], "int64", float(bos_id))
    rnn = layers.StaticRNN()
    with rnn.step():
        _ = rnn.step_input(ticks)
        h_prev = rnn.memory(init=thought)
        prev_tok = rnn.memory(init=prev_init)
        x_t = layers.embedding(prev_tok,
                               size=[tgt_dict_size, embed_dim],
                               param_attr=ParamAttr(name="tgt_emb"))
        x_t = layers.reshape(x_t, [-1, embed_dim])
        h = _decoder_cell(x_t, h_prev, hidden_dim)
        score = layers.fc(h, tgt_dict_size,
                          param_attr=ParamAttr(name="dec_out_w"),
                          bias_attr=ParamAttr(name="dec_out_b"))
        tok = layers.unsqueeze(layers.argmax(score, axis=1), axes=[1])
        tok = layers.cast(tok, "int64")
        rnn.update_memory(h_prev, h)
        rnn.update_memory(prev_tok, tok)
        rnn.step_output(tok)
    return rnn()  # [T, B, 1]


def seq2seq_beam_search_infer(src, src_dict_size, tgt_dict_size, max_len,
                              beam_size=4, bos_id=0, end_id=1,
                              embed_dim=32, hidden_dim=32):
    """Beam-search decoding (parity: the reference decode path in
    book/test_machine_translation.py built from while_op + beam_search +
    beam_search_decode).  Here the StaticRNN carries (h, prev_token,
    accumulated scores) over the DENSE beam axis; each step is one
    beam_search op, and the backtrace is one beam_search_decode at the
    end.

    Returns (sentence_ids [T, B, K], sentence_scores [B, K])."""
    B = src.shape[0]
    if B is None or int(B) < 0:
        raise ValueError(
            "seq2seq_beam_search_infer needs a STATIC batch size: the "
            "dense [B, K] beam axis is baked into the compiled program "
            "(declare src with a concrete batch dim; the greedy decoder "
            "supports dynamic batches)")
    B = int(B)
    K = beam_size
    thought = _encoder(src, src_dict_size, embed_dim, hidden_dim)
    # [B, H] -> [B*K, H]
    h0 = layers.reshape(
        layers.expand(layers.unsqueeze(thought, axes=[1]), [1, K, 1]),
        [B * K, hidden_dim])
    tok0 = layers.fill_constant([B * K, 1], "int64", float(bos_id))
    # dense analog of the initial one-candidate LoD: only beam 0 is live
    sc0 = layers.concat(
        [layers.fill_constant([B, 1], "float32", 0.0),
         layers.fill_constant([B, K - 1], "float32", -1e30)], axis=1)
    ticks = layers.fill_constant([max_len, 1], "float32", 0.0)
    bidx = layers.reshape(
        layers.expand(layers.reshape(
            layers.range(0, B, 1, "int32"), [B, 1, 1]), [1, K, 1]),
        [B, K, 1])

    rnn = layers.StaticRNN()
    with rnn.step():
        _ = rnn.step_input(ticks)
        h_prev = rnn.memory(init=h0)
        prev_tok = rnn.memory(init=tok0)
        pre_sc = rnn.memory(init=sc0)
        x_t = layers.embedding(prev_tok, size=[tgt_dict_size, embed_dim],
                               param_attr=ParamAttr(name="tgt_emb"))
        x_t = layers.reshape(x_t, [-1, embed_dim])
        h = _decoder_cell(x_t, h_prev, hidden_dim)
        score = layers.fc(h, tgt_dict_size,
                          param_attr=ParamAttr(name="dec_out_w"),
                          bias_attr=ParamAttr(name="dec_out_b"))
        probs = layers.reshape(layers.softmax(score),
                               [B, K, tgt_dict_size])
        pre_ids = layers.reshape(prev_tok, [B, K])
        sel_ids, sel_sc, parent = layers.beam_search(
            pre_ids, pre_sc, None, probs, beam_size=K, end_id=end_id,
            is_accumulated=False)
        # re-thread the hidden state of each surviving beam
        h3 = layers.reshape(h, [B, K, hidden_dim])
        idx = layers.concat(
            [bidx, layers.unsqueeze(layers.cast(parent, "int32"),
                                    axes=[2])], axis=2)
        h_sel = layers.reshape(layers.gather_nd(h3, idx),
                               [B * K, hidden_dim])
        rnn.update_memory(h_prev, h_sel)
        rnn.update_memory(prev_tok, layers.reshape(sel_ids, [B * K, 1]))
        rnn.update_memory(pre_sc, sel_sc)
        rnn.step_output(sel_ids)
        rnn.step_output(sel_sc)
        rnn.step_output(parent)
    ids_t, scores_t, parents_t = rnn()   # each [T, B, K]
    return layers.beam_search_decode(ids_t, scores_t, parents_t,
                                     beam_size=K, end_id=end_id)
