"""N-gram word2vec of the port (parity: tests/book/test_word2vec.py — 4
context words, shared embedding table, concat → hidden → softmax).

Counterpart of paddle_tpu/models/word2vec.py, copied verbatim."""
from __future__ import annotations

from .. import layers
from ..param_attr import ParamAttr

__all__ = ["word2vec_ngram"]


def word2vec_ngram(words, target, dict_size, embed_size=32,
                   hidden_size=256):
    """words: list of [B, 1] int64 context vars; target: [B, 1] int64."""
    embeds = [
        layers.embedding(
            w, size=[dict_size, embed_size],
            param_attr=ParamAttr(name="shared_w"))
        for w in words
    ]
    concat = layers.concat(embeds, axis=-1)
    concat = layers.reshape(concat, [-1, len(words) * embed_size])
    hidden = layers.fc(concat, hidden_size, act="sigmoid")
    logits = layers.fc(hidden, dict_size)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, target))
    return layers.softmax(logits), loss
