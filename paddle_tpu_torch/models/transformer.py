"""The BERT-shaped causal LM of the generation path, in plain PyTorch.

Counterpart of paddle_tpu/models/transformer.py's pure-jnp ``lm_*``
functions (the graph builders are not ported).  Parameters are the same
flat ``"lm.*"`` dict: ``lm_random_params`` makes the numpy arrays exactly
as the JAX package does, and ``lm_params_from_numpy`` turns either
package's dict into tensors on one device, so both compute with the same
weights.  Layout is the JAX package's: packed heads, ``x [..., H]``,
weights ``[in, out]``.

Numerics follow the reference: layer norm over the feature axis with the
population variance and eps 1e-5, exact-erf GELU, float32 matmuls.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import attention_packed

__all__ = ["BertConfig", "LM_PARAM_SUFFIXES", "lm_param_names",
           "lm_random_params", "lm_params_from_numpy", "lm_embed",
           "lm_layer_qkv", "lm_layer_finish", "lm_logits", "lm_forward"]


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
