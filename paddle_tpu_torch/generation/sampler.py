"""Token sampling for the generation engine.

Counterpart of paddle_tpu/generation/sampler.py.  `SamplingParams` is
the per-request contract (greedy / temperature / top-k / top-p, stop
conditions); `sample_tokens_folded` is the batched sampler the engine
runs at the end of every fixed-shape step — the per-request knobs arrive
as tensors so one step can mix greedy and nucleus requests.

Randomness is SCHEDULE-INVARIANT: each row draws with
``fold_in(root, fold_word)``, where the fold word packs (request uid,
token position), so a token's draw does not depend on which step of
which schedule produced its logits.  The keys, bits and Gumbel noise are
the JAX engine's bit for bit (generation/_threefry.py), so seeded
sampling gives the same tokens in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.attention import _NEG_INF
from . import _threefry
from ._xla_math import xla_cumsum, xla_softmax

__all__ = ["SamplingParams", "sample_tokens_folded", "fold_data_for",
           "root_key_data", "batch_sampling_arrays", "speculative_accept"]

#: bits reserved for the token position inside a fold word
_POS_BITS = 20


def fold_data_for(uid, pos):
    """uint32 fold word for (request uid, token position) — wraps
    modulo 2**32, deterministically in both packages."""
    return np.uint32((int(uid) << _POS_BITS | int(pos)) & 0xFFFFFFFF)


def root_key_data(seed):
    """Raw threefry2x32 key data for ``seed`` as a host uint32 [2] array
    (``jax.random.PRNGKey(seed)``'s words)."""
    return np.array([(int(seed) >> 32) & 0xFFFFFFFF,
                     int(seed) & 0xFFFFFFFF], np.uint32)


@dataclasses.dataclass
class SamplingParams:
    """Per-request generation knobs.

    temperature == 0 selects greedy argmax (top_k/top_p are ignored);
    otherwise logits are divided by the temperature, truncated to the
    top_k highest (0 = no truncation), then to the smallest nucleus
    with cumulative probability >= top_p, and sampled.
    """

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = None          # stop when this token is produced

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


def _truncate(logits, temperatures, top_ks, top_ps):
    """Temperature scaling + top-k + top-p truncation; rows with
    temperature 0 pass through (their draw is replaced by the argmax).
    Kept sets and kept values equal the JAX sampler's exactly."""
    S, V = logits.shape
    neg = torch.full_like(logits, _NEG_INF)
    safe_t = torch.where(temperatures > 0, temperatures,
                         torch.ones_like(temperatures))
    scaled = logits / safe_t[:, None]

    # top-k: keep values >= the k-th largest (k <= 0 keeps all)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_ks <= 0, torch.full_like(top_ks, V),
                        top_ks).clamp(1, V).long()
    kth = sorted_desc.gather(1, (k_eff - 1)[:, None])
    scaled = torch.where(scaled >= kth, scaled, neg)

    # top-p over the top-k-truncated distribution: keep the smallest
    # prefix of descending-probability tokens whose mass reaches top_p
    # (the top-1 token always survives).  Probabilities and running mass
    # are the reference's to the last bit (_xla_math), so a token on the
    # nucleus boundary falls on the same side in both packages.
    probs = xla_softmax(scaled)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = xla_cumsum(p_desc)
    n_keep = ((csum - p_desc) < top_ps[:, None]).sum(dim=-1).clamp_min(1)
    p_min = p_desc.gather(1, (n_keep - 1)[:, None])
    return torch.where(probs >= p_min, scaled, neg)


def sample_tokens_folded(logits, root_data, fold_data, temperatures,
                         top_ks, top_ps, greedy_only=False):
    """logits [R, V] -> token ids [R] int64.

    ``root_data`` is the raw uint32 [2] root key (int64 tensor),
    ``fold_data`` [R] the rows' fold words, ``temperatures``/``top_ps``
    [R] float32 and ``top_ks`` [R] int32, all on the logits' device.
    ``greedy_only`` skips the sorts and the noise when every row is
    greedy (their results would be discarded)."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if greedy_only:
        return greedy
    scaled = _truncate(logits, temperatures, top_ks, top_ps)
    keys = _threefry.fold_in(root_data.expand(fold_data.shape[0], 2),
                             fold_data)
    drawn = _threefry.categorical(keys, scaled)
    return torch.where(temperatures > 0, drawn, greedy)


def speculative_accept(draft_tokens, model_tokens):
    """Speculative rejection on folded keys: given the K drafted tokens
    of a verify window and the model's own samples at the same (request,
    position) folds, return ``(n_accepted, emitted)``.

    The model's sample at every position is a deterministic function of
    the prefix (its key is a pure function of request uid and position),
    so the rejection rule is exact prefix matching: draft j is accepted
    iff it equals the token the model samples there anyway.  ``emitted``
    is the accepted prefix plus the model's sample at the first mismatch
    — token for token what plain decoding produces, greedy or seeded.

    ``draft_tokens`` [K] are the proposals for positions p+1..p+K;
    ``model_tokens`` [K+1] the model's samples at positions p+1..p+K+1
    (row 0 of the window feeds the committed last token)."""
    drafts = np.asarray(draft_tokens, np.int64).reshape(-1)
    model = np.asarray(model_tokens, np.int64).reshape(-1)
    if model.size != drafts.size + 1:
        raise ValueError(
            f"model_tokens must have len(draft_tokens)+1 samples, got "
            f"{model.size} for {drafts.size} drafts")
    mismatch = drafts != model[:drafts.size]
    n_acc = int(np.argmax(mismatch)) if mismatch.any() else drafts.size
    return n_acc, model[:n_acc + 1].astype(np.int32)


def batch_sampling_arrays(params_list, size):
    """Pack per-request SamplingParams into fixed-size arrays; entries
    beyond len(params_list) are greedy placeholders."""
    temps = np.zeros(size, np.float32)
    tks = np.zeros(size, np.int32)
    tps = np.ones(size, np.float32)
    for i, sp in enumerate(params_list):
        temps[i] = sp.temperature
        tks[i] = sp.top_k
        tps[i] = sp.top_p
    return temps, tks, tps
