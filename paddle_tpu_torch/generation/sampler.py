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

__all__ = ["SamplingParams", "sample_tokens_folded", "fold_data_for",
           "root_key_data", "batch_sampling_arrays"]

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
    temperature 0 pass through (their draw is replaced by the argmax)."""
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
    # (the top-1 token always survives)
    mx = scaled.max(dim=-1, keepdim=True).values
    unnorm = torch.exp(scaled - mx)
    probs = unnorm / unnorm.sum(dim=-1, keepdim=True)
    p_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(p_desc, dim=-1)
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
