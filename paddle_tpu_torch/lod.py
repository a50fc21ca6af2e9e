"""Host-side ragged<->padded conversion (parity: the LoD machinery —
framework/lod_tensor.h:104 LoDTensor, python/paddle/fluid/lod_tensor.py
create_lod_tensor).  Ragged data lives on the host as (values, offsets);
the device sees a dense padded batch plus its lengths, the layout every
sequence op of this package takes.

A copy of paddle_tpu/lod.py (numpy only).  ``create_lod_tensor`` takes a
``place`` (a ``Place``, a ``torch.device`` or a device string): given
one, the values come back as a torch tensor there; without one they stay
a numpy array on the host, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "pack_sequences", "pad_sequences", "unpad_sequences",
    "offsets_to_lengths", "lengths_to_offsets", "create_lod_tensor",
    "unpack_nested",
]


def pack_sequences(seqs):
    """list of [Ti, ...] arrays -> (values [sum Ti, ...], offsets [B+1])
    — the LoDTensor layout (lod_tensor.h: values + offset table)."""
    seqs = [np.asarray(s) for s in seqs]
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        offsets[i + 1] = offsets[i] + (len(s) if s.ndim else 1)
    values = np.concatenate(seqs, axis=0) if seqs else np.empty((0,))
    return values, offsets


def pad_sequences(seqs, maxlen=None, pad_value=0.0, dtype=None):
    """list of [Ti, ...] -> (dense [B, T, ...], lengths [B]) for the
    masked sequence ops."""
    seqs = [np.asarray(s) for s in seqs]
    lengths = np.asarray([len(s) for s in seqs], dtype=np.int64)
    t = int(maxlen if maxlen is not None
            else (lengths.max() if len(lengths) else 1))
    t = max(t, 1)
    trailing = seqs[0].shape[1:] if seqs else ()
    dtype = dtype or (seqs[0].dtype if seqs else np.float32)
    dense = np.full((len(seqs), t) + tuple(trailing), pad_value,
                    dtype=dtype)
    for i, s in enumerate(seqs):
        n = min(len(s), t)
        dense[i, :n] = s[:n]
    return dense, np.minimum(lengths, t)


def unpad_sequences(dense, lengths):
    """(dense [B, T, ...], lengths [B]) -> list of [Ti, ...] arrays."""
    dense = np.asarray(dense)
    return [dense[i, : int(n)] for i, n in enumerate(lengths)]


def offsets_to_lengths(offsets):
    offsets = np.asarray(offsets)
    return offsets[1:] - offsets[:-1]


def lengths_to_offsets(lengths):
    lengths = np.asarray(lengths, dtype=np.int64)
    out = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def _place_device(place):
    """A Place, torch.device or device string -> torch.device."""
    import torch

    from ._device import resolve_device

    if hasattr(place, "torch_device"):
        return place.torch_device()
    return resolve_device(torch.device(place))


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """Reference-API shim (fluid.create_lod_tensor, lod_tensor.h:104 —
    the LoD is an offset table PER LEVEL, outermost first: level k's
    lengths count the entries of level k+1, the innermost counts data
    rows).

    One level returns ``(values, offsets)``; N nested levels return
    ``(values, [offsets_outer, ..., offsets_inner])`` with the same
    cross-level validation the reference's CheckLoD performs.  With a
    ``place`` the values are a torch tensor on its device; the offsets
    stay numpy (host-side tables)."""
    values = np.asarray(data)
    levels = [np.asarray(l, dtype=np.int64) for l in recursive_seq_lens]
    if not levels:
        raise ValueError("recursive_seq_lens must have >= 1 level")
    for k in range(len(levels) - 1):
        if int(levels[k].sum()) != len(levels[k + 1]):
            raise ValueError(
                f"LoD level {k} sums to {int(levels[k].sum())} but "
                f"level {k + 1} has {len(levels[k + 1])} entries — "
                f"each outer length must count inner sequences")
    if values.shape[0] != int(levels[-1].sum()):
        raise ValueError("data rows != sum(innermost seq_lens)")
    offs = [lengths_to_offsets(l) for l in levels]
    if place is not None:
        import torch

        values = torch.as_tensor(values, device=_place_device(place))
    return (values, offs[0]) if len(offs) == 1 else (values, offs)


def unpack_nested(values, offsets_list):
    """Inverse of a nested create_lod_tensor: (values,
    [offsets_outer, ..., offsets_inner]) -> nested Python lists of
    innermost arrays (one list nesting per LoD level)."""
    if not isinstance(values, np.ndarray) and hasattr(values, "cpu"):
        values = values.cpu().numpy()
    values = np.asarray(values)
    # single-level offsets may arrive as an ndarray OR a plain python
    # list of ints — distinguish a list of offset TABLES (each itself a
    # sequence) from a single offset table by element type
    if (not isinstance(offsets_list, (list, tuple))
            or (len(offsets_list) > 0
                and np.isscalar(offsets_list[0]))):
        offsets_list = [offsets_list]
    inner = offsets_list[-1]
    seqs = [values[int(inner[i]):int(inner[i + 1])]
            for i in range(len(inner) - 1)]
    for offs in reversed(offsets_list[:-1]):
        seqs = [seqs[int(offs[i]):int(offs[i + 1])]
                for i in range(len(offs) - 1)]
    return seqs
