"""save_dygraph / load_dygraph (parity: python/paddle/fluid/dygraph/
checkpoint.py — state-dict persistence as .pdparams/.pdopt files).

Counterpart of paddle_tpu/dygraph/checkpoint.py: the same npz files, so
each package reads what the other writes."""
from __future__ import annotations

import os

import numpy as np

__all__ = ["save_dygraph", "load_dygraph"]

_OPT_MARKER = "@opt_marker@"


def save_dygraph(state_dict, model_path):
    """Save a state dict to <model_path>.pdparams, or .pdopt when it came
    from Optimizer.state_dict() (marked with '@opt_marker@')."""
    if not state_dict:
        raise ValueError("state_dict is empty, nothing to save")
    suffix = ".pdopt" if _OPT_MARKER in state_dict else ".pdparams"
    path = model_path + suffix
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v)) for k, v in state_dict.items()}
    tmp = path + ".npz"  # np.savez appends .npz to extension-less names
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_dygraph(model_path):
    """Returns (param_dict, optimizer_dict) — either may be None if the
    corresponding file does not exist (reference contract)."""
    def _load(path):
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    params = _load(model_path + ".pdparams")
    opt = _load(model_path + ".pdopt")
    if params is None and opt is None:
        raise ValueError(
            f"no checkpoint found at {model_path}(.pdparams/.pdopt)")
    return params, opt
