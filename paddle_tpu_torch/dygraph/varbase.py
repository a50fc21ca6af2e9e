"""VarBase: the eager tensor (parity: imperative/layer.h:59 VarBase —
tensor + grad + stop_gradient; pybind imperative.cc bindings).

Counterpart of paddle_tpu/dygraph/varbase.py.  A VarBase holds one
``torch.Tensor``: a leaf (a parameter, a fed value, an op's output written
in place) requires grad exactly when ``stop_gradient`` is False, and an
op's recorded output carries its autograd graph.  Operators and the
common methods dispatch through the op registry (engine.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..core import unique_name
from ..core.types import canonical_dtype

__all__ = ["VarBase", "Parameter"]


def _floating(t) -> bool:
    return t.is_floating_point() or t.is_complex()


def _as_tensor(value, device=None):
    """A tensor for ``value``: a tensor keeps its device (detached: the
    VarBase's graph starts here); anything else goes to ``device`` (the
    guard's when None) as a copy, in numpy's dtype."""
    if torch.is_tensor(value):
        return value.detach()
    if device is None:
        from .base import current_device

        device = current_device()
    return torch.tensor(np.asarray(value), device=device)


class VarBase:
    def __init__(self, value=None, name=None, stop_gradient=True,
                 persistable=False, dtype=None, shape=None):
        from . import engine

        self._stop_gradient = bool(stop_gradient)
        #: the tape generation of the op that produced the value (None: a
        #: leaf); engine.backward reaches only the current generation
        self._gen = None
        if value is not None:
            self._value = _as_tensor(value)
            self._set_requires_grad()
        else:
            self._value = None  # placeholder; filled by an op write
            self._decl_dtype = canonical_dtype(dtype or "float32")
            self._decl_shape = tuple(shape or ())
        self.name = name or unique_name.generate("eager_tmp")
        self.persistable = persistable
        self.grad = None  # torch tensor, accumulated by backward()
        engine.register_var(self)

    # -- the tensor ----------------------------------------------------------
    def _set_requires_grad(self):
        t = self._value
        if t is not None and t.grad_fn is None:
            want = not self._stop_gradient and _floating(t)
            if t.requires_grad != want:
                t.requires_grad_(want)

    def _make_leaf(self, t):
        """Bind ``t`` as a new leaf (the graph behind it is cut)."""
        self._value = t.detach()
        self._gen = None
        self._set_requires_grad()

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        """Overwrite the tensor: a new leaf on the old value's device (or
        the guard's); float64 becomes float32."""
        old = self._value
        t = _as_tensor(v, None if old is None else old.device)
        if old is not None and t.device != old.device:
            t = t.to(old.device)
        if t.dtype == torch.float64:
            t = t.float()
        self._make_leaf(t)

    @property
    def stop_gradient(self):
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag):
        self._stop_gradient = bool(flag)
        t = self._value
        if t is None:
            return
        if self._stop_gradient and t.requires_grad:
            self._make_leaf(t)      # backward passes stop here
        else:
            self._set_requires_grad()

    # -- static-Variable-compatible surface (so layer fns work eagerly) ---
    @property
    def shape(self):
        return list(self._value.shape) if self._value is not None \
            else list(self._decl_shape)

    @property
    def dtype(self) -> str:
        return canonical_dtype(self._value.dtype) \
            if self._value is not None else self._decl_dtype

    @property
    def ndim(self):
        return len(self.shape)

    # reference VarBase API ------------------------------------------------
    def numpy(self):
        return self._value.detach().cpu().numpy()

    def backward(self, retain_graph=False):
        from . import engine

        engine.backward(self, retain_graph=retain_graph)

    def gradient(self):
        return None if self.grad is None else self.grad.cpu().numpy()

    def clear_gradient(self):
        self.grad = None

    def detach(self):
        return VarBase(self._value.detach(), stop_gradient=True)

    def astype(self, dtype):
        from .engine import run_eager_op

        return run_eager_op("cast", {"X": [self]},
                            {"out_dtype": canonical_dtype(dtype)})["Out"][0]

    def item(self):
        return self.numpy().item()

    def __len__(self):
        return self.shape[0] if self.shape else 0

    def __repr__(self):
        sg = "stop_grad" if self.stop_gradient else "grad"
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"dtype={self.dtype}, {sg})\n{self.numpy()!r}")

    # -- method-style layers ----------------------------------------------
    def reshape(self, shape):
        from .engine import run_eager_op

        return run_eager_op("reshape", {"X": [self]},
                            {"shape": list(shape)})["Out"][0]

    def transpose(self, perm):
        from .engine import run_eager_op

        return run_eager_op("transpose", {"X": [self]},
                            {"axis": list(perm)})["Out"][0]

    def mean(self):
        from .engine import run_eager_op

        return run_eager_op("mean", {"X": [self]}, {})["Out"][0]

    def __getitem__(self, idx):
        # torch indexing, recorded through a tiny inline op
        from .engine import run_inline_op

        return run_inline_op(lambda x: x[idx], [self])


class Parameter(VarBase):
    """Trainable eager parameter (parity: dygraph framework.ParamBase)."""

    def __init__(self, value, name=None, trainable=True, regularizer=None,
                 optimize_attr=None):
        super().__init__(value, name=name, stop_gradient=not trainable,
                         persistable=True)
        self.trainable = trainable
        self.regularizer = regularizer
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}


def _binary(op_type, x, y, reverse=False):
    from .engine import run_eager_op

    if not isinstance(y, VarBase):
        t = x.value
        # a Python number is filled on the device (no host copy, which
        # would wait for the device's queue)
        y = VarBase(torch.full((), y, dtype=t.dtype, device=t.device)
                    if isinstance(y, (bool, int, float))
                    else torch.as_tensor(y, dtype=t.dtype, device=t.device))
    a, b = (y, x) if reverse else (x, y)
    return run_eager_op(op_type, {"X": [a], "Y": [b]}, {})["Out"][0]


def _install_operators():
    def make(op_type, reverse=False):
        def impl(self, other):
            return _binary(op_type, self, other, reverse)

        return impl

    VarBase.__add__ = make("elementwise_add")
    VarBase.__radd__ = make("elementwise_add")
    VarBase.__sub__ = make("elementwise_sub")
    VarBase.__rsub__ = make("elementwise_sub", reverse=True)
    VarBase.__mul__ = make("elementwise_mul")
    VarBase.__rmul__ = make("elementwise_mul")
    VarBase.__truediv__ = make("elementwise_div")
    VarBase.__rtruediv__ = make("elementwise_div", reverse=True)
    VarBase.__pow__ = make("elementwise_pow")
    VarBase.__rpow__ = make("elementwise_pow", reverse=True)
    VarBase.__mod__ = make("elementwise_mod")
    VarBase.__lt__ = make("less_than")
    VarBase.__le__ = make("less_equal")
    VarBase.__gt__ = make("greater_than")
    VarBase.__ge__ = make("greater_equal")
    VarBase.__matmul__ = make("matmul")
    VarBase.__neg__ = lambda self: _binary("elementwise_mul", self, -1.0)


_install_operators()
