"""Layer: the dygraph module system (parity: python/paddle/fluid/dygraph/
layers.py:43 Layer — parameters/sublayers registration, train/eval,
state_dict, hooks).

Counterpart of paddle_tpu/dygraph/layers.py: a parameter starts as zeros
on the guard's device and its initializer's op runs eagerly into it
(engine.EagerBlock), drawing from the eager seed; ``state_dict`` holds
host numpy arrays keyed by parameter name, as in the JAX package, so the
two packages' state dicts carry across."""
from __future__ import annotations

from collections import OrderedDict

import torch

from ..core import unique_name
from ..core.types import runtime_dtype
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr
from . import base
from .engine import EagerBlock
from .varbase import Parameter


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        scope = name_scope or type(self).__name__.lower()
        self._full_name = unique_name.generate(scope)
        self._dtype = dtype
        self._parameters: OrderedDict[str, Parameter] = OrderedDict()
        self._sub_layers: OrderedDict[str, Layer] = OrderedDict()
        self._forward_pre_hooks = OrderedDict()
        self._forward_post_hooks = OrderedDict()
        self.training = True

    def full_name(self):
        return self._full_name

    # -- parameter creation ------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        name = attr.name or unique_name.generate(
            f"{self._full_name}.w")
        init = attr.initializer or default_initializer
        if init is None:
            init = (ConstantInitializer(0.0) if is_bias
                    else XavierInitializer())
        from .base import current_device

        p = Parameter(
            torch.zeros([int(d) for d in shape],
                        dtype=runtime_dtype(dtype or self._dtype),
                        device=current_device()), name=name,
            trainable=attr.trainable, regularizer=attr.regularizer,
            optimize_attr={"learning_rate": attr.learning_rate})
        with base.no_grad():
            init.append_op(p, EagerBlock())
        return p

    # -- registration ------------------------------------------------------
    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__.setdefault("_parameters", OrderedDict())
            self._parameters[name] = value
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", OrderedDict())
            self._sub_layers[name] = value
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        params = self.__dict__.get("_parameters")
        if params is not None and name in params:
            return params[name]
        subs = self.__dict__.get("_sub_layers")
        if subs is not None and name in subs:
            return subs[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    # -- traversal ---------------------------------------------------------
    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.parameters())
        return out

    def named_parameters(self, prefix=""):
        for name, p in self._parameters.items():
            yield (f"{prefix}.{name}" if prefix else name), p
        for sname, sub in self._sub_layers.items():
            sp = f"{prefix}.{sname}" if prefix else sname
            yield from sub.named_parameters(sp)

    def sublayers(self, include_sublayers=True):
        out = []
        for sub in self._sub_layers.values():
            out.append(sub)
            if include_sublayers:
                out.extend(sub.sublayers())
        return out

    # -- modes -------------------------------------------------------------
    def train(self):
        base._set_train_mode(True)
        self.training = True
        for sub in self.sublayers():
            sub.training = True
        return self

    def eval(self):
        base._set_train_mode(False)
        self.training = False
        for sub in self.sublayers():
            sub.training = False
        return self

    # -- hooks (parity: register_forward_pre/post_hook) --------------------
    def register_forward_pre_hook(self, hook):
        key = len(self._forward_pre_hooks)
        self._forward_pre_hooks[key] = hook
        return _HookRemover(self._forward_pre_hooks, key)

    def register_forward_post_hook(self, hook):
        key = len(self._forward_post_hooks)
        self._forward_post_hooks[key] = hook
        return _HookRemover(self._forward_post_hooks, key)

    # -- state -------------------------------------------------------------
    def state_dict(self, include_sublayers=True, prefix=""):
        out = OrderedDict()
        for name, p in self.named_parameters(prefix):
            out[p.name] = p.numpy()
        return out

    def set_state_dict(self, state_dict, include_sublayers=True):
        missing = []
        for _, p in self.named_parameters():
            if p.name in state_dict:
                p.value = state_dict[p.name]
            else:
                missing.append(p.name)
        if missing:
            raise KeyError(f"state_dict missing parameters: {missing}")

    # fluid aliases
    set_dict = set_state_dict
    load_dict = set_state_dict

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- call --------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            result = hook(self, inputs)
            if result is not None:
                inputs = result if isinstance(result, tuple) else (result,)
        out = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            result = hook(self, inputs, out)
            if result is not None:
                out = result
        return out


class _HookRemover:
    def __init__(self, store, key):
        self._store, self._key = store, key

    def remove(self):
        self._store.pop(self._key, None)
