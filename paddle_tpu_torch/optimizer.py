"""Optimizers of the port: SGD and Adam.

Counterpart of paddle_tpu/optimizer.py (``Optimizer`` :50, ``SGDOptimizer``
:300, ``_AdamLike`` :476, ``AdamOptimizer`` :548; parity:
python/paddle/fluid/optimizer.py).  Like the reference, ``minimize`` =
append_backward + per-parameter optimizer-op insertion; the learning
rate and all accumulators are persistable variables created in both the
main and the startup program, under the same names as in the JAX
package.  Not ported: regularization, gradient clipping, sparse
gradients, dygraph mode and the other optimizers.
"""
from __future__ import annotations

from .core import unique_name
from .core.backward import append_backward
from .core.program import (Variable, default_main_program,
                           default_startup_program)
from .initializer import ConstantInitializer

__all__ = ["Optimizer", "SGDOptimizer", "AdamOptimizer", "SGD", "Adam"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None):
        if regularization is not None or grad_clip is not None:
            raise NotImplementedError(
                "regularization and gradient clipping are not ported to "
                "paddle_tpu_torch")
        self._learning_rate = learning_rate
        self._lr_var = None
        self._accumulators = {}  # (acc_name, param_name) -> Variable

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        name = unique_name.generate("learning_rate")
        self._lr_var = main.create_var(
            name=name, shape=[], dtype="float32", persistable=True,
            stop_gradient=True,
        )
        sv = startup.create_var(name=name, shape=[], dtype="float32",
                                persistable=True, stop_gradient=True)
        ConstantInitializer(float(self._learning_rate)).append_op(sv, startup)

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        v = main.create_var(name=var_name, shape=shape, dtype=dtype,
                            persistable=True, stop_gradient=True)
        sv = startup.create_var(name=var_name, shape=shape, dtype=dtype,
                                persistable=True, stop_gradient=True)
        v.is_optimizer_state = True
        sv.is_optimizer_state = True
        ConstantInitializer(float(fill_value)).append_op(sv, startup)
        self._accumulators[key] = v
        return v

    # -- main entry points -------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        for p, _ in params_grads:
            if getattr(p, "regularizer", None) is not None:
                raise NotImplementedError(
                    f"parameter {p.name} has a regularizer: regularization "
                    f"is not ported to paddle_tpu_torch")
        self._create_global_learning_rate()
        block = default_main_program().global_block()
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]},
            attrs={},
            infer_shape=False,
        )


class AdamOptimizer(Optimizer):
    """Adam (the JAX package's ``_AdamLike`` and ``AdamOptimizer`` in one:
    AdamW, its other subclass, is not ported)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        if lazy_mode:
            raise NotImplementedError(
                "AdamOptimizer(lazy_mode=True) updates only the rows of a "
                "sparse gradient; the port has no sparse gradients yet "
                "(ROADMAP Queue 1 item 3)")
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                    shape=[])
        b2p = self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                    shape=[])
        return block.append_op(
            type="adam",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "LearningRate": [self._lr_var.name],
                    "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False,
        )


SGD = SGDOptimizer
Adam = AdamOptimizer
