"""Optimizers of the port: every dense optimizer of the JAX package.

Counterpart of paddle_tpu/optimizer.py (``Optimizer`` :50, ``SGD`` :300,
``Momentum`` :328, ``LarsMomentum`` :349, ``_AdamLike`` :476, ``Adam``
:548, ``AdamW`` :558, ``Lamb`` :569, ``Adagrad`` :583,
``DecayedAdagrad`` :603, ``Adadelta`` :621, ``RMSProp`` :642, ``Adamax``
:668, ``Ftrl`` :694, ``Dpsgd`` :718; parity:
python/paddle/fluid/optimizer.py).  Like the reference, ``minimize`` =
append_backward + gradient clipping + regularization + per-parameter
optimizer-op insertion, in that order; the learning rate (a constant or
a schedule's Variable) and all accumulators are persistable variables
created in both the main and the startup program, under the same names
as in the JAX package, so checkpoints and ``io.load_params`` cross over.

Not ported yet (ROADMAP.md, Queue 1 item 3): sparse (SelectedRows)
gradients with ``lazy_mode``, dygraph mode (``state_dict`` and
``set_state_dict`` raise, as the JAX package's do in static mode), the
DGC momentum, and the wrappers (Recompute, Pipeline, GradientMerge, EMA,
ModelAverage, Lookahead).
"""
from __future__ import annotations

import numpy as np

from .core import unique_name
from .core.backward import append_backward
from .core.program import (Variable, default_main_program,
                           default_startup_program)
from .initializer import ConstantInitializer

__all__ = ["Optimizer", "RecomputeOptimizer", "SGDOptimizer",
           "MomentumOptimizer",
           "LarsMomentumOptimizer", "AdamOptimizer", "AdamWOptimizer",
           "LambOptimizer", "AdagradOptimizer", "DecayedAdagradOptimizer",
           "AdadeltaOptimizer", "RMSPropOptimizer", "AdamaxOptimizer",
           "FtrlOptimizer", "DpsgdOptimizer", "SGD", "Momentum",
           "LarsMomentum", "Adam", "AdamW", "Lamb", "Adagrad",
           "DecayedAdagrad", "Adadelta", "RMSProp", "Adamax", "Ftrl",
           "Dpsgd"]

_STATE_DICT_STATIC = (
    "Optimizer.state_dict() is dygraph-only; in static mode optimizer "
    "accumulators are persistables in the scope — checkpoint them with "
    "io.save_persistables")


class Optimizer:
    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None, parameter_list=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self.grad_clip = grad_clip
        self._name = name
        self._lr_var = None
        self._accumulators = {}  # (acc_name, param_name) -> Variable
        # dygraph's parameter list: kept for signature parity (the port
        # has no dygraph mode)
        self._parameter_list = parameter_list
        self.type = type(self).__name__.lower()

    def state_dict(self):
        raise RuntimeError(_STATE_DICT_STATIC)

    def set_state_dict(self, state):
        raise RuntimeError(_STATE_DICT_STATIC)

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

    def _global_learning_rate(self):
        return self._lr_var

    @property
    def current_lr(self):
        return self._lr_var

    def set_lr(self, value, scope=None):
        """Overwrite the LR persistable in the scope (the executor puts
        it on the device at the next run)."""
        from .core.scope import global_scope

        (scope or global_scope()).set_var(
            self._lr_var.name, np.asarray(value, dtype=np.float32))

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
        # what the Executor's optimizer_state_bytes gauge sums and what a
        # checkpoint manifest lists as optimizer state
        v.is_optimizer_state = True
        sv.is_optimizer_state = True
        ConstantInitializer(float(fill_value)).append_op(sv, startup)
        self._accumulators[key] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[(name, param.name)]

    def accumulator_specs(self):
        """{var_name: (shape, dtype)} for every accumulator this
        optimizer declared, without touching materialized values."""
        out = {}
        for (_, _), v in self._accumulators.items():
            shape = tuple(v.shape) if v.shape is not None else ()
            out[v.name] = (shape, v.dtype)
        return out

    # -- main entry points -------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        # reference order (optimizer.py:668-671): clip FIRST on the raw
        # grads, then regularization, whose decay term is itself
        # unclipped, then the update ops
        if self.grad_clip is not None:
            params_grads = self.grad_clip.apply(params_grads)
        params_grads = self._append_regularization(params_grads)
        self._create_global_learning_rate()
        block = default_main_program().global_block()
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads

    def _append_regularization(self, params_grads):
        out = []
        for p, g in params_grads:
            reg = p.regularizer or self.regularization
            if reg is not None:
                g = reg.append_regularization_op(p, g)
            out.append((p, g))
        return out

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


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        vel = self._add_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Velocity": [vel.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [vel.name]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
            infer_shape=False,
        )


class LarsMomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        vel = self._add_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Velocity": [vel.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "VelocityOut": [vel.name]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
            infer_shape=False,
        )


class _AdamLike(Optimizer):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _extra_attrs(self):
        return {}

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                    shape=[])
        b2p = self._add_accumulator("beta2_pow", p, fill_value=self._beta2,
                                    shape=[])
        attrs = {"beta1": self._beta1, "beta2": self._beta2,
                 "epsilon": self._epsilon}
        attrs.update(self._extra_attrs())
        return block.append_op(
            type=self.op_type,
            inputs={"Param": [p.name], "Grad": [g.name],
                    "Moment1": [m1.name], "Moment2": [m2.name],
                    "LearningRate": [self._lr_var.name],
                    "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name]},
            outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                     "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
                     "Beta2PowOut": [b2p.name]},
            attrs=attrs,
            infer_shape=False,
        )


class AdamOptimizer(_AdamLike):
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        if lazy_mode:
            raise NotImplementedError(
                "AdamOptimizer(lazy_mode=True) updates only the rows of a "
                "sparse gradient; sparse gradients are not ported to "
                "paddle_tpu_torch yet (ROADMAP.md, Queue 1 item 3: sparse "
                "gradients with sgd_sparse/adam_sparse and lazy_mode)")
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._lazy_mode = lazy_mode


class AdamWOptimizer(_AdamLike):
    op_type = "adamw"

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._weight_decay = weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class LambOptimizer(_AdamLike):
    """LAMB (parity: optimizer.py:2659) — large-batch BERT training."""

    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay

    def _extra_attrs(self):
        return {"weight_decay": self._weight_decay}


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p, fill_value=self._init_acc)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"epsilon": self._epsilon},
            infer_shape=False,
        )


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False,
        )


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ag = self._add_accumulator("avg_squared_grad", p)
        au = self._add_accumulator("avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "AvgSquaredGrad": [ag.name],
                    "AvgSquaredUpdate": [au.name]},
            outputs={"ParamOut": [p.name], "AvgSquaredGradOut": [ag.name],
                     "AvgSquaredUpdateOut": [au.name]},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False,
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        ms = self._add_accumulator("mean_square", p)
        mg = self._add_accumulator("mean_grad", p)
        mom = self._add_accumulator("momentum", p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "MeanSquare": [ms.name], "MeanGrad": [mg.name],
                    "Moment": [mom.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "MeanSquareOut": [ms.name],
                     "MeanGradOut": [mg.name], "MomentOut": [mom.name]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered},
            infer_shape=False,
        )


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._add_accumulator("moment", p)
        inf = self._add_accumulator("inf_norm", p)
        b1p = self._add_accumulator("beta1_pow", p, fill_value=self._beta1,
                                    shape=[])
        return block.append_op(
            type="adamax",
            inputs={"Param": [p.name], "Grad": [g.name], "Moment": [m.name],
                    "InfNorm": [inf.name],
                    "LearningRate": [self._lr_var.name],
                    "Beta1Pow": [b1p.name]},
            outputs={"ParamOut": [p.name], "MomentOut": [m.name],
                     "InfNormOut": [inf.name]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
            infer_shape=False,
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._add_accumulator("squared", p)
        lin = self._add_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "SquaredAccumulator": [sq.name],
                    "LinearAccumulator": [lin.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name], "SquaredAccumOut": [sq.name],
                     "LinearAccumOut": [lin.name]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power},
            infer_shape=False,
        )


class DpsgdOptimizer(Optimizer):
    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p.name], "Grad": [g.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma},
            infer_shape=False,
        )


class RecomputeOptimizer:
    """Activation recomputation (parity: the JAX package's
    RecomputeOptimizer, fluid/optimizer.py:3674) is not ported yet: its
    ``recompute_grad`` op re-traces the forward, which the port's
    lowering does not do."""

    def __init__(self, optimizer):
        raise NotImplementedError(
            "RecomputeOptimizer is not ported to paddle_tpu_torch yet "
            "(ROADMAP.md, Queue 1 item 3: EMA, ModelAverage, Lookahead, "
            "GradientMerge, Recompute, Pipeline and DGC)")


SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Lamb = LambOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Adamax = AdamaxOptimizer
Ftrl = FtrlOptimizer
Dpsgd = DpsgdOptimizer
