"""Optimizers of the port: every optimizer and wrapper of the JAX package
but the pipeline.

Counterpart of paddle_tpu/optimizer.py (``Optimizer`` :50, ``SGD`` :300,
``Momentum`` :328, ``LarsMomentum`` :349, ``_AdamLike`` :476, ``Adam``
:548, ``AdamW`` :558, ``Lamb`` :569, ``Adagrad`` :583,
``DecayedAdagrad`` :603, ``Adadelta`` :621, ``RMSProp`` :642, ``Adamax``
:668, ``Ftrl`` :694, ``Dpsgd`` :718, ``DGCMomentum`` :372, ``Recompute``
:737, ``GradientMerge`` :986, ``ExponentialMovingAverage`` :1129,
``ModelAverage`` :1221, ``Lookahead`` :1334; parity:
python/paddle/fluid/optimizer.py).  Like the reference, ``minimize`` =
append_backward + gradient clipping + regularization + per-parameter
optimizer-op insertion, in that order; the learning rate (a constant or
a schedule's Variable) and all accumulators are persistable variables
created in both the main and the startup program, under the same names
as in the JAX package, so checkpoints and ``io.load_params`` cross over.

A SelectedRows gradient (an ``is_sparse`` embedding's) takes the
``sgd_sparse`` / ``adam_sparse`` ops (``Adam(lazy_mode=True)`` updates
only the touched rows); an optimizer with no SelectedRows rule refuses
it, and a regularizer densifies it first (``_densify_sparse_grad``).
``RecomputeOptimizer`` appends one ``recompute_grad`` op in place of
the per-op gradients (core/lowering.py runs the forward in checkpointed
segments).  Not ported: ``PipelineOptimizer`` (it raises: ROADMAP.md,
Queue 1 item 5) and dygraph mode (``state_dict`` and ``set_state_dict``
raise, as the JAX package's do in static mode).
"""
from __future__ import annotations

import numpy as np

from .core import unique_name
from .core.backward import append_backward
from .core.program import (Variable, default_main_program,
                           default_startup_program)
from .initializer import ConstantInitializer

__all__ = ["Optimizer", "RecomputeOptimizer", "SGDOptimizer",
           "MomentumOptimizer", "DGCMomentumOptimizer",
           "LarsMomentumOptimizer", "AdamOptimizer", "AdamWOptimizer",
           "LambOptimizer", "AdagradOptimizer", "DecayedAdagradOptimizer",
           "AdadeltaOptimizer", "RMSPropOptimizer", "AdamaxOptimizer",
           "FtrlOptimizer", "DpsgdOptimizer", "PipelineOptimizer",
           "GradientMergeOptimizer", "ExponentialMovingAverage",
           "ModelAverage", "LookaheadOptimizer", "SGD", "Momentum",
           "DGCMomentum", "LarsMomentum", "Adam", "AdamW", "Lamb",
           "Adagrad", "DecayedAdagrad", "Adadelta", "RMSProp", "Adamax",
           "Ftrl", "Dpsgd", "Recompute", "GradientMerge", "Pipeline",
           "EMA", "Lookahead"]

_STATE_DICT_STATIC = (
    "Optimizer.state_dict() is dygraph-only; in static mode optimizer "
    "accumulators are persistables in the scope — checkpoint them with "
    "io.save_persistables")


def _densify_sparse_grad(param, grad):
    """Scatter a SelectedRows grad into a dense [vocab, dim] tensor so
    regularization can add its (dense) decay term — the reference's sum
    op does the same densification (regularizer.py:42).  Loses the
    sparse-update memory advantage, hence the one-time warning."""
    import warnings

    from .layers.helper import LayerHelper

    if param.name not in _densify_sparse_grad._warned:
        _densify_sparse_grad._warned.add(param.name)
        warnings.warn(
            f"regularization on sparse embedding '{param.name}' densifies "
            f"its SelectedRows gradient to the full {list(param.shape)} "
            f"table (reference semantics); use per-param "
            f"ParamAttr(regularizer=None) to keep the sparse update")
    helper = LayerHelper("sparse_to_dense_grad")
    dense = helper.create_variable_for_type_inference(grad.dtype, True)
    helper.append_op(
        type="sparse_to_dense_grad",
        inputs={"Values": [grad.name], "Rows": [grad.sparse_rows]},
        outputs={"Out": [dense.name]},
        attrs={"shape": [int(d) for d in param.shape]},
        infer_shape=False,
    )
    dense.shape = list(param.shape)
    return dense


_densify_sparse_grad._warned = set()


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

    # optimizers with a SelectedRows update rule (reference parity: only
    # a subset of optimizers accept sparse grads — sgd_op.cc, adam_op.cc)
    _supports_sparse_grad = False

    def apply_gradients(self, params_grads):
        # reference order (optimizer.py:668-671): clip FIRST on the raw
        # grads — clip.py consumes SelectedRows grads directly, merging
        # duplicate rows for norms — then regularization, whose dense
        # decay term densifies any SelectedRows grad it touches
        # (regularizer.py:42 semantics) and is itself unclipped
        if self.grad_clip is not None:
            params_grads = self.grad_clip.apply(params_grads)
        params_grads = self._append_regularization(params_grads)
        sparse = [(p, g) for p, g in params_grads
                  if getattr(g, "sparse_rows", None) is not None]
        if sparse and not self._supports_sparse_grad:
            raise ValueError(
                f"{type(self).__name__} has no SelectedRows update "
                f"rule for sparse embedding gradients "
                f"({sparse[0][0].name}); use SGD or Adam, or build "
                f"the embedding with is_sparse=False")
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
                if getattr(g, "sparse_rows", None) is not None:
                    g = _densify_sparse_grad(p, g)
                g = reg.append_regularization_op(p, g)
            out.append((p, g))
        return out

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    _supports_sparse_grad = True

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        rows = getattr(g, "sparse_rows", None)
        if rows is not None:
            # SelectedRows grad from an is_sparse embedding: scatter-add
            # update, no dense [vocab, dim] gradient (sgd_op.cc parity)
            return block.append_op(
                type="sgd_sparse",
                inputs={"Param": [p.name], "Values": [g.name],
                        "Rows": [rows],
                        "LearningRate": [self._lr_var.name]},
                outputs={"ParamOut": [p.name]},
                attrs={},
                infer_shape=False,
            )
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


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum (parity: fluid/optimizer.py:1011
    DGCMomentumOptimizer — top-k sparsification with momentum correction
    and error feedback (local gradient accumulation), rampup schedule).

    As in the JAX package, the algorithm (top-k + momentum correction +
    error feedback, arXiv:1712.01887) runs on the reduced gradient inside
    the step: numerics parity with centralized DGC, with no compressed
    wire format.  k is selected from the rampup sparsity schedule by an
    index into a static top_k(K_max); the threshold |v| >= the k-th
    largest |v| selects every tie of it, as in the JAX package."""

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        if use_nesterov:
            raise NotImplementedError("DGC with nesterov is not supported")
        self._momentum = float(momentum)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = [float(s) for s in sparsity]
        self._step_var = None

    def _dgc_step_counter(self):
        if self._step_var is not None:
            return self._step_var
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        name = unique_name.generate("@dgc_counter@")
        v = main.create_var(name=name, shape=[], dtype="int64",
                            persistable=True, stop_gradient=True)
        sv = startup.create_var(name=name, shape=[], dtype="int64",
                                persistable=True, stop_gradient=True)
        ConstantInitializer(-1.0).append_op(sv, startup)
        main.append_op(type="increment", inputs={"X": [name]},
                       outputs={"Out": [name]}, attrs={"step": 1.0})
        self._step_var = v
        return v

    def _append_optimize_op(self, block, param_and_grad):
        from .layers import nn, tensor

        p, g = param_and_grad
        numel = int(np.prod(p.shape)) if p.shape else 1
        ks = [max(1, int(round(numel * (1.0 - s)))) for s in self._sparsity]
        k_max = max(ks)
        u = self._add_accumulator("dgc_u", p)
        v = self._add_accumulator("dgc_v", p)
        step = self._dgc_step_counter()
        stepf = tensor.cast(step, "float32")
        active = tensor.cast(stepf >= float(self._rampup_begin), "float32")

        u_new = u * self._momentum + g
        v_new = v + u_new

        if numel <= k_max:  # tiny param: dgc degenerates to dense
            delta = u_new
            tensor.assign(u_new, output=u)
            return block.append_op(
                type="sgd",
                inputs={"Param": [p.name], "Grad": [delta.name],
                        "LearningRate": [self._lr_var.name]},
                outputs={"ParamOut": [p.name]},
                attrs={}, infer_shape=False)

        # sparsity index from the rampup schedule (dynamic but bounded)
        prog = (stepf - float(self._rampup_begin)) \
            * (len(self._sparsity) / float(self._rampup_step))
        sidx = tensor.cast(
            tensor.clip(nn.floor(prog), 0.0, len(self._sparsity) - 1),
            "int32")
        ks_const = tensor.assign(np.asarray(ks, np.int32))
        k_t = tensor.gather(ks_const, sidx)

        absv = nn.abs(v_new)
        flat = tensor.reshape(absv, [numel])
        topv, _ = tensor.topk(flat, k_max)
        thr_idx = tensor.cast(
            tensor.clip(tensor.cast(k_t, "float32") - 1.0, 0.0,
                        k_max - 1), "int32")
        thr = tensor.gather(topv, thr_idx)
        mask = tensor.cast(absv >= thr, "float32")

        delta = (v_new * mask) * active + u_new * (1.0 - active)
        tensor.assign(u_new * (1.0 - mask * active), output=u)
        # error feedback: keep the un-sent residual while DGC is active;
        # during warmup V stays at 0 (v_new == u_new contribution unsent=0)
        tensor.assign((v_new * (1.0 - mask)) * active, output=v)
        return block.append_op(
            type="sgd",
            inputs={"Param": [p.name], "Grad": [delta.name],
                    "LearningRate": [self._lr_var.name]},
            outputs={"ParamOut": [p.name]},
            attrs={}, infer_shape=False)


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
        rows = getattr(g, "sparse_rows", None)
        if rows is not None and self.op_type == "adam":
            # SelectedRows grad → adam_sparse (adam_op.cc SelectedRows
            # branch).  Default lazy_mode=False = reference default:
            # every row's moments decay each step, dense-equivalent
            # numerics.  lazy_mode=True (ctor opt-in) touches only the
            # gradient's rows.
            attrs["lazy_mode"] = bool(getattr(self, "_lazy_mode", False))
            return block.append_op(
                type="adam_sparse",
                inputs={"Param": [p.name], "Values": [g.name],
                        "Rows": [rows],
                        "Moment1": [m1.name], "Moment2": [m2.name],
                        "LearningRate": [self._lr_var.name],
                        "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name]},
                outputs={"ParamOut": [p.name], "Moment1Out": [m1.name],
                         "Moment2Out": [m2.name],
                         "Beta1PowOut": [b1p.name],
                         "Beta2PowOut": [b2p.name]},
                attrs=attrs,
                infer_shape=False,
            )
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
    _supports_sparse_grad = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
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


class RecomputeOptimizer(Optimizer):
    """Activation recomputation / gradient checkpointing (parity:
    fluid/optimizer.py:3674 RecomputeOptimizer + backward.py:618
    _append_backward_ops_with_checkpoints_).

    Same user contract as the reference — wrap an inner optimizer and name
    the activation Variables to keep::

        opt = optimizer.RecomputeOptimizer(optimizer.Adam(1e-4))
        opt._set_checkpoints([layer2_out, layer4_out])
        opt.minimize(loss)

    As in the JAX package, instead of splicing recomputed forward
    segments into the program (the reference clones forward ops between
    checkpoints), the backward is ONE ``recompute_grad`` op: the lowering
    (core/lowering.py) runs the forward before it in segments cut at the
    checkpoints under ``torch.utils.checkpoint``, keeping only the
    segments' boundary values, and the op differentiates the loss — each
    segment's forward runs again inside the backward.
    """

    def __init__(self, optimizer):
        self._inner = optimizer
        self._checkpoints = []
        self.type = "recompute"

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints or [])

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .core.program import GRAD_SUFFIX

        block = loss.block.program.global_block()
        no_grad = {v.name if isinstance(v, Variable) else str(v)
                   for v in (no_grad_set or ())}
        if parameter_list is not None:
            wanted = {p.name if isinstance(p, Variable) else p
                      for p in parameter_list}
            params = [p for p in block.all_parameters()
                      if p.trainable and p.name in wanted]
        else:
            params = [p for p in block.all_parameters() if p.trainable]
        params = [p for p in params if p.name not in no_grad]
        grad_vars = []
        for p in params:
            g = block.create_var(
                name=p.name + GRAD_SUFFIX, shape=p.shape, dtype=p.dtype,
                stop_gradient=True)
            grad_vars.append(g)
        ckpt_names = [
            c.name if isinstance(c, Variable) else str(c)
            for c in self._checkpoints
        ]
        # checkpoints must be produced by TOP-LEVEL ops of this block —
        # names inside control-flow sub-blocks (or typos) would silently
        # disable the save-policy, so fail loudly instead
        top_level_outputs = set()
        for fop in block.ops:
            top_level_outputs.update(fop.output_names())
        missing = [n for n in ckpt_names if n not in top_level_outputs]
        if missing:
            raise ValueError(
                f"Recompute checkpoints {missing} are not outputs of any "
                f"top-level op in the main block (checkpoints inside "
                f"While/StaticRNN/cond sub-blocks are not supported; check "
                f"for typos)")
        block.append_op(
            type="recompute_grad",
            inputs={"Params": [p.name for p in params],
                    "Loss": [loss.name]},
            outputs={"Grad": [g.name for g in grad_vars]},
            attrs={"checkpoints": ckpt_names},
            infer_shape=False,
        )
        return list(zip(params, grad_vars))

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self._inner.apply_gradients(params_grads)
        return opt_ops, params_grads


class PipelineOptimizer(Optimizer):
    """Pipeline-parallel training (parity: fluid/optimizer.py:3374
    PipelineOptimizer and the JAX package's; executed by
    pipeline_trainer.cc + section_worker.cc in the reference).

    Usage::

        opt = optimizer.PipelineOptimizer(
            optimizer.Adam(1e-4),
            cut_list=[emb_out, layer2_out, layer4_out],  # S+1 boundaries
            num_microbatches=4)
        opt.minimize(loss)

    ``cut_list`` gives S+1 boundary variables: everything before the first
    is the preamble (embedding), the S segments between consecutive cuts
    are the pipeline stages, and everything after the last is the head
    (loss).  Run the program through a CompiledProgram whose mesh has a
    ``pipe`` axis of size S to pipeline over ranks (GPipe, one stage per
    rank — parallel/pipeline.py); without one the stages run in sequence
    with the same numerics.  Each stage runs under
    ``torch.utils.checkpoint`` (recomputed in the backward).

    Semantics (microbatching contract, as in the JAX package):
      * The reported/optimized loss is the UNWEIGHTED MEAN of the
        per-microbatch losses.  This equals the full-batch loss when the
        head's normalization is microbatch-invariant (mean-reduced losses,
        or count-normalized losses with equal counts per microbatch).  A
        head that normalizes by a data-dependent count (e.g. MLM valid
        tokens) differs slightly from the unpipelined program when counts
        vary across microbatches.
      * Side inputs consumed by stages/head are split into microbatches
        when their leading dim is the batch, else broadcast; a shared
        tensor whose leading dim coincidentally equals the batch size
        must be named in ``broadcast_inputs``.
      * After minimize, only the loss (plus top-level and persistable
        vars) can be fetched: intermediate activations live inside the
        microbatched schedule.
    """

    def __init__(self, optimizer, cut_list=None, num_microbatches=2,
                 axis_name="pipe", broadcast_inputs=None):
        self._inner = optimizer
        self._cut_list = list(cut_list or [])
        self._num_microbatches = int(num_microbatches)
        self._axis_name = axis_name
        self._broadcast_inputs = [
            v.name if isinstance(v, Variable) else str(v)
            for v in (broadcast_inputs or [])]
        self.type = "pipeline"

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .core.program import GRAD_SUFFIX

        program = loss.block.program
        block = program.global_block()
        no_grad = {v.name if isinstance(v, Variable) else str(v)
                   for v in (no_grad_set or ())}
        if parameter_list is not None:
            wanted = {p.name if isinstance(p, Variable) else p
                      for p in parameter_list}
            params = [p for p in block.all_parameters()
                      if p.trainable and p.name in wanted]
        else:
            params = [p for p in block.all_parameters() if p.trainable]
        params = [p for p in params if p.name not in no_grad]
        param_names = [p.name for p in params]
        cuts = [c.name if isinstance(c, Variable) else str(c)
                for c in self._cut_list]
        if len(cuts) < 2:
            raise ValueError(
                "PipelineOptimizer needs a cut_list of at least 2 boundary "
                "variables (S+1 boundaries for S stages)")

        # move the whole forward into a sub-block; the main block keeps one
        # pipeline_grad op that owns it (mirrors the reference's per-section
        # sub-programs, optimizer.py:3374 _split_program)
        sub = program.create_block(parent_idx=0)
        program.rollback()
        sub.ops = block.ops
        block.ops = []
        for op in sub.ops:
            op.block = sub

        produced = set()
        externals = []
        param_name_set = set(param_names)
        seen_ext = set()
        for op in sub.ops:
            for n in op.input_names():
                if (n not in produced and n not in param_name_set
                        and n not in seen_ext):
                    seen_ext.add(n)
                    externals.append(n)
            produced.update(op.output_names())

        grad_vars = []
        for p in params:
            g = block.create_var(
                name=p.name + GRAD_SUFFIX, shape=p.shape, dtype=p.dtype,
                stop_gradient=True)
            grad_vars.append(g)
        block.append_op(
            type="pipeline_grad",
            inputs={"Params": param_names, "X": externals},
            outputs={"Loss": [loss.name],
                     "Grad": [g.name for g in grad_vars]},
            attrs={"sub_block": sub.idx,
                   "cut_vars": cuts,
                   "num_microbatches": self._num_microbatches,
                   "axis_name": self._axis_name,
                   "broadcast_inputs": self._broadcast_inputs},
            infer_shape=False,
        )
        return list(zip(params, grad_vars))

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self._inner.apply_gradients(params_grads)
        return opt_ops, params_grads


class _DeferredBlock:
    """Records append_op calls so they can be replayed after snapshot ops
    are inserted (lets GradientMerge wrap ANY inner optimizer's update
    without knowing its accumulator layout)."""

    def __init__(self, block):
        self._block = block
        self.calls = []  # (type, inputs, outputs, attrs, kwargs)

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  **kwargs):
        self.calls.append((type, inputs, outputs, attrs, kwargs))
        return None

    def written_names(self):
        names = []
        for _, _, outputs, _, _ in self.calls:
            for ns in (outputs or {}).values():
                names.extend(ns)
        return names

    def flush(self):
        for type_, inputs, outputs, attrs, kwargs in self.calls:
            self._block.append_op(type=type_, inputs=inputs,
                                  outputs=outputs, attrs=attrs, **kwargs)


class GradientMergeOptimizer(Optimizer):
    """Gradient accumulation over k mini-batches (parity:
    framework/ir/multi_batch_merge_pass.cc + the batch-merge dist tests:
    k forward/backwards accumulate, then ONE parameter update).

    As in the JAX package, instead of replicating the forward k times in
    the graph,
    the step runs normally every iteration; gradients add into
    persistable accumulators, and the wrapped optimizer's update is
    applied through mask-blended writes — on non-merge steps every value
    it would write (params AND its own accumulators: moments, beta pows)
    is blended back to its snapshot, so optimizer state advances exactly
    once per k steps, matching true large-batch training.  Supported
    inner optimizers: the plain per-param families (SGD ... Lamb) whose
    update is one _append_optimize_op; wrapper optimizers are rejected
    at construction."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        # inner optimizers whose update is NOT a single
        # _append_optimize_op (wrappers, or ones that write extra state
        # through layer helpers the deferred block cannot intercept);
        # isinstance so subclasses don't slip through
        unsupported = (DGCMomentumOptimizer, RecomputeOptimizer,
                       PipelineOptimizer, GradientMergeOptimizer)
        name = type(inner_optimizer).__name__
        if isinstance(inner_optimizer, unsupported) or not hasattr(
                type(inner_optimizer), "_append_optimize_op") or \
                type(inner_optimizer)._append_optimize_op is \
                Optimizer._append_optimize_op:
            raise ValueError(
                f"GradientMergeOptimizer cannot wrap {name}: it needs an "
                f"inner optimizer whose whole update is one "
                f"_append_optimize_op (plain SGD/Momentum/Adam/... "
                f"family) so every state write can be snapshot-blended")
        self._inner = inner_optimizer
        self._k = max(1, int(k_steps))
        self._avg = bool(avg)
        self.type = "gradient_merge"

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import nn, tensor

        params_grads = self._inner.backward(
            loss, startup_program, parameter_list, no_grad_set)
        block = default_main_program().global_block()
        startup = default_startup_program().global_block()

        # step counter (int64; merge on every k-th step)
        step_name = unique_name.generate("@grad_merge_step@")
        block.create_var(name=step_name, shape=[], dtype="int64",
                         persistable=True, stop_gradient=True)
        sv = startup.create_var(name=step_name, shape=[], dtype="int64",
                                persistable=True, stop_gradient=True)
        ConstantInitializer(-1.0).append_op(sv, startup)
        block.append_op(type="increment", inputs={"X": [step_name]},
                        outputs={"Out": [step_name]}, attrs={"step": 1.0})
        step = block.var(step_name)
        kconst = tensor.fill_constant([], "int64", self._k)
        sync = tensor.cast(
            nn.equal(nn.elementwise_mod(step, kconst),
                     tensor.fill_constant([], "int64", self._k - 1)),
            "float32")

        self._inner._create_global_learning_rate()
        merged = []
        for p, g in params_grads:
            acc_name = unique_name.generate(f"{p.name}_grad_merge")
            acc = block.create_var(name=acc_name, shape=list(p.shape),
                                   dtype=p.dtype, persistable=True,
                                   stop_gradient=True)
            sv = startup.create_var(name=acc_name, shape=list(p.shape),
                                    dtype=p.dtype, persistable=True,
                                    stop_gradient=True)
            ConstantInitializer(0.0).append_op(sv, startup)
            g_sum = acc + g
            g_eff = g_sum * (1.0 / self._k if self._avg else 1.0)
            # reset the accumulator on merge steps
            tensor.assign(g_sum * (1.0 - sync), output=acc)
            merged.append((p, g_eff))

        # reference order: clip first, then regularization
        if self._inner.grad_clip is not None:
            merged = self._inner.grad_clip.apply(merged)
        merged = self._inner._append_regularization(merged)

        for p, g_eff in merged:
            deferred = _DeferredBlock(block)
            self._inner._append_optimize_op(deferred, (p, g_eff))
            written = [n for n in set(deferred.written_names())
                       if block.has_var(n)]
            # snapshot everything the update writes, replay, then blend
            snaps = {}
            for n in written:
                src = block.var(n)
                snap = block.create_var(
                    name=unique_name.generate(f"{n}.premerge"),
                    shape=src.shape, dtype=src.dtype, stop_gradient=True)
                block.append_op(type="assign", inputs={"X": [n]},
                                outputs={"Out": [snap.name]}, attrs={})
                snaps[n] = snap
            deferred.flush()
            for n, snap in snaps.items():
                var = block.var(n)
                blended = var * sync + snap * (1.0 - sync)
                tensor.assign(blended, output=var)
        return [], params_grads


def _trainable_params(program=None):
    block = (program or default_main_program()).global_block()
    return [p for p in block.all_parameters() if p.trainable]


class _ApplyRestore:
    """Shared apply()/restore() machinery for EMA/ModelAverage: swap
    averaged weights into the params for evaluation, then swap back."""

    @staticmethod
    def _mirror(block, var, name=None):
        """Re-declare a persistable var (by name) inside a swap program so
        its ops can read/write the training scope's tensor."""
        return block.create_var(name=name or var.name,
                                shape=list(var.shape), dtype=var.dtype,
                                persistable=True, stop_gradient=True)

    def apply(self, executor, need_restore=True):
        from contextlib import contextmanager

        @contextmanager
        def _ctx():
            executor.run(self._apply_program)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor)

        return _ctx()

    def restore(self, executor):
        executor.run(self._restore_program)


class ExponentialMovingAverage(_ApplyRestore):
    """EMA of all trainable parameters with bias correction (parity:
    fluid/optimizer.py:3126 ExponentialMovingAverage).

    Call AFTER ``optimizer.minimize`` inside the training program guard::

        opt.minimize(loss)
        ema = optimizer.ExponentialMovingAverage(0.999)
        ema.update()
        ...
        with ema.apply(exe):          # params <- ema / (1 - decay^t)
            evaluate()
    """

    def __init__(self, decay=0.999, name=None):
        from .core.program import Program, program_guard

        self._decay = float(decay)
        self._name = name or "ema"
        self._params = _trainable_params()
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        self._ema_vars = {}
        for p in self._params:
            ema_name = f"{p.name}.{self._name}"
            v = main.create_var(name=ema_name, shape=list(p.shape),
                                dtype=p.dtype, persistable=True,
                                stop_gradient=True)
            sv = startup.create_var(name=ema_name, shape=list(p.shape),
                                    dtype=p.dtype, persistable=True,
                                    stop_gradient=True)
            ConstantInitializer(0.0).append_op(sv, startup)
            self._ema_vars[p.name] = v
        # int64 step counter for bias correction (float32 would freeze at
        # 2^24 increments)
        step_name = f"@{self._name}_step@"
        self._step = main.create_var(name=step_name, shape=[],
                                     dtype="int64", persistable=True,
                                     stop_gradient=True)
        sv = startup.create_var(name=step_name, shape=[], dtype="int64",
                                persistable=True, stop_gradient=True)
        ConstantInitializer(0.0).append_op(sv, startup)

        self._apply_program = Program()
        self._restore_program = Program()
        with program_guard(self._apply_program):
            self._build_apply()
        with program_guard(self._restore_program):
            self._build_restore()

    def update(self):
        """Append in-graph EMA update ops (run them with the train step)."""
        from .layers import tensor

        block = default_main_program().global_block()
        block.append_op(type="increment", inputs={"X": [self._step.name]},
                        outputs={"Out": [self._step.name]},
                        attrs={"step": 1.0})
        for p in self._params:
            ema = self._ema_vars[p.name]
            new_ema = ema * self._decay + p * (1.0 - self._decay)
            tensor.assign(new_ema, output=ema)

    def _backup_name(self, p):
        return f"{p.name}.{self._name}_backup"

    def _build_apply(self):
        from .layers import nn, tensor

        block = default_main_program().global_block()
        step = tensor.cast(self._mirror(block, self._step), "float32")
        # debias = 1 - decay^t  (t >= 1 once update() has run)
        import math as _math

        decay_pow = nn.exp(step * _math.log(self._decay))
        for p in self._params:
            param = self._mirror(block, p)
            ema = self._mirror(block, self._ema_vars[p.name])
            backup = self._mirror(block, p, self._backup_name(p))
            tensor.assign(param, output=backup)
            tensor.assign(ema / (1.0 - decay_pow + 1e-12), output=param)

    def _build_restore(self):
        from .layers import tensor

        block = default_main_program().global_block()
        for p in self._params:
            param = self._mirror(block, p)
            backup = self._mirror(block, p, self._backup_name(p))
            tensor.assign(backup, output=param)


class ModelAverage(_ApplyRestore):
    """Windowed parameter averaging for evaluation (parity:
    fluid/optimizer.py:2822 ModelAverage + the average_accumulates op).

    Construct AFTER ``optimizer.minimize`` inside the training program
    guard; accumulation ops are appended immediately (reference behavior).
    """

    _MAX_NUM_ACCUMULATES = 16384.0  # reference kMaxNumAccumulates

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000):
        from .core.program import Program, program_guard

        self._rate = float(average_window_rate)
        self._min_window = float(min_average_window)
        self._max_window = float(max_average_window)
        self._params = _trainable_params()
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()

        def _acc(name, shape, dtype="float32"):
            v = main.create_var(name=name, shape=list(shape), dtype=dtype,
                                persistable=True, stop_gradient=True)
            sv = startup.create_var(name=name, shape=list(shape),
                                    dtype=dtype, persistable=True,
                                    stop_gradient=True)
            ConstantInitializer(0.0).append_op(sv, startup)
            return v

        self._sums = {}
        for p in self._params:
            self._sums[p.name] = tuple(
                _acc(f"{p.name}.avg_sum_{i}", p.shape) for i in (1, 2, 3))
        # int64 counters: float32 would freeze at 2^24 updates
        self._num_accumulates = _acc("@avg_num_accumulates@", [], "int64")
        self._old_num_accumulates = _acc("@avg_old_num_accumulates@", [],
                                         "int64")
        self._num_updates = _acc("@avg_num_updates@", [], "int64")
        self._append_average_accumulate_ops()

        self._apply_program = Program()
        self._restore_program = Program()
        with program_guard(self._apply_program):
            self._build_apply()
        with program_guard(self._restore_program):
            self._build_restore()

    def _append_average_accumulate_ops(self):
        from .layers import nn, tensor

        block = default_main_program().global_block()
        # exact int64 in-place increments; masks computed in float after
        for v in (self._num_updates, self._num_accumulates):
            block.append_op(type="increment", inputs={"X": [v.name]},
                            outputs={"Out": [v.name]}, attrs={"step": 1.0})
        n_upd, n_acc = self._num_updates, self._num_accumulates
        n_updf = tensor.cast(n_upd, "float32")
        n_accf = tensor.cast(n_acc, "float32")
        # roll sum_1 into sum_2 every kMaxNumAccumulates updates
        kmax = tensor.fill_constant([], "int64",
                                    int(self._MAX_NUM_ACCUMULATES))
        zero_i = tensor.fill_constant([], "int64", 0)
        m2 = tensor.cast(
            nn.equal(nn.elementwise_mod(n_upd, kmax), zero_i), "float32")
        window = nn.elementwise_min(
            tensor.fill_constant([], "float32", self._max_window),
            n_updf * self._rate)
        m3 = tensor.cast(n_accf >= window, "float32") * tensor.cast(
            n_accf >= self._min_window, "float32")
        for p in self._params:
            s1, s2, s3 = self._sums[p.name]
            new_s1 = s1 + p
            new_s2 = s2 + new_s1 * m2
            new_s1 = new_s1 * (1.0 - m2)
            new_s3 = (new_s1 + new_s2) * m3 + s3 * (1.0 - m3)
            new_s1 = new_s1 * (1.0 - m3)
            new_s2 = new_s2 * (1.0 - m3)
            tensor.assign(new_s1, output=s1)
            tensor.assign(new_s2, output=s2)
            tensor.assign(new_s3, output=s3)
        old_f = tensor.cast(self._old_num_accumulates, "float32")
        tensor.assign(tensor.cast(n_accf * m3 + old_f * (1.0 - m3), "int64"),
                      output=self._old_num_accumulates)
        tensor.assign(tensor.cast(n_accf * (1.0 - m3), "int64"),
                      output=self._num_accumulates)

    def _build_apply(self):
        from .layers import tensor

        block = default_main_program().global_block()
        n_acc = tensor.cast(self._mirror(block, self._num_accumulates),
                            "float32")
        old_n = tensor.cast(self._mirror(block, self._old_num_accumulates),
                            "float32")
        denom = n_acc + old_n + 1e-12
        for p in self._params:
            param = self._mirror(block, p)
            s1, s2, s3 = (self._mirror(block, s) for s in self._sums[p.name])
            backup = self._mirror(block, p, f"{p.name}.avg_backup")
            tensor.assign(param, output=backup)
            tensor.assign((s1 + s2 + s3) / denom, output=param)

    def _build_restore(self):
        from .layers import tensor

        block = default_main_program().global_block()
        for p in self._params:
            param = self._mirror(block, p)
            backup = self._mirror(block, p, f"{p.name}.avg_backup")
            tensor.assign(backup, output=param)


class LookaheadOptimizer:
    """Lookahead wrapper: every k steps pull slow weights toward fast ones
    and reset fast = slow (parity: fluid/optimizer.py:3969).

    As in the JAX package, the k-step update is in-graph mask arithmetic
    (part of every step), not a separately executed sub-program."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None and 0.0 <= alpha <= 1.0 and k >= 1
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self.type = "lookahead"

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .layers import nn, tensor

        opt_ops, params_grads = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()

        step_name = "@lookahead_step@"
        # int64: a float32 step counter freezes at 2^24 increments
        step = main.create_var(name=step_name, shape=[], dtype="int64",
                               persistable=True, stop_gradient=True)
        sv = startup.create_var(name=step_name, shape=[], dtype="int64",
                                persistable=True, stop_gradient=True)
        ConstantInitializer(0.0).append_op(sv, startup)
        main.append_op(type="increment", inputs={"X": [step_name]},
                       outputs={"Out": [step_name]}, attrs={"step": 1.0})
        sync = tensor.cast(
            nn.equal(
                nn.elementwise_mod(step, tensor.fill_constant(
                    [], "int64", int(self.k))),
                tensor.fill_constant([], "int64", 0)), "float32")
        for p, _ in params_grads:
            slow_name = p.name + "@SLOW"
            slow = main.create_var(name=slow_name, shape=list(p.shape),
                                   dtype=p.dtype, persistable=True,
                                   stop_gradient=True)
            ssv = startup.create_var(name=slow_name, shape=list(p.shape),
                                     dtype=p.dtype, persistable=True,
                                     stop_gradient=True)
            # slow starts equal to the initialized fast param
            startup.append_op(type="assign", inputs={"X": [p.name]},
                              outputs={"Out": [slow_name]}, attrs={})
            del ssv
            new_slow = slow + (p - slow) * self.alpha
            new_slow = new_slow * sync + slow * (1.0 - sync)
            new_fast = new_slow * sync + p * (1.0 - sync)
            tensor.assign(new_slow, output=slow)
            tensor.assign(new_fast, output=p)
        return opt_ops, params_grads


# fluid-style short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
DGCMomentum = DGCMomentumOptimizer
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
Recompute = RecomputeOptimizer
GradientMerge = GradientMergeOptimizer
Pipeline = PipelineOptimizer
EMA = ExponentialMovingAverage
Lookahead = LookaheadOptimizer
