"""AMP optimizer decorator (counterpart of paddle_tpu/contrib/
mixed_precision/decorator.py; parity: fluid/contrib/mixed_precision/
decorator.py:218 decorate, :27 OptimizerWithMixedPrecision).

bfloat16 is the default compute dtype (float32's exponent range, no loss
scaling); float16 gets the reference's dynamic loss scaling, kept in
persistable variables updated by ops of the step itself."""
from __future__ import annotations

from ...core import unique_name
from ...core.program import default_main_program, default_startup_program
from ...initializer import ConstantInitializer
from ...layers.helper import LayerHelper


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_dtype="bfloat16",
                 init_loss_scaling=2.0 ** 15,
                 use_dynamic_loss_scaling=True,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.5):
        self._optimizer = optimizer
        self._amp_dtype = amp_dtype
        # bf16 has f32 exponent range: scaling is unnecessary noise
        self._use_scaling = (amp_dtype == "float16")
        self._init_loss_scaling = init_loss_scaling if self._use_scaling \
            else 1.0
        self._dynamic = use_dynamic_loss_scaling and self._use_scaling
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scaling = None

    def _persistable(self, key, value, dtype="float32"):
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        name = unique_name.generate(key)
        v = main.create_var(name=name, shape=[], dtype=dtype,
                            persistable=True, stop_gradient=True)
        sv = startup.create_var(name=name, shape=[], dtype=dtype,
                                persistable=True, stop_gradient=True)
        ConstantInitializer(value).append_op(sv, startup)
        return v

    def get_loss_scaling(self):
        return self._loss_scaling

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        program._amp_dtype = self._amp_dtype

        helper = LayerHelper("amp")
        if self._use_scaling:
            self._loss_scaling = self._persistable(
                "loss_scaling", self._init_loss_scaling)
            scaled = helper.create_variable_for_type_inference(loss.dtype)
            helper.append_op(
                type="elementwise_mul",
                inputs={"X": [loss.name], "Y": [self._loss_scaling.name]},
                outputs={"Out": [scaled.name]},
                attrs={"axis": -1},
            )
            bwd_target = scaled
        else:
            bwd_target = loss

        params_grads = self._optimizer.backward(
            bwd_target, startup_program, parameter_list, no_grad_set)

        if self._use_scaling:
            grads = [g for _, g in params_grads]
            found_inf = helper.create_variable_for_type_inference(
                "bool", True)
            unscaled = [
                helper.create_variable_for_type_inference("float32", True)
                for _ in grads
            ]
            helper.append_op(
                type="check_finite_and_unscale",
                inputs={"X": [g.name for g in grads],
                        "Scale": [self._loss_scaling.name]},
                outputs={"Out": [u.name for u in unscaled],
                         "FoundInfinite": [found_inf.name]},
                attrs={},
                infer_shape=False,
            )
            # SelectedRows grads stay sparse: the unscale divides the
            # [n, dim] values elementwise, so the rows association
            # carries over to the fresh Variable (otherwise the sparse
            # optimizer guard would be silently bypassed)
            for (_, g), u in zip(params_grads, unscaled):
                rows = getattr(g, "sparse_rows", None)
                if rows is not None:
                    u.sparse_rows = rows
            params_grads = [(p, u) for (p, _), u in zip(params_grads,
                                                        unscaled)]
            if self._dynamic:
                good = self._persistable("good_steps", 0, "int32")
                bad = self._persistable("bad_steps", 0, "int32")
                helper.append_op(
                    type="update_loss_scaling",
                    inputs={"FoundInfinite": [found_inf.name],
                            "PrevLossScaling": [self._loss_scaling.name],
                            "InGoodSteps": [good.name],
                            "InBadSteps": [bad.name]},
                    outputs={"LossScaling": [self._loss_scaling.name],
                             "OutGoodSteps": [good.name],
                             "OutBadSteps": [bad.name]},
                    attrs={"incr_every_n_steps": self._incr_every,
                           "decr_every_n_nan_or_inf": self._decr_every,
                           "incr_ratio": self._incr_ratio,
                           "decr_ratio": self._decr_ratio},
                    infer_shape=False,
                )

        opt_ops = self._optimizer.apply_gradients(params_grads)
        return opt_ops, params_grads

    def backward(self, *args, **kwargs):
        return self._optimizer.backward(*args, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_dtype="bfloat16", init_loss_scaling=2.0 ** 15,
             use_dynamic_loss_scaling=True, **kwargs):
    return OptimizerWithMixedPrecision(
        optimizer, amp_dtype=amp_dtype, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling, **kwargs)
