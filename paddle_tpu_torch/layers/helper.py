"""LayerHelper: the protocol every layer uses to create parameters and
append ops — a copy of paddle_tpu/layers/helper.py (parity:
python/paddle/fluid/layer_helper.py).

A parameter is created in BOTH programs, like the reference:
  * the main program's global block holds the Parameter descriptor;
  * the startup program's global block gets the matching var + its init op,
    so running the startup program materializes weights in the scope.

Inside ``dygraph.guard()`` a layer function runs eagerly instead: its
variables are placeholder VarBases and its ops run at once through
``dygraph.engine.EagerBlock``; a layer that would create parameters
raises, naming the class-style layers of ``paddle_tpu_torch.dygraph.nn``.
"""
from __future__ import annotations

from ..core import unique_name
from ..core.program import (
    default_main_program,
    default_startup_program,
)
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(
            layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @staticmethod
    def _dygraph():
        from ..dygraph import base as dg

        return dg.enabled()

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None):
        if self._dygraph():
            raise RuntimeError(
                f"layers.{self.layer_type} creates parameters and cannot "
                f"be used in dygraph mode; use the class-style layers in "
                f"paddle_tpu_torch.dygraph.nn (Linear, Conv2D, BatchNorm, "
                f"Embedding, ...) instead — reference behavior "
                f"(dygraph/nn.py)")
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        name = attr.name or unique_name.generate(f"{self.name}.w")
        init = attr.initializer or default_initializer
        if init is None:
            init = (ConstantInitializer(0.0) if is_bias
                    else XavierInitializer())
        main_block = self.main_program.global_block()
        param = main_block.create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer,
            optimize_attr={"learning_rate": attr.learning_rate},
        )
        sb = self.startup_program.global_block()
        svar = sb.create_var(name=name, shape=shape, dtype=dtype,
                             persistable=True, stop_gradient=True)
        init.append_op(svar, sb)
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        if self._dygraph():
            from ..dygraph.varbase import VarBase

            return VarBase(None, name=unique_name.generate(
                f"{self.name}.tmp"), dtype=dtype,
                stop_gradient=stop_gradient)
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    def append_op(self, *args, **kwargs):
        if self._dygraph():
            from ..dygraph.engine import EagerBlock

            return EagerBlock().append_op(*args, **kwargs)
        return self.main_program.current_block().append_op(*args, **kwargs)

    def append_activation(self, out_var, act):
        if act is None:
            return out_var
        act_out = self.create_variable_for_type_inference(out_var.dtype)
        self.append_op(
            type=act,
            inputs={"X": [out_var.name]},
            outputs={"Out": [act_out.name]},
            attrs={},
        )
        return act_out

    def input(self, x):
        """Accept Variable or name; return Variable."""
        if isinstance(x, str):
            if self._dygraph():
                from ..dygraph.engine import lookup_var

                return lookup_var(x)
            return self.main_program.current_block().var(x)
        if self._dygraph():
            from ..dygraph.engine import register_var
            from ..dygraph.varbase import VarBase

            if isinstance(x, VarBase):
                register_var(x)   # its name resolves to this very VarBase
        return x
