"""paddle_tpu_torch.dygraph — imperative (define-by-run) mode (parity:
python/paddle/fluid/dygraph/ + paddle/fluid/imperative/); counterpart of
paddle_tpu/dygraph/.

Eager ops are the same registered op functions the Executor runs,
dispatched immediately on torch tensors, with torch autograd as the tape
(engine.py); ``pt.layers.*`` functions that do not create parameters
work unchanged inside ``dygraph.guard()``.  ``guard()`` runs on the card
(RuntimeError without one); ``guard("cpu")`` on the CPU."""
from .base import (  # noqa: F401
    enabled,
    guard,
    in_dygraph_mode,
    no_grad,
    to_variable,
)
from .checkpoint import load_dygraph, save_dygraph  # noqa: F401
from .engine import reset_tape, seed  # noqa: F401
from .layers import Layer  # noqa: F401
from .nn import (  # noqa: F401
    BatchNorm,
    Conv2D,
    Dropout,
    Embedding,
    GRUUnit,
    LayerNorm,
    Linear,
    Pool2D,
)
from .varbase import Parameter, VarBase  # noqa: F401
from .jit import TracedLayer  # noqa: F401
from .to_static import declarative, to_static  # noqa: F401
from . import parallel  # noqa: F401
from .parallel import DataParallel, prepare_context  # noqa: F401
