"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` is the reference this package is held
against; this one imports neither it nor ``jax``.  Modules keep the
reference's structure and names (``generation``, ``serving``,
``models``, ``ops``); inside they use PyTorch's idiom: plain functions
on tensors, an explicit ``device``, explicit random state.  Every TPU
kernel on a ported path becomes a kernel written by hand for sm_90a
under ``csrc/``, built with ``nvcc`` at first use (``_cuda``).

Ported so far: the serving path — the chunked paged-KV
``generation.GenerationEngine`` with its ragged paged-attention kernel,
``generation.GenerationBackend`` and ``serving.InferenceServer``.
"""
from ._device import resolve_device, set_strict_fp32

__version__ = "0.1.0"

__all__ = ["resolve_device", "set_strict_fp32", "__version__"]
