"""Models of the port (counterpart of paddle_tpu.models): the causal LM
the generation engine serves."""
from .transformer import (BertConfig, lm_embed, lm_forward, lm_layer_finish,
                          lm_layer_qkv, lm_logits, lm_param_names,
                          lm_params_from_numpy, lm_random_params)

__all__ = ["BertConfig", "lm_param_names", "lm_random_params",
           "lm_params_from_numpy", "lm_embed", "lm_layer_qkv",
           "lm_layer_finish", "lm_logits", "lm_forward"]
