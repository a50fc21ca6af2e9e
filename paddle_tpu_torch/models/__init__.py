"""Models of the port (counterpart of paddle_tpu.models): the BERT
pretraining graphs, the causal LM's graph forms and the tensor
functions the generation engine serves."""
from .transformer import (BertConfig, bert_encoder, bert_pretrain_loss,
                          build_bert_pretrain, build_lm_greedy_infer,
                          build_lm_logits, encoder_layer, lm_embed,
                          lm_forward, lm_layer_finish, lm_layer_qkv,
                          lm_logits, lm_param_names, lm_params_from_numpy,
                          lm_params_from_scope, lm_random_params,
                          tp_sharding_rules)

__all__ = ["BertConfig", "encoder_layer", "bert_encoder",
           "bert_pretrain_loss", "build_bert_pretrain", "build_lm_logits",
           "build_lm_greedy_infer", "lm_param_names",
           "lm_params_from_scope", "lm_random_params",
           "lm_params_from_numpy", "lm_embed", "lm_layer_qkv",
           "lm_layer_finish", "lm_logits", "lm_forward",
           "tp_sharding_rules"]
