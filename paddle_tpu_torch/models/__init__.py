"""Models of the port (counterpart of paddle_tpu.models): the BERT
pretraining graphs, the causal LM's graph forms and the tensor
functions the generation engine serves, the vision zoo (LeNet, ResNet,
SE-ResNeXt, MobileNet-v1, VGG), the Transformer NMT with its beam
decoder, the GRU seq2seq (train, greedy and beam decoders) and the
n-gram word2vec."""
from .lenet import lenet
from .mobilenet import mobilenet_v1
from .nmt_transformer import (NMTConfig, build_nmt_beam_infer,
                              build_nmt_train, nmt_tp_sharding_rules)
from .resnet import ResNetConfig, resnet, resnet_cifar10
from .se_resnext import se_resnext
from .seq2seq import (seq2seq_beam_search_infer, seq2seq_greedy_infer,
                      seq2seq_train)
from .transformer import (BertConfig, bert_encoder, bert_pretrain_loss,
                          build_bert_pretrain, build_lm_greedy_infer,
                          build_lm_logits, encoder_layer, lm_embed,
                          lm_forward, lm_layer_finish, lm_layer_qkv,
                          lm_logits, lm_param_names, lm_params_from_numpy,
                          lm_params_from_scope, lm_random_params,
                          tp_sharding_rules)
from .vgg import vgg_bn_drop
from .word2vec import word2vec_ngram

__all__ = ["BertConfig", "encoder_layer", "bert_encoder",
           "bert_pretrain_loss", "build_bert_pretrain", "build_lm_logits",
           "build_lm_greedy_infer", "lm_param_names",
           "lm_params_from_scope", "lm_random_params",
           "lm_params_from_numpy", "lm_embed", "lm_layer_qkv",
           "lm_layer_finish", "lm_logits", "lm_forward",
           "tp_sharding_rules", "lenet", "mobilenet_v1", "resnet",
           "resnet_cifar10", "ResNetConfig", "se_resnext", "vgg_bn_drop",
           "NMTConfig", "build_nmt_train", "build_nmt_beam_infer",
           "nmt_tp_sharding_rules", "seq2seq_train",
           "seq2seq_greedy_infer", "seq2seq_beam_search_infer",
           "word2vec_ngram"]
