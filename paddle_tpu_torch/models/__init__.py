"""Model builders ported so far: BERT/ERNIE-base (packed flash path),
the Llama decoder (training and the uncached forward), Wide&Deep
(training and its serving remainder), LeNet-5, ResNet and the attention
seq2seq (training and beam decode)."""
from .bert import (bert_encoder, build_bert_pretrain,  # noqa
                   build_bert_serving)
from .llama import build_llama_forward, build_llama_train  # noqa
from .wide_deep import wide_deep_net, wide_deep_serving_net  # noqa
from .lenet import build_mnist_train, lenet  # noqa
from .resnet import build_resnet_train, resnet  # noqa
from .seq2seq import build_seq2seq_infer, build_seq2seq_train  # noqa
