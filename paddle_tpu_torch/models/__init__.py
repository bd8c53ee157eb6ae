"""Model builders ported so far: BERT/ERNIE-base (packed flash path),
the Llama decoder (training and the uncached forward) and Wide&Deep
(training and its serving remainder)."""
from .bert import (bert_encoder, build_bert_pretrain,  # noqa
                   build_bert_serving)
from .llama import build_llama_forward, build_llama_train  # noqa
from .wide_deep import wide_deep_net, wide_deep_serving_net  # noqa
