"""Model builders ported so far: BERT/ERNIE-base (packed flash path) and
the Llama decoder (training and the uncached forward)."""
from .bert import (bert_encoder, build_bert_pretrain,  # noqa
                   build_bert_serving)
from .llama import build_llama_forward, build_llama_train  # noqa
