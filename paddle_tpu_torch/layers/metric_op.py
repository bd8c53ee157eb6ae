"""Metric layers: ``accuracy`` as in ``paddle_tpu/layers/metric_op.py``
(a ``top_k`` op, then ``accuracy``).  ``auc`` waits for the metric ops."""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_indices]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32")
    correct = correct or helper.create_variable_for_type_inference("int32")
    total = total or helper.create_variable_for_type_inference("int32")
    helper.append_op("accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_indices],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def auc(*args, **kwargs):
    raise NotImplementedError(
        "layers.auc (the streaming auc op) is not ported yet (ROADMAP.md "
        "queue 1, item 7: the metric ops)")
