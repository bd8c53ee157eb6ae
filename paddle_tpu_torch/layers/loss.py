"""Loss layers: ``softmax_with_cross_entropy`` and ``square_error_cost``
as in ``paddle_tpu/layers/loss.py``."""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = ["softmax_with_cross_entropy", "square_error_cost"]


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def square_error_cost(input, label):
    """(input - label) ** 2, elementwise (the ``mse_loss`` op)."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mse_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out
