"""Loss layers: ``cross_entropy``, ``softmax_with_cross_entropy``,
``sigmoid_cross_entropy_with_logits`` and ``square_error_cost`` as in
``paddle_tpu/layers/loss.py``."""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits", "square_error_cost"]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log(p[label]) of probabilities `input` (not logits)."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


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


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def square_error_cost(input, label):
    """(input - label) ** 2, elementwise (the ``mse_loss`` op)."""
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("mse_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out
