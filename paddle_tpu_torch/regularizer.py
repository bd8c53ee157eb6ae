"""Weight-decay regularizers: the seam only.

Counterpart of ``paddle_tpu/regularizer.py``'s
``append_regularization_ops``.  With no regularizer (the flagship's
case) the grads pass through unchanged; ``L2Decay`` / ``L1Decay`` wait for
a later slice and raise.
"""
from __future__ import annotations

__all__ = ["append_regularization_ops"]


def append_regularization_ops(params_grads, regularization=None):
    for p, _ in params_grads:
        if getattr(p, "regularizer", None) or regularization:
            raise NotImplementedError(
                f"regularizer on {p.name!r}: weight decay is not ported yet")
    return list(params_grads)
