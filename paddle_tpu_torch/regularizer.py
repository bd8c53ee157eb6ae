"""Weight-decay regularizers: ``L2Decay`` / ``L1Decay``.

Counterpart of ``paddle_tpu/regularizer.py``.  ``append_regularization_ops``
rewrites each gradient as g' = g + decay(p), emitted as graph ops (role
Backward): L2 a ``scale`` of the parameter by the coefficient, L1 a
``sign`` of it then that ``scale``, and a ``sum`` of the two.  A
parameter's own regularizer (``ParamAttr(regularizer=...)``) takes the
place of the optimizer's.
"""
from __future__ import annotations

from .framework.core import OpRole, default_main_program, unique_name

__all__ = ["L2Decay", "L1Decay", "L2DecayRegularizer",
           "L1DecayRegularizer", "append_regularization_ops"]


class Regularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


def _scaled(block, x, coeff, name, dtype):
    out = block.create_var(name=unique_name(name), dtype=dtype)
    block.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                    attrs={"scale": coeff, "op_role": OpRole.Backward})
    return out


class L2DecayRegularizer(Regularizer):
    """decay = coeff * p."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        return _scaled(block, param, self._coeff, f"{param.name}.l2decay",
                       grad.dtype)


class L1DecayRegularizer(Regularizer):
    """decay = coeff * sign(p)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(name=unique_name(f"{param.name}.sign"),
                                dtype=grad.dtype)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]},
                        attrs={"op_role": OpRole.Backward})
        return _scaled(block, sign, self._coeff, f"{param.name}.l1decay",
                       grad.dtype)


def append_regularization_ops(params_grads, regularization=None):
    out = []
    block = default_main_program().global_block()
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None:
            out.append((p, g))
            continue
        decay = reg(p, g, block)
        new_g = block.create_var(name=unique_name(f"{g.name}.reg"),
                                 dtype=g.dtype)
        block.append_op("sum", inputs={"X": [g, decay]},
                        outputs={"Out": [new_g]},
                        attrs={"op_role": OpRole.Backward})
        out.append((p, new_g))
    return out


L2Decay = L2DecayRegularizer
L1Decay = L1DecayRegularizer
