"""Control-flow op lowerings: ``increment`` (the LR schedule's step
counter).

Counterpart of ``paddle_tpu/ops/control_flow_ops.py:162``, the
registration of ``increment`` that wins in the JAX package (it is
imported after math_ops there): no grad, ``Out`` aliases ``X``.  The
conditional blocks and loops wait for a later slice.
"""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("increment", infer=lambda op, block: None, grad=None,
             stateful_outputs=("Out",))
def _increment(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", x + torch.tensor(op.attr("step", 1.0),
                                               dtype=x.dtype, device=x.device))
