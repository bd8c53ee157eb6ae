"""Control-flow op lowerings: ``increment`` (the LR schedule's step
counter).

Counterpart of ``paddle_tpu/ops/control_flow_ops.py:162``, the
registration of ``increment`` that wins in the JAX package (it is
imported after math_ops there): no grad, ``Out`` aliases ``X`` and is
written into X's storage where the run updates state in place.  The step
is a Python number, not a host tensor, so a captured step copies nothing
from the host.  The conditional blocks and loops wait for a later slice.
"""
from __future__ import annotations

from .registry import register_op


@register_op("increment", infer=lambda op, block: None, grad=None,
             stateful_outputs=("Out",))
def _increment(ctx, op):
    x = ctx.get_input(op, "X")
    step = op.attr("step", 1.0)
    if not (x.is_floating_point() or x.is_complex()):
        step = int(step)  # as a tensor of x's dtype would round it
    ctx.set_state(op, "Out", "X", x + step)
