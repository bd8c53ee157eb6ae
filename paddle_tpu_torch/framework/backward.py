"""Static reverse-mode autodiff on the Program IR.

Counterpart of ``paddle_tpu/framework/backward.py``: backward is a
source-to-source IR transform that emits named ``<op>_grad`` ops, so grad
vars are inspectable and the program serialises to the same JSON as the
JAX package's.  The grad ops lower to ``torch.autograd.grad`` over the
forward lowerings (ops/registry.py).

Gradient accumulation: grad ops carry ``__accumulate__``, so several
consumers of one forward var sum into the same ``X@GRAD`` value while
lowering.

Recompute (``checkpoints``) and ``gradients`` / ``calc_gradient`` wait for
a later slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple

from ..ops.registry import (build_auto_grad_specs, ensure_grad_op_registered,
                            get_op_def)
from .core import Block, OpRole, Variable, grad_var_name

__all__ = ["append_backward"]


class GradHelper:
    """Context handed to custom grad makers."""

    def __init__(self, block: Block, no_grad_set: Set[str]):
        self.block = block
        self.no_grad_set = no_grad_set


def _collect_no_grad(block: Block, no_grad_set) -> Set[str]:
    s = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient:
            s.add(v.name)
    return s


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence] = None,
                    no_grad_set=None,
                    callbacks=None,
                    checkpoints=None) -> List[Tuple[Variable, Variable]]:
    """Emit backward ops for `loss` into its program; returns
    [(param, grad_var)]."""
    if checkpoints:
        raise NotImplementedError(
            "append_backward(checkpoints=...): recompute is not ported yet")
    block = loss.block.program.global_block()
    program = block.program
    no_grad = _collect_no_grad(block, no_grad_set)

    if loss.shape not in ((), (1,)):
        raise ValueError(f"loss must be scalar, got shape {loss.shape}")

    # 1. loss@GRAD = 1
    loss_grad = grad_var_name(loss.name)
    block.append_op(
        "fill_any_like",
        inputs={"X": [loss.name]},
        outputs={"Out": [loss_grad]},
        attrs={"value": 1.0, "dtype": loss.dtype,
               "op_role": OpRole.Backward | OpRole.Loss})

    # 2. reverse sweep over the forward ops
    fwd_ops = [op for op in block.ops
               if op.attr("op_role", OpRole.Forward) in
               (OpRole.Forward, OpRole.Forward | OpRole.Loss)]
    grads_available: Set[str] = {loss.name}
    specs: List[dict] = []
    helper = GradHelper(block, no_grad)
    for op in reversed(fwd_ops):
        if not any(o in grads_available for o in op.output_arg_names()):
            continue
        opdef = get_op_def(op.type)
        if opdef.grad is None:
            continue
        if callable(opdef.grad):
            op_specs = opdef.grad(op, block, helper)
        else:  # 'auto'
            op_specs = build_auto_grad_specs(op, block, no_grad)
        for spec in op_specs:
            spec["attrs"]["op_role"] = OpRole.Backward
            spec["attrs"]["__accumulate__"] = True
            ensure_grad_op_registered(op.type)
            specs.append(spec)
        for names in op.inputs.values():
            for n in names:
                v = block._find_var_recursive(n)
                if v is not None and not v.stop_gradient and n not in no_grad:
                    grads_available.add(n)
    for spec in specs:
        block.append_op(spec["type"], inputs=spec["inputs"],
                        outputs=spec["outputs"], attrs=spec["attrs"])

    # 3. (param, grad) pairs
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [v for v in block.vars.values()
                  if getattr(v, "is_parameter", False) and v.trainable]
    written = _written_names(block)
    params_grads: List[Tuple[Variable, Variable]] = []
    for p in params:
        gname = grad_var_name(p.name)
        if p.name in no_grad:
            continue
        if block.has_var_local(gname) and gname in written:
            g = block.var(gname)
            g.persistable = False
            params_grads.append((p, g))
    program.bump()
    return params_grads


def _written_names(block: Block) -> Set[str]:
    s: Set[str] = set()
    for op in block.ops:
        s.update(op.output_arg_names())
    return s
