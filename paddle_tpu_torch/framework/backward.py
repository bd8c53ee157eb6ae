"""Static reverse-mode autodiff on the Program IR.

Counterpart of ``paddle_tpu/framework/backward.py``: backward is a
source-to-source IR transform that emits named ``<op>_grad`` ops, so grad
vars are inspectable and the program serialises to the same JSON as the
JAX package's.  The grad ops lower to ``torch.autograd.grad`` over the
forward lowerings (ops/registry.py).

Gradient accumulation: grad ops carry ``__accumulate__``, so several
consumers of one forward var sum into the same ``X@GRAD`` value while
lowering.

Recompute (``checkpoints``) re-emits each segment's forward ops before
its grad ops, as the JAX package does (``_emit_with_recompute``); the
executor pairs each grad op with the re-emitted copy (ops/registry.py
``plan_grads``), so only checkpoints and values read across segments
stay alive from the forward to the backward.

``gradients`` / ``calc_gradient`` differentiate targets with respect to
any inputs, through grad ops too, each pass under a grad suffix of its own
(``@GRAD``, ``@GRAD2``, ...): a grad op that a later pass differentiates
keeps a graph of its own result (ops/registry.py
``_differentiable_grad``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..ops.registry import (build_auto_grad_specs, ensure_grad_op_registered,
                            get_op_def)
from .core import Block, OpRole, Variable, grad_var_name

__all__ = ["append_backward", "gradients", "calc_gradient"]


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
    [(param, grad_var)].  With `checkpoints` (vars or names) the backward
    recomputes each segment between them (``_emit_with_recompute``)."""
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
    emitted: List[Tuple[int, dict]] = []  # (position in fwd_ops, spec)
    helper = GradHelper(block, no_grad)
    for pos in range(len(fwd_ops) - 1, -1, -1):
        op = fwd_ops[pos]
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
            emitted.append((pos, spec))
        for names in op.inputs.values():
            for n in names:
                v = block._find_var_recursive(n)
                if v is not None and not v.stop_gradient and n not in no_grad:
                    grads_available.add(n)
    if checkpoints:
        _emit_with_recompute(block, fwd_ops, emitted, checkpoints)
    else:
        for _, spec in emitted:
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


def _emit_with_recompute(block: Block, fwd_ops, emitted, checkpoints):
    """Segmented backward emission, as the JAX package's (the reference's
    ``_append_backward_ops_with_checkpoints_``): the forward is cut into
    segments at the ops producing the checkpoints, and before each
    segment's grad ops (last segment first) its forward ops are emitted
    again, role Backward and not shape-inferred, carrying the original's
    attrs (``__op_seed__`` too, so a dropout draws the same mask).

    Renaming: a segment's outputs that are neither checkpoints nor
    persistable become ``<name>@RC<k>`` (k the segment), and the
    re-emitted ops and the grad ops (``__fwd_inputs__`` too) read those;
    a checkpoint or persistable output of a re-emitted op goes to a
    discarded ``<name>@RC_DISCARD<n>`` (no second state update);
    ``@GRAD`` names and ``__fwd_outputs__`` stay as they were, since
    cotangents are found by the original outputs' grad names."""
    ckpt_names = [c.name if isinstance(c, Variable) else str(c)
                  for c in checkpoints]
    ckpt_set = set(ckpt_names)

    producer_pos: Dict[str, int] = {}
    for pos, op in enumerate(fwd_ops):
        for n in op.output_arg_names():
            producer_pos.setdefault(n, pos)
    boundaries = sorted({producer_pos[c] for c in ckpt_names
                         if c in producer_pos})
    segments = []  # [start, end] position ranges, inclusive
    start = 0
    for b in boundaries:
        segments.append((start, b))
        start = b + 1
    if start < len(fwd_ops):
        segments.append((start, len(fwd_ops) - 1))

    has_grads = {pos for pos, _ in emitted}

    def rename(names, rmap):
        return [rmap.get(n, n) if "@GRAD" not in n else n for n in names]

    discarded = 0
    for k in range(len(segments) - 1, -1, -1):
        s, e = segments[k]
        seg_ops = fwd_ops[s:e + 1]
        rmap: Dict[str, str] = {}
        for op in seg_ops:
            for n in op.output_arg_names():
                if not n or n in ckpt_set or n in rmap:
                    continue
                v = block._find_var_recursive(n)
                if v is not None and v.persistable:
                    continue
                rmap[n] = f"{n}@RC{k}"
        if not has_grads.intersection(range(s, e + 1)):
            continue  # nothing in this segment needs grads
        for op in seg_ops:
            new_inputs = {slot: rename(ns, rmap)
                          for slot, ns in op.inputs.items()}
            new_outputs = {}
            for slot, ns in op.outputs.items():
                outs = []
                for n in ns:
                    if n in rmap:
                        outs.append(rmap[n])
                    elif n:
                        discarded += 1
                        outs.append(f"{n}@RC_DISCARD{discarded}")
                    else:
                        outs.append(n)
                new_outputs[slot] = outs
            attrs = dict(op.attrs)
            attrs["op_role"] = OpRole.Backward
            block.append_op(op.type, inputs=new_inputs,
                            outputs=new_outputs, attrs=attrs,
                            infer_shape=False)
            for slot, ns in op.outputs.items():
                for n, rn in zip(ns, new_outputs[slot]):
                    if n and rn != n:
                        src = block._find_var_recursive(n)
                        nv = block.create_var(name=rn)
                        if src is not None:
                            nv.shape, nv.dtype = src.shape, src.dtype
                            nv.stop_gradient = src.stop_gradient
        for pos, spec in emitted:
            if not s <= pos <= e:
                continue
            inputs = {slot: rename(ns, rmap)
                      for slot, ns in spec["inputs"].items()}
            attrs = dict(spec["attrs"])
            if "__fwd_inputs__" in attrs:
                attrs["__fwd_inputs__"] = {
                    slot: rename(ns, rmap)
                    for slot, ns in attrs["__fwd_inputs__"].items()}
            block.append_op(spec["type"], inputs=inputs,
                            outputs=spec["outputs"], attrs=attrs)


def _written_names(block: Block) -> Set[str]:
    s: Set[str] = set()
    for op in block.ops:
        s.update(op.output_arg_names())
    return s


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of sum(targets) with respect to `inputs` (a list, None where
    an input gets no grad), as the JAX package's ``gradients``.  It
    differentiates Backward-role ops too, so a pass over the result of an
    earlier one gives higher-order grads; each pass takes the first
    suffix no var of the block ends with yet, so two passes never
    accumulate into each other's grads."""
    from .core import grad_suffix_guard

    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    block = targets[0].block
    suffix = "@GRAD"
    k = 1
    existing = set(block.vars)
    while any(n.endswith(suffix) for n in existing):
        k += 1
        suffix = f"@GRAD{k}"
    with grad_suffix_guard(suffix):
        return _calc_gradient(targets, inputs, target_gradients,
                              no_grad_set)


def _calc_gradient(targets, inputs, target_gradients, no_grad_set):
    block = targets[0].block
    no_grad = _collect_no_grad(block, no_grad_set)
    for i, t in enumerate(targets):
        tg = (target_gradients[i]
              if target_gradients and i < len(target_gradients) else None)
        gname = grad_var_name(t.name)
        if tg is None:
            block.append_op("fill_any_like", inputs={"X": [t.name]},
                            outputs={"Out": [gname]},
                            attrs={"value": 1.0, "dtype": t.dtype,
                                   "op_role": OpRole.Backward})
        else:
            block.append_op("assign", inputs={"X": [tg.name]},
                            outputs={"Out": [gname]},
                            attrs={"op_role": OpRole.Backward})
    # Forward and Backward roles: a later pass differentiates an earlier
    # pass's grad ops (only the optimizer's ops are left out)
    fwd_ops = [op for op in block.ops
               if op.attr("op_role") in (OpRole.Forward,
                                         OpRole.Forward | OpRole.Loss,
                                         OpRole.Backward)]
    grads_available = {t.name for t in targets}
    helper = GradHelper(block, no_grad)
    emitted = []
    for op in reversed(fwd_ops):
        if not any(o in grads_available for o in op.output_arg_names()):
            continue
        opdef = get_op_def(op.type)
        if opdef.grad is None:
            continue
        specs = (opdef.grad(op, block, helper) if callable(opdef.grad)
                 else build_auto_grad_specs(op, block, no_grad))
        for spec in specs:
            spec["attrs"]["op_role"] = OpRole.Backward
            spec["attrs"]["__accumulate__"] = True
            ensure_grad_op_registered(op.type)
            emitted.append(spec)
        for names in op.inputs.values():
            for n in names:
                v = block._find_var_recursive(n)
                if v is not None and not v.stop_gradient and n not in no_grad:
                    grads_available.add(n)
    for spec in emitted:
        block.append_op(spec["type"], inputs=spec["inputs"],
                        outputs=spec["outputs"], attrs=spec["attrs"])
    block.program.bump()
    outs = []
    for x in inputs:
        gname = grad_var_name(x.name)
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs


calc_gradient = gradients
