"""Control-flow layers: ``cond``, ``While``, ``while_loop``, ``Switch``,
with ``increment`` and the TensorArray layers re-exported.

Counterpart of ``paddle_tpu/layers/control_flow.py``, building the same
programs (ops, attrs, blocks and vars, JSON-equal): ``cond`` builds one
two-branch ``cond2`` op, ``While`` / ``while_loop`` a ``while`` op over
the carries its body writes, ``Switch`` a chain of ``conditional_block``
ops, each guarded by "this case and no earlier case".  How they run on
the card is ``ops/control_flow_ops.py``'s: the branches are selected on
the device inside the captured step, a loop runs eagerly.  ``Print``
waits for ``debug_ops``' ``print`` (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import contextlib

from ..framework.layer_helper import LayerHelper
from .sequence import (array_length, array_read, array_write,  # noqa
                       create_array)
from .tensor import increment  # noqa

__all__ = ["cond", "While", "Switch", "while_loop", "increment",
           "array_write", "array_read", "array_length"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def cond(pred, true_fn=None, false_fn=None, name=None):
    """The functional two-branch conditional: both branches must return
    matching shapes and dtypes."""
    helper = LayerHelper("cond", name=name)
    main = helper.main_program

    true_blk = main._create_block()
    try:
        true_outs = _as_list(true_fn() if true_fn else None)
    finally:
        main._rollback()

    false_blk = main._create_block()
    try:
        false_outs = _as_list(false_fn() if false_fn else None)
    finally:
        main._rollback()

    if len(true_outs) != len(false_outs):
        raise ValueError(
            f"cond: branch arity mismatch {len(true_outs)} vs "
            f"{len(false_outs)}")
    results = []
    for t, f in zip(true_outs, false_outs):
        if tuple(t.shape) != tuple(f.shape) or t.dtype != f.dtype:
            raise ValueError(
                f"cond: branch output mismatch {t.shape}/{t.dtype} vs "
                f"{f.shape}/{f.dtype}")
        r = main.current_block().create_var(
            name=helper.name + f".out_{len(results)}", shape=t.shape,
            dtype=t.dtype)
        results.append(r)
    main.current_block().append_op(
        "cond2", inputs={"Cond": [pred]},
        outputs={"Out": results},
        attrs={"true_block": true_blk.idx, "false_block": false_blk.idx,
               "true_outs": [v.name for v in true_outs],
               "false_outs": [v.name for v in false_outs]},
        infer_shape=False)
    if not results:
        return None
    return results[0] if len(results) == 1 else results


def outer_writes(sub, parent):
    """The names `sub`'s ops write that `parent` (or a block above it)
    declares, in order."""
    written = []
    for op in sub.ops:
        for n in op.output_arg_names():
            if n and n not in written and \
                    parent._find_var_recursive(n) is not None:
                written.append(n)
    return written


class While:
    """A loop whose body is built in a sub-block; its carries are the
    vars the body writes that exist outside it.

        i = fill_constant([1], 'int64', 0)
        c = layers.less_than(i, n)
        w = While(c)
        with w.block():
            ...
            layers.increment(i)
            layers.assign(layers.less_than(i, n), c)
    """

    def __init__(self, cond, is_test=False, name=None):
        self._cond = cond
        self._helper = LayerHelper("while", name=name)

    @contextlib.contextmanager
    def block(self):
        main = self._helper.main_program
        parent = main.current_block()
        sub = main._create_block()
        try:
            yield
        finally:
            # an exception in the body must not leave the program's block
            # stack on the orphaned sub-block
            main._rollback()
        carries = [parent._find_var_recursive(n)
                   for n in outer_writes(sub, parent)
                   if n != self._cond.name]
        parent.append_op(
            "while",
            inputs={"Condition": [self._cond], "X": carries},
            outputs={"Out": carries},
            attrs={"sub_block": sub.idx}, infer_shape=False)


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """The functional loop: `cond` maps the carries to a bool Variable,
    `body` maps them to new carries."""
    loop_vars = _as_list(loop_vars)
    if not loop_vars:
        raise ValueError("while_loop: loop_vars must be non-empty")
    from .tensor import assign

    pred = cond(*loop_vars)
    w = While(pred, is_test=is_test, name=name)
    with w.block():
        new_vars = _as_list(body(*loop_vars))
        if len(new_vars) != len(loop_vars):
            raise ValueError(
                f"while_loop: body returned {len(new_vars)} vars, "
                f"expected {len(loop_vars)}")
        for old, new in zip(loop_vars, new_vars):
            if new is not old:
                assign(new, old)
        assign(cond(*loop_vars), pred)
    return loop_vars[0] if len(loop_vars) == 1 else list(loop_vars)


class Switch:
    """A chain of cases, the first that holds wins:

        with Switch() as switch:
            with switch.case(cond1): ...assign...
            with switch.default(): ...assign...
    """

    def __init__(self, name=None):
        self._helper = LayerHelper("switch", name=name)
        self._cases = []  # (pred or None, block)

    def __enter__(self):
        return self

    @contextlib.contextmanager
    def case(self, condition):
        main = self._helper.main_program
        blk = main._create_block()
        yield
        main._rollback()
        self._cases.append((condition, blk))

    @contextlib.contextmanager
    def default(self):
        main = self._helper.main_program
        blk = main._create_block()
        yield
        main._rollback()
        self._cases.append((None, blk))

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            return False
        from . import tensor as T

        parent = self._helper.main_program.current_block()
        prev_not = None
        for pred, blk in self._cases:
            outs = [parent._find_var_recursive(n)
                    for n in outer_writes(blk, parent)]
            if pred is None:
                effective = prev_not
                if effective is None:
                    raise ValueError("Switch.default with no prior case")
            else:
                effective = pred if prev_not is None else \
                    T.logical_and(prev_not, pred)
            parent.append_op(
                "conditional_block",
                inputs={"Cond": [effective]},
                outputs={"Out": outs},
                attrs={"sub_block": blk.idx}, infer_shape=False)
            if pred is not None:
                this_not = T.logical_not(pred)
                prev_not = this_not if prev_not is None else \
                    T.logical_and(prev_not, this_not)
        return False


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    raise NotImplementedError(
        "layers.Print builds the print op, which waits for debug_ops "
        "(ROADMAP.md queue 1, item 7)")
