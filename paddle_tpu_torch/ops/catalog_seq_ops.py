"""The SelectedRows utility ops of ``paddle_tpu/ops/catalog_seq_ops.py``
(``:191-216``): ``merge_selected_rows`` (MergeAdd, the reference's
merge_selected_rows_op) and ``get_tensor_from_selected_rows`` (the
values slab).  A dense input passes through both.  The module's other
ops wait for ROADMAP.md queue 1 item 7; ``split_selected_rows`` is
parameter-server work (item 9).
"""
from __future__ import annotations

from ..framework.selected_rows import is_selected_rows
from .registry import in_var, register_op, set_out


def _sr_passthrough_infer(op, block):
    x = in_var(op, block, "X")
    set_out(op, block, "Out", x.shape, x.dtype)


@register_op("merge_selected_rows", infer=_sr_passthrough_infer, grad=None,
             selected_rows=True)
def _merge_selected_rows(ctx, op):
    """Duplicate rows' values summed (framework/selected_rows.py
    ``merge``: the merge kernel on the card)."""
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", x.merge() if is_selected_rows(x) else x)


@register_op("get_tensor_from_selected_rows", infer=_sr_passthrough_infer,
             grad=None, selected_rows=True)
def _get_tensor_from_selected_rows(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", x.values if is_selected_rows(x) else x)
