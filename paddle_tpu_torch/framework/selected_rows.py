"""SelectedRows: the sparse row-slab gradient value.

Counterpart of ``paddle_tpu/framework/selected_rows.py:25-130`` (the
reference's ``framework/selected_rows.h``): a (rows int64 [K], values
[K, cols...], height) triple, made by ``lookup_table_sparse_grad`` for an
embedding looked up with ``is_sparse=True`` and read by the sparse
branches of the optimizer ops.  K is the number of ids looked up and
stays fixed: a step with sparse gradients keeps its shapes, reads nothing
back to the host, and so captures as one CUDA graph.

Rows may repeat.  ``merge`` sums each unique row's values (the reference's
MergeAdd) through ``ops/cuda/selected_rows.py``: the kernel on the card,
its plain version on the CPU, one sequential sum a row in the order of a
stable sort, the JAX package's bits.  The unique rows come first, in
ascending order; the slots after them carry the sentinel row ``height``
and zeros.  JAX drops a sentinel's scatter with ``mode="drop"``; PyTorch
has no such mode, so here a sentinel never reaches an index: ``to_dense``
copies into one spare row past the table and cuts it off, and the sparse
optimizers write through ``touched``, whose sentinel slots repeat the last
unique row's slot (the same row and the same values, so the same bits are
written twice and no other row is touched).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["SelectedRowsValue", "is_selected_rows", "densify",
           "concat_selected_rows", "touched", "np_reference_dense"]


class SelectedRowsValue:
    """Runtime value of a ``VarType.SELECTED_ROWS`` variable."""

    def __init__(self, rows: torch.Tensor, values: torch.Tensor,
                 height: int):
        self.rows = rows          # int64 [K]; sentinel `height` = empty
        self.values = values      # [K, cols...]
        self.height = int(height)

    # -- the reference's SelectedRows API ------------------------------------
    def to_dense(self) -> torch.Tensor:
        """The dense [height, cols...] tensor, duplicate rows summed (the
        reference's SelectedRows::Get): merge, then copy the unique rows
        into zeros.  A sentinel or out-of-range row lands in a spare row
        past the table, which is cut off."""
        m = self.merge()
        cols = tuple(self.values.shape[1:])
        dense = torch.zeros((self.height + 1,) + cols, dtype=m.values.dtype,
                            device=m.values.device)
        rows = torch.where((m.rows >= 0) & (m.rows < self.height), m.rows,
                           self.height)
        dense.index_copy_(0, rows, m.values)
        return dense[:self.height]

    def merge(self) -> "SelectedRowsValue":
        """MergeAdd: the values of duplicate rows summed, K kept; unique
        rows packed at the front in ascending order, the rest of the slots
        the sentinel `height` with zero values."""
        from ..ops.cuda.selected_rows import merge_rows

        rows, values = merge_rows(self.rows, self.values, self.height)
        return SelectedRowsValue(rows, values, self.height)

    def scale(self, factor) -> "SelectedRowsValue":
        return SelectedRowsValue(self.rows, self.values * factor,
                                 self.height)

    def __add__(self, other):
        """Gradient accumulation: SR + SR concatenates (the consumer
        merges); SR + dense densifies."""
        if is_selected_rows(other):
            return concat_selected_rows([self, other])
        return self.to_dense() + other

    def __radd__(self, other):
        if isinstance(other, (int, float)) and other == 0:
            return self  # the sum() builtin
        return self.to_dense() + other

    def __repr__(self):
        return (f"SelectedRowsValue(K={self.rows.shape[0]}, "
                f"height={self.height}, "
                f"cols={tuple(self.values.shape[1:])})")


def is_selected_rows(v: Any) -> bool:
    return isinstance(v, SelectedRowsValue)


def densify(v: Any):
    """The dense view of a SelectedRows value (fetches, state outputs,
    elementwise operands); any other value as it is."""
    if is_selected_rows(v):
        return v.to_dense()
    return v


def concat_selected_rows(values) -> SelectedRowsValue:
    """The sum of N SelectedRows (gradient accumulation): their
    concatenation, merged by the consumer (the reference's sum_op
    SelectedRows branch)."""
    heights = {v.height for v in values}
    if len(heights) != 1:
        from ..errors import InvalidArgumentError

        raise InvalidArgumentError(
            f"sum over SelectedRows with differing heights {heights}")
    return SelectedRowsValue(torch.cat([v.rows for v in values]),
                             torch.cat([v.values for v in values]),
                             values[0].height)


def touched(merged: SelectedRowsValue):
    """(row index [K], values [K, cols...]) of a merged value for a sparse
    update that gathers rows, updates them and copies them back: the
    unique rows' slots as they are, and each slot after them (a sentinel)
    a repeat of the last unique row's slot.  The repeated slot computes
    the same update from the same inputs, so the copy writes its row the
    same bits twice and no index is out of range.  Nothing is read back to
    the host."""
    rows, values = merged.rows, merged.values
    k = rows.shape[0]
    unique = (rows < merged.height).sum()
    src = torch.minimum(torch.arange(k, device=rows.device),
                        (unique - 1).clamp(min=0))
    return rows[src], values[src]


def np_reference_dense(rows, values, height):
    """Test helper: numpy dense accumulation, in the order of `rows`."""
    out = np.zeros((height,) + values.shape[1:], values.dtype)
    for r, v in zip(rows, values):
        if 0 <= r < height:
            out[r] += v
    return out
