"""SelectedRows MergeAdd in one fixed order: the wrapper of
``csrc/selected_rows.cu`` and its plain PyTorch version.

``merge_rows(rows, values, height)`` sums the value-rows of each unique row
of a sparse gradient (K rows, values [K, C]): the unique rows come first
in ascending order, each with its value-rows added one after another in
their order in `rows` (a stable sort keeps it), starting from +0; the
K - U slots after the U unique rows hold the sentinel row `height` and
zeros.  K stays the same, so a step with sparse gradients keeps its
shapes, and nothing is read back to the host.  This is the JAX package's
``SelectedRowsValue.merge`` (a stable sort and a scatter-add, XLA's),
and the kernel gives its bits: one sequential sum a row.

It replaces no TPU kernel.  It exists because PyTorch's scatter-adds add
a row looked up many times in an order that can change from run to run
on the card, and a sparse step must give the same bits every run.

``merge_rows`` launches the kernel for a CUDA tensor (counted in
``.launches``) or raises; for a CPU tensor it takes the plain version
``merge_rows_reference`` (counted in ``.calls``), the same sums in
PyTorch, bit for bit.  Both sort with ``torch.sort(stable=True)``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

_KERNEL = "selected_rows"


def _sorted(rows: torch.Tensor):
    """(sorted rows, their positions in `rows`, the inclusive count of
    segment starts at each sorted position)."""
    sorted_rows, order = torch.sort(rows, stable=True)
    first = torch.ones_like(sorted_rows, dtype=torch.bool)
    first[1:] = sorted_rows[1:] != sorted_rows[:-1]
    return sorted_rows, order, torch.cumsum(first, 0)


def merge_rows_reference(rows: torch.Tensor, values: torch.Tensor,
                         height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the kernel's sums in PyTorch.  The sorted
    positions are taken by their depth in their segment: at depth d every
    segment at least d + 1 long adds its d-th value-row to its sum, so each
    sum is ((0 + v_0) + v_1) + ..., in sorted order.  Counts its calls in
    ``.calls``."""
    merge_rows_reference.calls += 1
    k = rows.shape[0]
    vals = values.reshape(k, -1)
    sorted_rows, order, seg = _sorted(rows)
    seg = seg - 1
    pos = torch.arange(k, device=rows.device)
    starts = torch.zeros(k, dtype=torch.long, device=rows.device)
    starts.scatter_reduce_(0, seg, pos, "amin", include_self=False)
    depth = pos - starts[seg]
    by_depth = torch.argsort(depth, stable=True)
    counts = torch.bincount(depth).tolist() if k else []
    acc = torch.zeros_like(vals)
    v = vals[order]
    at = 0
    for n in counts:
        sl = by_depth[at:at + n]
        acc[seg[sl]] += v[sl]  # unique segments within one depth
        at += n
    unique = int(seg[-1]) + 1 if k else 0
    out_rows = torch.full_like(rows, int(height))
    out_rows[:unique] = sorted_rows[starts[:unique]]
    out_vals = torch.zeros_like(vals)
    out_vals[:unique] = acc[:unique]
    return out_rows, out_vals.reshape(values.shape)


merge_rows_reference.calls = 0


def _lib():
    from .build import load

    lib = load(_KERNEL)
    fn = lib.pt_merge_rows_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def merge_rows(rows: torch.Tensor, values: torch.Tensor,
               height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """MergeAdd of int64 `rows` [K] and float32 `values` [K, ...]: returns
    (merged rows [K], merged values [K, ...]).  A CUDA tensor
    launches the kernel (counted in ``.launches``); a CPU tensor takes the
    plain version.  Raises on another dtype, mismatched K or devices."""
    if rows.dim() != 1 or values.dim() < 1 or \
            values.shape[0] != rows.shape[0]:
        raise ValueError(f"merge_rows: rows [K] and values [K, ...], got "
                         f"{tuple(rows.shape)} and {tuple(values.shape)}")
    if rows.device.type == "cpu" and values.device.type == "cpu":
        return merge_rows_reference(rows, values, height)
    if rows.dtype != torch.int64 or values.dtype != torch.float32 or \
            not rows.is_cuda or values.device != rows.device:
        raise ValueError(f"merge_rows: int64 rows and float32 values on one "
                         f"card, got {rows.dtype} on {rows.device} and "
                         f"{values.dtype} on {values.device}")
    k = rows.shape[0]
    cols = values[0].numel() if k else 0
    out_rows = torch.empty_like(rows)
    out_vals = torch.empty_like(values, memory_format=torch.contiguous_format)
    if k == 0 or cols == 0:
        return out_rows.fill_(int(height)), out_vals.zero_()
    sorted_rows, order, seg = _sorted(rows)
    values = values.contiguous()
    lib = _lib()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.pt_merge_rows_f32(
            sorted_rows.data_ptr(), order.data_ptr(), seg.data_ptr(),
            values.data_ptr(), out_rows.data_ptr(), out_vals.data_ptr(), k,
            cols, int(height), stream)
    if err != 0:
        raise RuntimeError(
            f"selected_rows merge kernel launch failed: "
            f"{lib.pt_cuda_error_string(err).decode()} (cudaError {err})")
    merge_rows.launches += 1
    return out_rows, out_vals


merge_rows.launches = 0


def counters():
    """(owner, attribute) of the counts kept here: the kernel's
    ``.launches`` and the plain version's ``.calls``."""
    return ((merge_rows, "launches"), (merge_rows_reference, "calls"))
