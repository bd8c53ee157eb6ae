"""The fp32 RMSNorm whose rows do not depend on how many rows there are:
the wrapper of ``csrc/rms_norm_f32.cu`` and its plain PyTorch version.

A library reduction splits a row's sum by the number of rows: on the card
a decode step's RMSNorm rows (M = the slots) came out 2.4e-7 from the
same rows of the uncached forward (probe_decode_rows.py), and cached
decode was no longer bit-equal to the uncached forward.  The kernel
fixes the order (one block a row, each thread's strided chain, one fixed
fold), so a row's bits do not depend on the rows beside it.  It replaces
no TPU kernel: the JAX package's ``rms_norm`` is XLA's.

Which norms run it (``routes``): a float32 CUDA input that does not
require grad, with a float32 scale that does not either: every RMSNorm of
the generation programs and of the uncached forward.  A norm autograd
differentiates (training), a bfloat16 one and every CPU one keep the
op's PyTorch formulation (``ops/nn_ops.py`` ``_rms_norm``).

``rms_norm_rows`` launches the kernel for a CUDA tensor (counted in
``.launches``) or raises; for a CPU tensor it takes the plain version
``rms_norm_rows_reference`` (the op's formulation, counted in
``.calls``).  The two agree within a few float32 ulps of each output.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

_KERNEL = "rms_norm_f32"


def routes(x: torch.Tensor, scale: Optional[torch.Tensor]) -> bool:
    """Whether RMSNorm of `x` (last dim) with `scale` runs the kernel:
    float32 CUDA tensors that do not require grad."""
    return (x.is_cuda and x.dtype == torch.float32 and not x.requires_grad
            and (scale is None or (scale.dtype == torch.float32
                                   and not scale.requires_grad)))


def rms_norm_rows_reference(x: torch.Tensor, scale: Optional[torch.Tensor],
                            eps: float) -> torch.Tensor:
    """Plain version: x / sqrt(mean(x * x) + eps) * scale over the last
    dim, as the op computes it.  Counts its calls in ``.calls``."""
    rms_norm_rows_reference.calls += 1
    y = x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return y * scale if scale is not None else y


rms_norm_rows_reference.calls = 0


def _lib():
    from .build import load

    lib = load(_KERNEL)
    fn = lib.pt_rms_norm_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rms_norm_rows(x: torch.Tensor, scale: Optional[torch.Tensor],
                  eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of float32 `x`, times `scale` [n] (or
    None).  A CUDA tensor launches the kernel (counted in ``.launches``;
    non-contiguous operands are read through contiguous copies); a CPU
    tensor takes the plain version.  Raises on another dtype than
    float32, an empty last dim or a scale that is not [n] on x's
    device."""
    if x.device.type == "cpu":
        return rms_norm_rows_reference(x, scale, eps)
    n = x.shape[-1] if x.dim() else 0
    if x.dtype != torch.float32 or n < 1:
        raise ValueError(f"rms_norm_rows: float32 [..., n >= 1], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if scale is not None:
        if (tuple(scale.shape) != (n,) or scale.device != x.device
                or scale.dtype != torch.float32):
            raise ValueError(f"rms_norm_rows: scale must be float32 [{n}] "
                             f"on {x.device}, got {scale.dtype} "
                             f"{tuple(scale.shape)} on {scale.device}")
        scale = scale.contiguous()
    x = x.contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // n
    if rows == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_rms_norm_f32(
            x.data_ptr(), scale.data_ptr() if scale is not None else None,
            out.data_ptr(), rows, n, float(eps), stream)
    if err != 0:
        raise RuntimeError(
            f"rms_norm_f32 kernel launch failed: "
            f"{lib.pt_cuda_error_string(err).decode()} (cudaError {err})")
    rms_norm_rows.launches += 1
    return out


rms_norm_rows.launches = 0


def counters():
    """(owner, attribute) of the counts kept here: the kernel's
    ``.launches`` and the plain version's ``.calls``."""
    return ((rms_norm_rows, "launches"), (rms_norm_rows_reference, "calls"))
