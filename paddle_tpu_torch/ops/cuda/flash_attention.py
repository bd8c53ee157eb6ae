"""Flash attention: the Hopper kernels' wrappers and their plain PyTorch
versions, for the packed-QKV layout and the unpacked [B, H, S, D] one.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``.  One
stride-generic CUDA source serves each direction of both layouts
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``), with
one C entry, one wrapper and one launch counter per TPU kernel.

Packed path (the ``flash_attention_qkv`` op):

* forward, ``flash_attention_packed``: CUDA kernels of
  ``csrc/flash_attention_fwd.cu`` (replace ``_fp_fwd_kernel``);
  plain version ``flash_attention_packed_reference``, built on
  ``blockwise_attention``, a pure-PyTorch port of the JAX package's
  online-softmax scan;
* backward, ``flash_attention_packed_backward``: delta = rowsum(dO * O)
  in PyTorch (the JAX package also computes it outside its kernels), then
  the CUDA kernels of ``csrc/flash_attention_bwd.cu``:
  ``flash_attention_packed_dkv`` (replaces ``_fp_dkv_kernel``) and
  ``flash_attention_packed_dq`` (replaces ``_fp_dq_kernel``), which write
  dq, dk and dv straight into the three column blocks of one [B, S, 3H]
  gradient; plain version ``flash_attention_packed_backward_reference``;
* ``flash_attention_packed_autograd``: a ``torch.autograd.Function``
  whose forward is the forward kernel and whose backward is the two
  backward kernels (the JAX package's ``jax.custom_vjp``).

Unpacked path (the ``flash_attention`` op), q [B, H, Sq, D] and k, v
[B, H, Sk, D], each read through its own strides (the last dim
contiguous), so the [B, H, S, D] views that ``transpose2`` and ``rope``
leave are read in place:

* forward, ``flash_attention_unpacked`` (replaces ``_fa_fwd_kernel``);
  plain version ``flash_attention_reference``;
* backward, ``flash_attention_unpacked_backward``: delta in PyTorch, then
  ``flash_attention_unpacked_dkv`` (replaces ``_fa_dkv_kernel``) and
  ``flash_attention_unpacked_dq`` (replaces ``_fa_dq_kernel``); plain
  version ``flash_attention_backward_reference``;
* ``flash_attention_autograd``: the ``torch.autograd.Function``
  differentiable in q, k, v and bias.

Each source picks its kernel by dtype: bfloat16 runs the tensor-core
kernels (wgmma, with TMA loads), float32 the CUDA-core kernels (exact
fp32 FMAs).  Every kernel reads its operands in 16-byte pieces (TMA in
bfloat16, cp.async in float32), which need 16-byte-aligned addresses and
byte strides.  An operand that is not aligned (``tma_aligned``) is copied
to fresh contiguous memory first, and each such copy is counted in the
launching wrapper's ``.realigned``, which stays 0 on the model paths.

A wrapper takes its plain version only for a tensor on the CPU; on a
CUDA tensor it launches its kernel (counted in ``.launches``) or raises,
never falling back.  The plain versions count their calls (``.calls``)
and are the kernels' oracles in the tests and in ``chip_smoke.py``.

Packed layouts: qkv [B, S, 3H] with q, k, v as column blocks; bias
[B, S] additive, broadcast over heads and queries; out and dout [B, S, H]
heads merged; lse and delta [B, num_heads, S] float32 (the TPU kernels'
[B, H/128, 128/D, S] is this array reshaped).  Unpacked: bias [B, Sk],
lse and delta [B, H, Sq] float32, as the TPU kernels lay them out.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK_K = 512
NEG_INF = -1e30

_KERNEL = "flash_attention_fwd"
_BWD_KERNEL = "flash_attention_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _fit_block(block, size):
    b = min(block, size)
    while size % b:
        b //= 2
    return b


def blockwise_attention(q, k, v, causal=False, sm_scale=None,
                        block_k=DEFAULT_BLOCK_K, kv_offset=0, bias=None):
    """Online-softmax attention, looping over kv blocks.

    q: [B, H, Sq, D], k/v: [B, H, Sk, D]; bias: optional [B, Sk] additive
    score bias, broadcast over heads and q.  Returns (out, (m, l)): out
    [B, H, Sq, D] in q's dtype, m/l the float32 running max and sum
    [B, H, Sq].
    """
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    bk = _fit_block(block_k, Sk)
    qf = q.float() * scale
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    zero = qf.new_zeros(())
    for j in range(Sk // bk):
        kb = k[:, :, j * bk:(j + 1) * bk].float()
        vb = v[:, :, j * bk:(j + 1) * bk].float()
        s = torch.matmul(qf, kb.transpose(-1, -2))       # [B,H,Sq,bk]
        if bias is not None:
            s = s + bias[:, None, None, j * bk:(j + 1) * bk].float()
        if causal:
            k_pos = (j * bk + torch.arange(bk, device=q.device)[None, :]
                     + kv_offset)
            s = torch.where(q_pos >= k_pos, s, qf.new_full((), NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        # a fully-masked block/row keeps m at NEG_INF: exp(0)=1 must not
        # leak in
        p = torch.where(s <= NEG_INF / 2, zero, torch.exp(s - m_new[..., None]))
        corr = torch.where(m <= NEG_INF / 2, zero, torch.exp(m - m_new))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype), (m, l)


def _split_heads(qkv, num_heads):
    B, S, threeH = qkv.shape
    H = threeH // 3
    if threeH != 3 * H or H % num_heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [B, S, 3H] with H "
                         f"divisible by num_heads={num_heads}")
    return B, S, H, H // num_heads


def flash_attention_packed_reference(qkv: torch.Tensor,
                                     bias: Optional[torch.Tensor],
                                     num_heads: int, causal: bool = False,
                                     sm_scale: Optional[float] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (out [B,S,H] in qkv's dtype,
    lse [B,num_heads,S] float32).  Counts its calls in ``.calls``."""
    flash_attention_packed_reference.calls += 1
    B, S, H, D = _split_heads(qkv, num_heads)
    x = qkv.reshape(B, S, 3, num_heads, D)
    q = x[:, :, 0].transpose(1, 2)                       # [B,h,S,D]
    k = x[:, :, 1].transpose(1, 2)
    v = x[:, :, 2].transpose(1, 2)
    o, (m, l) = blockwise_attention(q, k, v, causal=causal,
                                    sm_scale=sm_scale, bias=bias)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    out = o.transpose(1, 2).reshape(B, S, H).to(qkv.dtype)
    return out, lse


flash_attention_packed_reference.calls = 0


def _backward_math(q, k, v, bias, o, lse, do, causal, scale):
    """The backward kernels' math in float32 on the full [B, h, Sq, Sk]
    score matrix, from float32 q, o, do [B,h,Sq,D], k, v [B,h,Sk,D] and
    lse [B,h,Sq]: (dq, dk, dv, dS).  p = exp(s - lse) is 0 where the
    score is masked (causal: q_pos >= k_pos live) and in a row with no
    live key (lse = -inf)."""
    delta = (do * o).sum(-1)                                  # [B,h,Sq]
    qs = q * scale
    s = torch.matmul(qs, k.transpose(-1, -2))                 # [B,h,Sq,Sk]
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    live = torch.isfinite(lse)[..., None].expand_as(s)
    if causal:
        q_pos = torch.arange(s.shape[-2], device=s.device)
        k_pos = torch.arange(s.shape[-1], device=s.device)
        live = live & (q_pos[:, None] >= k_pos[None, :])
    p = torch.where(live, torch.exp(s - lse[..., None]), s.new_zeros(()))
    dv = torch.matmul(p.transpose(-1, -2), do)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta[..., None])
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dq = torch.matmul(ds, k) * scale
    return dq, dk, dv, ds


def flash_attention_packed_backward_reference(
        qkv: torch.Tensor, bias: Optional[torch.Tensor], out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
        causal: bool = False, sm_scale: Optional[float] = None
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward kernels: (dqkv [B,S,3H] in
    qkv's dtype, dbias [B,S] in bias's dtype or None), all math in
    float32 on the full [B, h, S, S] score matrix.  p = exp(s - lse) is
    0 where the score is masked and in a row with no live key (lse =
    -inf).  Counts its calls in ``.calls``."""
    flash_attention_packed_backward_reference.calls += 1
    B, S, H, D = _split_heads(qkv, num_heads)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    x = qkv.float().reshape(B, S, 3, num_heads, D)
    q, k, v = (x[:, :, j].transpose(1, 2) for j in range(3))  # [B,h,S,D]
    do = dout.float().reshape(B, S, num_heads, D).transpose(1, 2)
    o = out.float().reshape(B, S, num_heads, D).transpose(1, 2)
    dq, dk, dv, ds = _backward_math(q, k, v, bias, o, lse, do, causal, scale)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B, S, H)
                      for t in (dq, dk, dv)], dim=-1).to(qkv.dtype)
    dbias = None if bias is None else ds.sum((1, 2)).to(bias.dtype)
    return dqkv, dbias


flash_attention_packed_backward_reference.calls = 0


def _check_qkv(qkv, num_heads, what):
    """What every kernel needs of qkv: a contiguous float32 or bfloat16
    [B, S, 3H] CUDA tensor with head_dim 64 or 128 and a grid CUDA can
    launch; returns (B, S, H, D)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qkv.device}")
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be [B, S, 3H], got {tuple(qkv.shape)}")
    B, S, H, D = _split_heads(qkv, num_heads)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {qkv.dtype}")
    if D not in (64, 128):
        raise ValueError(f"{what} needs head_dim in (64, 128); got {D}")
    if not qkv.is_contiguous():
        raise ValueError(f"{what} needs a contiguous qkv")
    if B == 0 or S == 0 or B > 65535 or num_heads > 65535:
        raise ValueError(f"{what}: unsupported grid B={B} S={S} "
                         f"num_heads={num_heads}")
    return B, S, H, D


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether 16-byte loads (TMA, cp.async) can read `t` in place: its
    address and every byte stride of a dim longer than 1 (the last dim's
    stride is 1, the loads run along it) are positive multiples of 16."""
    if t.data_ptr() % 16:
        return False
    return all(n == 1 or (st > 0 and st * t.element_size() % 16 == 0)
               for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def tma_operand(t: torch.Tensor, owner) -> torch.Tensor:
    """`t` as a kernel's 16-byte loads can read it, in either dtype:
    itself when ``tma_aligned``, else a fresh contiguous copy (new
    storage, so aligned), counted in ``owner.realigned``."""
    if tma_aligned(t):
        return t
    owner.realigned += 1
    return t.clone(memory_format=torch.contiguous_format)


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.pt_cuda_error_string(err).decode()} (cudaError {err})")


def _lib():
    from .build import load

    lib = load(_KERNEL)
    _bind(lib, ((lib.pt_flash_attention_packed_fwd, 4, False),
                (lib.pt_flash_attention_fwd, 6, True)))
    return lib


def _bind(lib, entries):
    """Set each C entry's argtypes once: `n_ptr` pointers, then (for an
    unpacked entry) the int64 stride array and B, Sq, Sk, heads, D,
    causal; a packed entry has B, S, H, heads, causal.  Then the scale,
    the dtype code and the stream."""
    for fn, n_ptr, unpacked in entries:
        if fn.argtypes is not None:
            continue
        mid = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 6
               if unpacked else [ctypes.c_int] * 5)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + mid + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pt_cuda_error_string.restype = ctypes.c_char_p


def flash_attention_packed(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                           num_heads: int, causal: bool = False,
                           sm_scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed attention forward: (out [B,S,H], lse [B,num_heads,S] f32).

    A CUDA tensor launches the Hopper kernel (counted in ``.launches``);
    a CPU tensor takes the plain version.  Raises on anything the kernel
    does not take: another device type, a dtype other than float32 or
    bfloat16, a non-contiguous qkv, head_dim not in (64, 128), or a bias
    that is not [B, S] on qkv's device.
    """
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(qkv, bias, num_heads,
                                                causal, sm_scale)
    B, S, H, D = _check_qkv(qkv, num_heads, "flash_attention_packed")
    if bias is not None:
        if tuple(bias.shape) != (B, S) or bias.device != qkv.device:
            raise ValueError(f"bias must be [B, S] = {(B, S)} on "
                             f"{qkv.device}, got {tuple(bias.shape)} on "
                             f"{bias.device}")
        # the kernel adds the bias in float32 (bf16 would round -1e4)
        bias = bias.to(torch.float32).contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qkv = tma_operand(qkv, flash_attention_packed)
    out = torch.empty((B, S, H), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((B, num_heads, S), dtype=torch.float32,
                      device=qkv.device)
    lib = _lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.pt_flash_attention_packed_fwd(
            qkv.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), lse.data_ptr(), B, S, H, num_heads,
            int(bool(causal)), float(scale), _DTYPE_CODES[qkv.dtype], stream)
    _raise_on(lib, err, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out, lse


flash_attention_packed.launches = 0
flash_attention_packed.realigned = 0


def _bwd_lib():
    from .build import load

    lib = load(_BWD_KERNEL)
    _bind(lib, ((lib.pt_flash_attention_packed_bwd_dkv, 7, False),
                (lib.pt_flash_attention_packed_bwd_dq, 6, False),
                (lib.pt_flash_attention_bwd_dkv, 10, True),
                (lib.pt_flash_attention_bwd_dq, 8, True)))
    return lib


def check_backward_inputs(qkv, bias, out, lse, dout, num_heads,
                          what="flash_attention_packed_backward"):
    """What the backward kernels take: qkv as ``_check_qkv`` wants it, and
    out, dout [B, S, H] in qkv's dtype, lse [B, num_heads, S] float32 and
    bias [B, S] float32 or None, all contiguous on qkv's device.  Raises
    on anything else; returns (B, S, H, D).  The launch helpers
    ``flash_attention_packed_dkv`` and ``flash_attention_packed_dq``
    trust their caller to have called it."""
    B, S, H, D = _check_qkv(qkv, num_heads, what)
    want = {"out": (out, (B, S, H), qkv.dtype),
            "dout": (dout, (B, S, H), qkv.dtype),
            "lse": (lse, (B, num_heads, S), torch.float32)}
    if bias is not None:
        want["bias"] = (bias, (B, S), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != qkv.device or not t.is_contiguous():
            raise ValueError(
                f"{what}: {name} must be a contiguous {dtype} {shape} on "
                f"{qkv.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}{'' if t.is_contiguous() else ' (not contiguous)'}")
    return B, S, H, D


def flash_attention_packed_dkv(qkv, bias, dout, lse, delta, dqkv,
                               dbias_heads, num_heads, causal, scale):
    """Launch the dK/dV kernel on inputs that ``check_backward_inputs``
    passed: writes dk and dv into columns [H, 3H) of `dqkv` (a contiguous
    [B, S, 3H] in qkv's dtype) and, when `dbias_heads` ([B, num_heads, S]
    float32, only with a bias) is given, each head's bias-gradient row
    sums into it.  `delta` is laid out like lse.  Counts launches in
    ``.launches`` and realigned operands in ``.realigned``."""
    B, S, threeH = qkv.shape
    qkv = tma_operand(qkv, flash_attention_packed_dkv)
    dout = tma_operand(dout, flash_attention_packed_dkv)
    lib = _bwd_lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.pt_flash_attention_packed_bwd_dkv(
            qkv.data_ptr(), bias.data_ptr() if bias is not None else None,
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(),
            dbias_heads.data_ptr() if dbias_heads is not None else None,
            B, S, threeH // 3, num_heads, int(bool(causal)), float(scale),
            _DTYPE_CODES[qkv.dtype], stream)
    _raise_on(lib, err, "flash_attention_packed_dkv")
    flash_attention_packed_dkv.launches += 1


flash_attention_packed_dkv.launches = 0
flash_attention_packed_dkv.realigned = 0


def flash_attention_packed_dq(qkv, bias, dout, lse, delta, dqkv, num_heads,
                              causal, scale):
    """Launch the dQ kernel on inputs that ``check_backward_inputs``
    passed: writes dq into columns [0, H) of `dqkv`.  Counts launches in
    ``.launches`` and realigned operands in ``.realigned``."""
    B, S, threeH = qkv.shape
    qkv = tma_operand(qkv, flash_attention_packed_dq)
    dout = tma_operand(dout, flash_attention_packed_dq)
    lib = _bwd_lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.pt_flash_attention_packed_bwd_dq(
            qkv.data_ptr(), bias.data_ptr() if bias is not None else None,
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), B, S, threeH // 3, num_heads,
            int(bool(causal)), float(scale), _DTYPE_CODES[qkv.dtype], stream)
    _raise_on(lib, err, "flash_attention_packed_dq")
    flash_attention_packed_dq.launches += 1


flash_attention_packed_dq.launches = 0
flash_attention_packed_dq.realigned = 0


def backward_delta(out, dout, num_heads):
    """delta = rowsum(dO * O) per head in float32, laid out like lse
    [B, num_heads, S]."""
    B, S, H = out.shape
    delta = (dout.float() * out.float()).reshape(B, S, num_heads,
                                                 H // num_heads).sum(-1)
    return delta.transpose(1, 2).contiguous()


def flash_attention_packed_backward(
        qkv: torch.Tensor, bias: Optional[torch.Tensor], out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, num_heads: int,
        causal: bool = False, sm_scale: Optional[float] = None,
        need_dbias: bool = True
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Packed attention backward: (dqkv [B,S,3H] in qkv's dtype, dbias
    [B,S] in bias's dtype, or None without a bias or with need_dbias
    False).  A CPU tensor takes the plain version; a CUDA tensor is
    checked once (``check_backward_inputs``), then launches the dK/dV and
    the dQ kernel, or raises."""
    if qkv.device.type == "cpu":
        dqkv, dbias = flash_attention_packed_backward_reference(
            qkv, bias, out, lse, dout, num_heads, causal, sm_scale)
        return dqkv, dbias if need_dbias else None
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    B, S, H, D = check_backward_inputs(qkv, bias32, out, lse, dout,
                                       num_heads)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    delta = backward_delta(out, dout, num_heads)
    dqkv = torch.empty_like(qkv)
    dbias_heads = None
    if bias is not None and need_dbias:
        dbias_heads = torch.empty((B, num_heads, S), dtype=torch.float32,
                                  device=qkv.device)
    flash_attention_packed_dkv(qkv, bias32, dout, lse, delta, dqkv,
                               dbias_heads, num_heads, causal, scale)
    flash_attention_packed_dq(qkv, bias32, dout, lse, delta, dqkv,
                              num_heads, causal, scale)
    dbias = None
    if dbias_heads is not None:
        # per-head partials summed here: no atomics, a deterministic sum
        dbias = dbias_heads.sum(1).to(bias.dtype)
    return dqkv, dbias


class _FlashAttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, bias, num_heads, causal, sm_scale):
        out, lse = flash_attention_packed(qkv, bias, num_heads, causal,
                                          sm_scale)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.attrs = (num_heads, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, out, lse = ctx.saved_tensors
        num_heads, causal, sm_scale = ctx.attrs
        dqkv, dbias = flash_attention_packed_backward(
            qkv, bias, out, lse, dout.to(qkv.dtype).contiguous(), num_heads,
            causal, sm_scale,
            need_dbias=bias is not None and ctx.needs_input_grad[1])
        return dqkv, dbias, None, None, None


def flash_attention_packed_autograd(qkv: torch.Tensor,
                                    bias: Optional[torch.Tensor],
                                    num_heads: int, causal: bool = False,
                                    sm_scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """``flash_attention_packed``'s out [B,S,H], differentiable in qkv
    and bias: forward kernel forward, backward kernels backward (plain
    versions on the CPU).  The bias grad is computed only when autograd
    asks for it."""
    return _FlashAttentionPacked.apply(qkv, bias, num_heads, causal,
                                       sm_scale)


# ---------------------------------------------------------------------------
# unpacked layout: q [B, H, Sq, D], k / v [B, H, Sk, D] (the flash_attention
# op), each read and written through its own strides
# ---------------------------------------------------------------------------

def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: Optional[torch.Tensor] = None,
                              causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the unpacked forward kernel: (out
    [B,H,Sq,D] in q's dtype, lse [B,H,Sq] float32), on
    ``blockwise_attention``.  Counts its calls in ``.calls``."""
    flash_attention_reference.calls += 1
    out, (m, l) = blockwise_attention(q, k, v, causal=causal,
                                      sm_scale=sm_scale, bias=bias)
    return out, m + torch.log(torch.clamp(l, min=1e-30))


flash_attention_reference.calls = 0


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor], out: torch.Tensor, lse: torch.Tensor,
        dout: torch.Tensor, causal: bool = False,
        sm_scale: Optional[float] = None):
    """Plain PyTorch version of the unpacked backward kernels: (dq, dk, dv
    in q's, k's and v's dtypes, dbias [B,Sk] in bias's dtype or None), all
    math in float32 on the full [B, H, Sq, Sk] score matrix.  Counts its
    calls in ``.calls``."""
    flash_attention_backward_reference.calls += 1
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    dq, dk, dv, ds = _backward_math(q.float(), k.float(), v.float(), bias,
                                    out.float(), lse, dout.float(), causal,
                                    scale)
    dbias = None if bias is None else ds.sum((1, 2)).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


flash_attention_backward_reference.calls = 0


def _check_unpacked(q, k, v, what):
    """What the unpacked kernels need: CUDA tensors q [B,H,Sq,D] and k, v
    [B,H,Sk,D] of one dtype, float32 or bfloat16, on one device, head_dim
    64 or 128, each with a contiguous last dim (any other strides); and a
    grid CUDA can launch.  Returns (B, H, Sq, Sk, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"{what}: q must be [B, H, Sq, D], got "
                         f"{tuple(q.shape)}")
    B, H, Sq, D = q.shape
    Sk = k.shape[2] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, H, Sk, D):
            raise ValueError(f"{what}: {name} must be [B, H, Sk, D] like q "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 q, k and v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in (64, 128):
        raise ValueError(f"{what} needs head_dim in (64, 128); got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what} needs {name} with a contiguous last "
                             f"dim, got strides {t.stride()}")
    if B == 0 or Sq == 0 or Sk == 0 or B > 65535 or H > 65535:
        raise ValueError(f"{what}: unsupported grid B={B} H={H} Sq={Sq} "
                         f"Sk={Sk}")
    return B, H, Sq, Sk, D


def _bias32(bias, B, Sk, device, what):
    """The bias as the kernels take it: float32 [B, Sk], contiguous (bf16
    would round -1e4 to -9984), or None."""
    if bias is None:
        return None
    if tuple(bias.shape) != (B, Sk) or bias.device != device:
        raise ValueError(f"{what}: bias must be [B, Sk] = {(B, Sk)} on "
                         f"{device}, got {tuple(bias.shape)} on "
                         f"{bias.device}")
    return bias.to(torch.float32).contiguous()


def _strides(*tensors):
    """(batch, head, row) element strides of each [B, H, S, D] tensor, as
    the C entries read them; None (an output the entry does not write)
    gives zeros."""
    vals = []
    for t in tensors:
        vals += [0, 0, 0] if t is None else list(t.stride()[:3])
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_unpacked(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             sm_scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpacked attention forward: (out [B,H,Sq,D] in q's dtype, lse
    [B,H,Sq] float32).

    A CUDA tensor launches the Hopper kernel (counted in ``.launches``);
    a CPU tensor takes the plain version.  The kernel writes out into
    [B, Sq, H, D] memory (returned as its [B, H, Sq, D] view), so moving
    the heads back next to each other and merging them is free.  Raises on
    anything the kernel does not take (``_check_unpacked``), or a bias
    that is not [B, Sk] on q's device.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, causal, sm_scale)
    what = "flash_attention_unpacked"
    B, H, Sq, Sk, D = _check_unpacked(q, k, v, what)
    bias = _bias32(bias, B, Sk, q.device, what)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    q, k, v = (tma_operand(t, flash_attention_unpacked) for t in (q, k, v))
    out = torch.empty((B, Sq, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            out.data_ptr(), lse.data_ptr(), _strides(q, k, v, out), B, Sq,
            Sk, H, D, int(bool(causal)), float(scale),
            _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, err, what)
    flash_attention_unpacked.launches += 1
    return out, lse


flash_attention_unpacked.launches = 0
flash_attention_unpacked.realigned = 0


def check_unpacked_backward_inputs(q, k, v, bias, out, lse, dout,
                                   what="flash_attention_unpacked_backward"):
    """What the unpacked backward kernels take: q, k, v as
    ``_check_unpacked`` wants them, out and dout [B,H,Sq,D] in q's dtype
    with a contiguous last dim, lse [B,H,Sq] float32 and bias [B,Sk]
    float32 or None, both contiguous, all on q's device.  Raises on
    anything else; returns (B, H, Sq, Sk, D).  The launch helpers
    ``flash_attention_unpacked_dkv`` and ``flash_attention_unpacked_dq``
    trust their caller to have called it."""
    B, H, Sq, Sk, D = _check_unpacked(q, k, v, what)
    want = {"out": (out, (B, H, Sq, D), q.dtype, False),
            "dout": (dout, (B, H, Sq, D), q.dtype, False),
            "lse": (lse, (B, H, Sq), torch.float32, True)}
    if bias is not None:
        want["bias"] = (bias, (B, Sk), torch.float32, True)
    for name, (t, shape, dtype, whole) in want.items():
        laid_out = t.is_contiguous() if whole else t.stride(-1) == 1
        if tuple(t.shape) != shape or t.dtype != dtype or \
                t.device != q.device or not laid_out:
            raise ValueError(
                f"{what}: {name} must be a {dtype} {shape} on {q.device} "
                f"with a contiguous {'layout' if whole else 'last dim'}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}, strides "
                f"{t.stride()}")
    return B, H, Sq, Sk, D


def flash_attention_unpacked_dkv(q, k, v, bias, dout, lse, delta, dk, dv,
                                 dbias_heads, causal, scale):
    """Launch the dK/dV kernel on inputs that
    ``check_unpacked_backward_inputs`` passed: writes dk and dv ([B,H,Sk,D]
    in k's dtype, last dim contiguous) and, when `dbias_heads` ([B,H,Sk]
    float32, only with a bias) is given, each head's bias-gradient row
    sums into it.  `delta` is laid out like lse.  Counts launches in
    ``.launches`` and realigned operands in ``.realigned``."""
    B, H, Sq, D = q.shape
    q, k, v, dout = (tma_operand(t, flash_attention_unpacked_dkv)
                     for t in (q, k, v, dout))
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            _ptr(bias), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _ptr(dbias_heads),
            _strides(q, k, v, dout, None, dk, dv), B, Sq, k.shape[2], H, D,
            int(bool(causal)), float(scale), _DTYPE_CODES[q.dtype], stream)
    _raise_on(lib, err, "flash_attention_unpacked_dkv")
    flash_attention_unpacked_dkv.launches += 1


flash_attention_unpacked_dkv.launches = 0
flash_attention_unpacked_dkv.realigned = 0


def flash_attention_unpacked_dq(q, k, v, bias, dout, lse, delta, dq, causal,
                                scale):
    """Launch the dQ kernel on inputs that
    ``check_unpacked_backward_inputs`` passed: writes dq ([B,H,Sq,D] in
    q's dtype, last dim contiguous).  Counts launches in ``.launches`` and
    realigned operands in ``.realigned``."""
    B, H, Sq, D = q.shape
    q, k, v, dout = (tma_operand(t, flash_attention_unpacked_dq)
                     for t in (q, k, v, dout))
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            _ptr(bias), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, dout, dq, None, None), B, Sq, k.shape[2], H,
            D, int(bool(causal)), float(scale), _DTYPE_CODES[q.dtype],
            stream)
    _raise_on(lib, err, "flash_attention_unpacked_dq")
    flash_attention_unpacked_dq.launches += 1


flash_attention_unpacked_dq.launches = 0
flash_attention_unpacked_dq.realigned = 0


def flash_attention_unpacked_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        bias: Optional[torch.Tensor], out: torch.Tensor, lse: torch.Tensor,
        dout: torch.Tensor, causal: bool = False,
        sm_scale: Optional[float] = None, need_dbias: bool = True):
    """Unpacked attention backward: (dq, dk, dv laid out like q, k and v,
    dbias [B,Sk] in bias's dtype, or None without a bias or with
    need_dbias False).  A CPU tensor takes the plain version; a CUDA
    tensor is checked once (``check_unpacked_backward_inputs``), then
    launches the dK/dV and the dQ kernel, or raises."""
    if q.device.type == "cpu":
        dq, dk, dv, dbias = flash_attention_backward_reference(
            q, k, v, bias, out, lse, dout, causal, sm_scale)
        return dq, dk, dv, dbias if need_dbias else None
    bias32 = None if bias is None else bias.to(torch.float32).contiguous()
    B, H, Sq, Sk, D = check_unpacked_backward_inputs(q, k, v, bias32, out,
                                                     lse, dout)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    delta = (dout.float() * out.float()).sum(-1).contiguous()  # [B,H,Sq]
    # laid out like q, k and v where they are dense (a view of another
    # layout keeps its strides), contiguous otherwise: the last dim stays
    # contiguous either way
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dbias_heads = None
    if bias is not None and need_dbias:
        dbias_heads = torch.empty((B, H, Sk), dtype=torch.float32,
                                  device=q.device)
    flash_attention_unpacked_dkv(q, k, v, bias32, dout, lse, delta, dk, dv,
                                 dbias_heads, causal, scale)
    flash_attention_unpacked_dq(q, k, v, bias32, dout, lse, delta, dq,
                                causal, scale)
    dbias = None
    if dbias_heads is not None:
        # per-head partials summed here: no atomics, a deterministic sum
        dbias = dbias_heads.sum(1).to(bias.dtype)
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale):
        out, lse = flash_attention_unpacked(q, k, v, bias, causal, sm_scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.attrs = (causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        causal, sm_scale = ctx.attrs
        dout = dout.to(q.dtype)
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv, dbias = flash_attention_unpacked_backward(
            q, k, v, bias, out, lse, dout, causal, sm_scale,
            need_dbias=bias is not None and ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None


def flash_attention_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             bias: Optional[torch.Tensor] = None,
                             causal: bool = False,
                             sm_scale: Optional[float] = None
                             ) -> torch.Tensor:
    """``flash_attention_unpacked``'s out [B,H,Sq,D], differentiable in q,
    k, v and bias: forward kernel forward, backward kernels backward
    (plain versions on the CPU).  The bias grad is computed only when
    autograd asks for it."""
    return _FlashAttention.apply(q, k, v, bias, causal, sm_scale)


def counters():
    """(owner, attribute) of every count kept here: ``.launches`` and
    ``.realigned`` of the six launching wrappers, ``.calls`` of the four
    plain versions.  A replayed CUDA graph runs none of this Python, so
    the executor adds what its capture counted on every replay."""
    wrappers = (flash_attention_packed, flash_attention_packed_dkv,
                flash_attention_packed_dq, flash_attention_unpacked,
                flash_attention_unpacked_dkv, flash_attention_unpacked_dq)
    plain = (flash_attention_packed_reference,
             flash_attention_packed_backward_reference,
             flash_attention_reference, flash_attention_backward_reference)
    return (tuple((w, a) for w in wrappers for a in ("launches", "realigned"))
            + tuple((p, "calls") for p in plain))
