"""The fp32 matrix product whose rows do not depend on M: the wrapper of
``csrc/gemm_f32.cu`` and its plain PyTorch version.

A library GEMM picks its kernel, and so the order of each dot product's
sums, by the number of rows: on the card the rows of a decode step's
M = 4 product differ in the last bits from the same rows of a prefill's
M = 512 one, and cached decode is no longer bit-equal to the uncached
forward.  This kernel fixes the arithmetic per output element (K in
chunks of ``K_CHUNK``, each chunk one FMA chain in increasing k from 0,
the chunk partials added left to right), so any M, tiling or batch
gives each row the same bits.  It replaces no TPU kernel: the JAX package
leaves these products to XLA.

Which products run it (``routes``): a float32 product of CUDA tensors
that no grad op differentiates, i.e. neither operand requires grad, as a
kept forward's inputs do under autograd (``ops/registry.py``
``_lower_kept``).  That is every ``mul`` and attention product of the
generation programs (prefill, decode, prefill chunk), of the uncached
forward and of BERT serving.  Training's products, which autograd
differentiates, and every bfloat16 product keep ``torch.matmul``; so
does every CPU product, whose callers keep their own CPU rules
(``ops/math_ops.py`` ``_mul``).

The launch is chosen here (``plan``, cached by shape) and passed to the
kernel: for M <= ``SKINNY_MAX_M`` the skinny kernel's columns a lane and
blocks a cluster (a warp a chunk, the partials folded in the cluster);
above it the tiled kernel's K split, from a model of the card's 132 SMs
(``tiled_time``).  A split falls on chunk boundaries only
(``split_ranges``), so every launch gives the same bits.

``matmul`` launches the kernel for a CUDA tensor (counted in
``.launches``) or raises; for a CPU tensor it takes the plain version
``matmul_reference`` (counted in ``.calls``), which computes the same
chunk partials with ``torch.matmul`` and folds them in the same order.
The two agree within ``tolerance``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

K_CHUNK = 256
SKINNY_MAX_M = 16
# the skinny kernel's cluster of blocks a column tile (one chunk range a
# block; 8 is the portable cluster size) and warps a block: the fewest
# blocks that give each chunk a warp; its wide lanes (4 columns each)
# where they still leave this many warps (one a chunk) on the card, else
# one column a lane
SKINNY_MAX_CLUSTER = 8
SKINNY_MAX_WARPS = 8
SKINNY_WIDE_WARPS = 4 * 132
# shared memory a skinny block may hold its chunk partials and x rows in
SKINNY_MAX_SMEM = 227 * 1024
_KERNEL = "gemm_f32"
# the card the launch model describes: an H100's SMs, its fp32 FMA rate
# an SM (67 TFLOP/s / 2 / 132) and its memory rate
SMS = 132
FMA_PER_S_SM = 67e12 / 2 / SMS
BYTES_PER_S = 3.35e12
# the tiled kernel's output tile (64 x 64, 64 threads of 8 x 8), how many
# of its blocks an SM holds at once (shared memory), and the threads an
# SM needs to run at its full rate (fitted to every launch's device time
# at the main path's shapes, time_fp32.py --what gemm_plans, one H100)
TILE = 64
TILE_BLOCKS_PER_SM = 4
SATURATING_THREADS = 256
MAX_SPLIT = 16
# tolerance's width, in units of the spread of a K-term fp32 sum's
# rounding error
ERR_SPREADS = 8


def routes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the product a @ b runs the kernel: float32 CUDA operands
    that do not require grad."""
    return (a.is_cuda and a.dtype == torch.float32
            and b.dtype == torch.float32
            and not (a.requires_grad or b.requires_grad))


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b through the kernel where ``routes`` says so, else
    ``torch.matmul``."""
    return matmul(a, b) if routes(a, b) else torch.matmul(a, b)


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: a [..., M, K] @ b [..., K, N] as chunk partials of
    K_CHUNK folded left to right.  Counts its calls in ``.calls``."""
    matmul_reference.calls += 1
    K = a.shape[-1]
    out = None
    for k0 in range(0, K, K_CHUNK):
        p = torch.matmul(a[..., k0:k0 + K_CHUNK],
                         b[..., k0:k0 + K_CHUNK, :])
        out = p if out is None else out + p
    return out


matmul_reference.calls = 0


def tolerance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise limit on |kernel - plain version| for a @ b:
    ERR_SPREADS sqrt(K) 2**-24 sqrt((a a) @ (b b)).

    Why: the rounding errors of a K-term fp32 dot product, summed in one
    order or another, are K roughly independent terms, the k-th at most
    2**-24 times the k-th partial sum, which for terms of random sign
    grows like sqrt(k) times their root mean square; so their sum
    spreads like sqrt(K) 2**-24 times the root of the sum of the squared
    terms.  (The worst case, K 2**-24 (|a| @ |b|), is about K times wider
    on such operands and lets reduced precision through.)  Operands
    rounded to TF32 (10 mantissa bits) spread the result by 2**-11
    sqrt(2/3) times that root, bf16 ones by 2**-8 sqrt(2/3): at the
    port's K (128 to 11008) 8x to 74x the limit for TF32 and 64x to 590x
    for bf16, so either fails it.  The limit is computed with
    ``torch.matmul`` and launches no kernel."""
    return ERR_SPREADS * math.sqrt(a.shape[-1]) * 2.0 ** -24 * torch.sqrt(
        torch.matmul(a * a, b * b))


def _lib():
    from .build import load

    lib = load(_KERNEL)
    fn = lib.pt_gemm_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pt_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Plan(NamedTuple):
    """A launch of ``csrc/gemm_f32.cu``: ``kind`` 0 (skinny: ``a``
    columns a lane, ``b`` blocks a cluster) or 1 (tiled: ``a`` the K
    split, ``b`` 0)."""
    kind: int
    a: int
    b: int


def chunks(K: int) -> int:
    return -(-K // K_CHUNK)


def split_ranges(K: int, split: int) -> List[Tuple[int, int]]:
    """The k range [begin, end) of each of `split` blocks along K, as the
    tiled kernel computes them: split s takes chunks [s C / S, (s + 1) C
    / S), so every boundary is a chunk boundary."""
    c = chunks(K)
    return [(s * c // split * K_CHUNK, min((s + 1) * c // split * K_CHUNK, K))
            for s in range(split)]


def skinny_blocks(M: int, K: int, launch: Plan) -> Tuple[int, int, int]:
    """(chunks a block, warps a block, bytes of shared memory) of a
    skinny launch: the cluster's blocks share the chunks evenly, a block
    has a warp a chunk up to SKINNY_MAX_WARPS, and it keeps every chunk
    partial of its rows (M rounded up to a power of two) and 32 x
    columns-a-lane columns, and each warp's chunk of x rows."""
    per_block = -(-chunks(K) // launch.b)
    warps = min(per_block, SKINNY_MAX_WARPS)
    rows = 1 << max(0, M - 1).bit_length()
    return (per_block, warps,
            4 * rows * (per_block * 32 * launch.a + warps * K_CHUNK))


def tiled_time(batch: int, M: int, N: int, K: int, split: int) -> float:
    """The launch model's seconds for a tiled launch: the blocks dealt
    round-robin over the SMs, each SM running them TILE_BLOCKS_PER_SM at
    a time at a rate that grows with its threads up to
    SATURATING_THREADS; a block's time its deepest FMAs; for a split, its
    partials written and read once at the memory rate."""
    blocks = -(-M // TILE) * -(-N // TILE) * batch * split
    depth = max(e - b for b, e in split_ranges(K, split))
    block = TILE * TILE * depth / FMA_PER_S_SM
    full, rest = divmod(-(-blocks // SMS), TILE_BLOCKS_PER_SM)

    def round_time(n):
        return n * block / min(1.0, n * TILE * TILE / 64
                               / SATURATING_THREADS)

    t = full * round_time(TILE_BLOCKS_PER_SM) + (
        round_time(rest) if rest else 0.0)
    if split > 1:
        t += (8.0 * scratch_elems(batch, M, N, K, Plan(1, split, 0))
              + 8.0 * batch * M * N) / BYTES_PER_S
    return t


@functools.lru_cache(maxsize=4096)
def plan(batch: int, M: int, N: int, K: int) -> Plan:
    """The launch for a [batch, M, K] @ [batch, K, N] product.  Skinny (M
    <= SKINNY_MAX_M): a cluster of as many blocks a column tile as give
    each chunk one of SKINNY_MAX_WARPS warps (at most
    SKINNY_MAX_CLUSTER), 4 columns a lane where M <= 4 and one
    warp a chunk still makes SKINNY_WIDE_WARPS warps (and the partials
    fit), else 1.  Tiled: the K split of least ``tiled_time``."""
    c = chunks(K)
    if M <= SKINNY_MAX_M:
        cluster = min(-(-c // SKINNY_MAX_WARPS), SKINNY_MAX_CLUSTER)
        wide = Plan(0, 4, cluster)
        if (M <= 4 and -(-N // 128) * batch * c >= SKINNY_WIDE_WARPS
                and skinny_blocks(M, K, wide)[2] <= SKINNY_MAX_SMEM):
            return wide
        return Plan(0, 1, cluster)
    splits = range(1, min(c, MAX_SPLIT, 65535 // batch) + 1)
    return Plan(1, min(splits, key=lambda sp: tiled_time(batch, M, N, K,
                                                         sp)), 0)


def scratch_elems(batch: int, M: int, N: int, K: int,
                  launch: Plan = None) -> int:
    """Floats of chunk partials the launch (default ``plan``) writes for
    the fold: a tiled split S > 1 writes those of every chunk after split
    0's, C - C / S a product (0: none)."""
    launch = launch or plan(batch, M, N, K)
    if launch.kind == 0 or launch.a == 1:
        return 0
    c = chunks(K)
    return batch * (c - c // launch.a) * M * N


def _operands(a: torch.Tensor, b: torch.Tensor):
    """(a as [batch, M, K] with a unit k stride, b as [batch, K, N] with a
    unit k or n stride, the batch shape); views where the strides
    allow, copies where they do not."""
    if a.dim() < 2 or b.dim() != a.dim():
        raise ValueError(f"gemm: operands [..., M, K] and [..., K, N] of "
                         f"one rank, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    lead = tuple(a.shape[:-2])
    M, K = a.shape[-2:]
    if tuple(b.shape[:-2]) != lead or b.shape[-2] != K:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not pair")
    batch = math.prod(lead)
    a3 = a.reshape(batch, M, K)
    if a3.stride(-1) != 1:
        a3 = a3.contiguous()
    b3 = b.reshape(batch, K, b.shape[-1])
    if b3.stride(-1) != 1 and b3.stride(-2) != 1:
        b3 = b3.contiguous()
    return a3, b3, lead


def matmul(a: torch.Tensor, b: torch.Tensor,
           launch: Plan = None) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] -> [..., M, N] float32.

    A CUDA tensor launches the kernel (counted in ``.launches``) as
    ``plan`` chooses, or as `launch` says (a timing script's
    comparison); a CPU tensor takes the plain version.  b may be a
    transposed view (K^T of a [..., N, K] tensor is read in place).
    Raises on anything the kernel does not take: another dtype than
    float32, operands on two devices, shapes that do not pair."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_reference(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"gemm: float32 operands only, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device or not a.is_cuda:
        raise ValueError(f"gemm: operands on {a.device} and {b.device}")
    a3, b3, lead = _operands(a, b)
    batch, M, K = a3.shape
    N = b3.shape[-1]
    out = torch.empty((batch, M, N), dtype=torch.float32, device=a.device)
    if min(batch, M, N, K) == 0:
        return out.zero_().reshape(*lead, M, N)
    launch = launch or plan(batch, M, N, K)
    if launch.kind == 0 and skinny_blocks(M, K, launch)[2] > SKINNY_MAX_SMEM:
        raise ValueError(f"gemm: K {K} needs more than {SKINNY_MAX_SMEM} "
                         f"bytes of chunk partials a skinny block")
    n_scratch = scratch_elems(batch, M, N, K, launch)
    scratch = torch.empty((n_scratch,), dtype=torch.float32,
                          device=a.device) if n_scratch else None
    strides = (ctypes.c_longlong * 7)(
        a3.stride(0), a3.stride(1), b3.stride(0), b3.stride(1),
        b3.stride(2), out.stride(0), out.stride(1))
    launch_args = (ctypes.c_int * 3)(*launch)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.pt_gemm_f32(
            a3.data_ptr(), b3.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            batch, M, N, K, strides, launch_args, stream)
    if err != 0:
        raise RuntimeError(
            f"gemm_f32 kernel launch failed: "
            f"{lib.pt_cuda_error_string(err).decode()} (cudaError {err})")
    matmul.launches += 1
    return out.reshape(*lead, M, N)


matmul.launches = 0


def counters():
    """(owner, attribute) of the counts kept here: the kernel's
    ``.launches`` and the plain version's ``.calls``."""
    return ((matmul, "launches"), (matmul_reference, "calls"))
