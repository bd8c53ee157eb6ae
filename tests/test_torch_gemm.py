"""The fp32 product whose rows do not depend on M (ops/cuda/gemm.py).

On the CPU: the wrapper's checks and routing rule, and its plain version,
which computes the kernel's chunk partials (K in chunks of 256) with
torch.matmul and folds them left to right: held to the exact product
within ``gemm.tolerance``, 8 sqrt(K) 2**-24 sqrt((x x) @ (w w)) (eight
spreads of a K-term fp32 sum's rounding error; the reason is in its
docstring), which operands rounded to TF32 or bf16 must exceed.  On the
CPU ``mul`` keeps its own rules (one row as two) and never calls the
wrapper.

Marked ``cuda`` (skip without a card): the kernel against the plain
version within that tolerance, and every row of an M-row product bit-equal
to the same row of a longer product and of a row-permuted one, for the
skinny (M <= 16) and the tiled launch, k-major and n-major weights,
batched.  On the card: ``python -m pytest -m cuda tests/test_torch_gemm.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import gemm

R = np.random.RandomState(2468)


def _t(*shape):
    return torch.from_numpy(R.randn(*shape).astype("float32"))


def _round_mantissa(t, bits):
    """float32 `t` rounded to `bits` explicit mantissa bits (ties away
    from zero): TF32 keeps 10, bf16 7."""
    drop = 23 - bits
    i = t.view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(
        torch.float32)


@pytest.mark.parametrize("M,K,N", [(1, 5, 3), (4, 256, 7), (3, 600, 10),
                                   (17, 513, 33)],
                         ids=["one_chunk_short", "one_full_chunk",
                              "three_chunks", "ragged_last_chunk"])
def test_plain_version_within_the_fp32_bound(M, K, N):
    x, w = _t(M, K), _t(K, N)
    calls = gemm.matmul_reference.calls
    got = gemm.matmul(x, w)  # a CPU tensor takes the plain version
    assert gemm.matmul_reference.calls == calls + 1
    want = torch.matmul(x.double(), w.double())
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert bool(((got.double() - want).abs()
                 <= gemm.tolerance(x, w)).all())


@pytest.mark.parametrize("bits", [10, 7], ids=["tf32", "bf16"])
@pytest.mark.parametrize("K", [768, 11008], ids=["bert", "llama_ffn_out"])
def test_tolerance_fails_reduced_precision(bits, K):
    """The exact product of operands rounded to TF32 or bf16 falls outside
    the tolerance, so a kernel that computed in either could not pass."""
    x, w = _t(4, K), _t(K, 32)
    exact = torch.matmul(x.double(), w.double())
    assert bool(((gemm.matmul(x, w).double() - exact).abs()
                 <= gemm.tolerance(x, w)).all())
    rounded = torch.matmul(_round_mantissa(x, bits).double(),
                           _round_mantissa(w, bits).double())
    assert float(((rounded - exact).abs() / gemm.tolerance(x, w)).max()) > 2


def test_plain_version_folds_chunks_left_to_right():
    """K = 600: partials of 256, 256 and 88 keys, added in that order."""
    x, w = _t(3, 600), _t(600, 5)
    p = [torch.matmul(x[:, a:b], w[a:b]) for a, b in
         ((0, 256), (256, 512), (512, 600))]
    assert torch.equal(gemm.matmul_reference(x, w), (p[0] + p[1]) + p[2])


def test_batched_and_transposed_operands():
    """[B, H, M, K] @ [B, H, K, N], the right one a transposed view of a
    [B, H, N, K] tensor, as cached_attention's Q K^T reads the cache."""
    q, k = _t(2, 3, 4, 8), _t(2, 3, 20, 8)
    got = gemm.matmul(q, k.transpose(-1, -2))
    want = torch.matmul(q, k.transpose(-1, -2))
    assert got.shape == (2, 3, 4, 20)
    assert bool(((got - want).abs() <=
                 gemm.tolerance(q, k.transpose(-1, -2))).all())


def test_routing_rule():
    """The kernel takes float32 CUDA products that no grad op
    differentiates; CPU, bf16 and differentiated products do not."""
    x, w = _t(2, 3), _t(3, 4)
    assert not gemm.routes(x, w)                      # CPU
    cuda_like = torch.empty(2, 3, device="meta")
    assert not gemm.routes(cuda_like, w)              # not CUDA either
    assert not gemm.routes(x.bfloat16(), w.bfloat16())
    assert not gemm.routes(x.requires_grad_(), w)
    # off the kernel, product() is torch.matmul
    assert torch.equal(gemm.product(x.detach(), w), torch.matmul(x.detach(),
                                                                 w))


@pytest.mark.parametrize("a,b,err", [
    ((2, 3), (4, 5), "do not pair"),
    ((2, 3), (1, 3, 5), "one rank"),
    ((2, 2, 3), (3, 3, 5), "do not pair")],
    ids=["inner_dim", "rank", "batch"])
def test_wrapper_rejects_what_the_kernel_does_not_take(a, b, err):
    with pytest.raises(ValueError, match=err):
        gemm._operands(torch.zeros(a), torch.zeros(b))


def test_scratch_only_for_skinny_multi_chunk_products():
    """Since the skinny kernel folds its chunks inside the block, only a
    tiled launch split along K has partials to fold: those of every
    chunk after split 0's."""
    assert gemm.scratch_elems(1, 4, 10, 256) == 0       # one chunk
    assert gemm.scratch_elems(2, 4, 10, 600) == 0       # skinny folds
    assert gemm.scratch_elems(1, 17, 10, 600, gemm.Plan(1, 1, 0)) == 0
    # 3 chunks split in 3: split 0 takes chunk 0, the others write 1, 2
    assert gemm.scratch_elems(2, 17, 10, 600, gemm.Plan(1, 3, 0)) == \
        2 * 2 * 17 * 10
    # 43 chunks split in 2: chunks 21-42 to scratch
    assert gemm.scratch_elems(1, 64, 8, 11008, gemm.Plan(1, 2, 0)) == \
        22 * 64 * 8


@pytest.mark.parametrize("K,split", [
    (K, s) for K in (1, 255, 256, 600, 768, 3072, 4096, 11008)
    for s in (1, 2, 3, 4, 8, 16) if s <= -(-K // 256)])
def test_splits_fall_on_chunk_boundaries(K, split):
    """A K split covers K once, in order, and every boundary inside it is
    a multiple of the chunk: each chunk's chain stays whole, so a split
    launch adds the same partials in the same order."""
    ranges = gemm.split_ranges(K, split)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(b > a and a % gemm.K_CHUNK == 0 for a, b in ranges)


# the main path's products, (batch, M, N, K): Llama-2-7B's at a 512- and a
# 64-token prefill bucket and a 128-token chunk (with its attention's),
# BERT-base serving's at batch 4 and 1, the decode step's and decode
# attention's
MAIN_PATH = (
    [(1, M, n, k) for M in (512, 64, 128)
     for n, k in ((12288, 4096), (4096, 4096), (22016, 4096),
                  (4096, 11008), (32000, 4096))]
    + [(32, 128, 1024, 128), (32, 128, 128, 1024)]
    + [(1, M, n, k) for M in (512, 128)
       for n, k in ((2304, 768), (768, 768), (3072, 768), (768, 3072))]
    + [(1, 4, n, k) for n, k in ((12288, 4096), (4096, 4096),
                                 (22016, 4096), (4096, 11008),
                                 (32000, 4096), (2304, 768))]
    + [(128, 1, 1024, 128), (128, 1, 128, 1024)])


@pytest.mark.parametrize("shape", MAIN_PATH, ids=lambda s: "x".join(
    map(str, s)))
def test_plan_is_a_launch_the_kernel_takes(shape):
    """What the C entry accepts: skinny for M <= 16 with 1 or 4 columns
    a lane (4 only for M <= 4) and a cluster of 1-8 blocks, no more than
    the chunks, whose partials fit a block's shared memory and need no
    scratch; tiled above it, a split of 1 to the chunk count with its
    scratch."""
    batch, M, N, K = shape
    p = gemm.plan(*shape)
    c = gemm.chunks(K)
    if M <= gemm.SKINNY_MAX_M:
        assert p.kind == 0 and p.a in (1, 4) and (p.a == 1 or M <= 4)
        assert 1 <= p.b <= min(c, gemm.SKINNY_MAX_CLUSTER)
        per_block, warps, smem = gemm.skinny_blocks(M, K, p)
        assert per_block * p.b >= c > (per_block - 1) * p.b
        assert 1 <= warps <= gemm.SKINNY_MAX_WARPS
        assert smem <= gemm.SKINNY_MAX_SMEM
        assert gemm.scratch_elems(*shape) == 0
    else:
        assert p.kind == 1 and p.b == 0
        assert 1 <= p.a <= c and batch * p.a <= 65535
        assert gemm.scratch_elems(*shape) == (
            batch * (c - c // p.a) * M * N if p.a > 1 else 0)


@pytest.mark.parametrize("shape", [s for s in MAIN_PATH
                                   if 768 not in s[2:]],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_fills_the_card(shape):
    """Every Llama main-path launch keeps the 132 SMs busy: at least 128
    blocks (Llama-2-7B's 128 x 128 tiles of a 512 x 4096 output), or,
    where the product has fewer, every block that one tile or column
    tile, chunk by chunk, can give it.  (BERT's products, 768 wide on one
    side, are left to the model: on the card fewer, deeper
    blocks beat a split's scratch there, as ffn1's 96 unsplit tiles at
    M 512 beat its 288 split ones.)"""
    batch, M, N, K = shape
    p = gemm.plan(*shape)
    c = gemm.chunks(K)
    if p.kind == 0:
        tiles = -(-N // (32 * p.a)) * batch
        blocks, most = tiles * p.b, tiles * min(c, gemm.SKINNY_MAX_CLUSTER)
    else:
        tiles = -(-M // gemm.TILE) * -(-N // gemm.TILE) * batch
        blocks = tiles * p.a
        most = tiles * min(c, gemm.MAX_SPLIT)
    assert blocks >= min(128, most), (p, blocks, most)


def test_skinny_shared_memory_bounds_k():
    """A skinny block keeps every partial of its chunks and each warp's
    x rows: at 8 blocks a cluster, 16 rows and one column a lane, K past
    8 x 49 chunks does not fit (the wrapper raises on it)."""
    fits, over = 8 * 49 * 256, 8 * 50 * 256
    p = gemm.plan(1, 16, 64, fits)
    assert p == gemm.Plan(0, 1, 8)
    assert gemm.skinny_blocks(16, fits, p)[2] <= gemm.SKINNY_MAX_SMEM
    assert gemm.skinny_blocks(16, over, p)[2] > gemm.SKINNY_MAX_SMEM


def test_mul_on_the_cpu_keeps_its_rules():
    """On the CPU ``mul`` does not call the wrapper (its one-row product
    is the first row of a two-row one, as before)."""
    import paddle_tpu_torch as tpt

    main = tpt.Program()
    block = main.global_block()
    block.create_var(name="x", shape=[1, 8], dtype="float32", is_data=True)
    block.create_var(name="w", shape=[8, 6], dtype="float32", is_data=True)
    block.append_op("mul", inputs={"X": ["x"], "Y": ["w"]},
                    outputs={"Out": ["o"]})
    x, w = _t(1, 8).numpy(), _t(8, 6).numpy()
    before = (gemm.matmul.launches, gemm.matmul_reference.calls)
    got = tpt.Executor(tpt.CPUPlace()).run(
        main, feed={"x": x, "w": w}, fetch_list=["o"], scope=tpt.Scope())[0]
    assert (gemm.matmul.launches, gemm.matmul_reference.calls) == before
    two = torch.matmul(torch.from_numpy(np.concatenate([x, x])),
                       torch.from_numpy(w))[:1]
    np.testing.assert_array_equal(got, two.numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N", [(4096, 4096), (11008, 4096), (768, 2304),
                                 (300, 70)],
                         ids=["llama_attn_out", "llama_ffn_out",
                              "bert_qkv", "ragged"])
def test_kernel_rows_do_not_depend_on_m(cuda, K, N):
    x = _t(512, K).to(cuda)
    w = _t(K, N).to(cuda)
    launches = gemm.matmul.launches
    full = gemm.matmul(x, w)
    assert gemm.matmul.launches == launches + 1
    perm = torch.from_numpy(R.permutation(512)).to(cuda)
    assert torch.equal(gemm.matmul(x[perm], w), full[perm])
    for M in (1, 2, 3, 4, 7, 16, 17, 64, 128, 500):
        assert torch.equal(gemm.matmul(x[:M], w), full[:M]), M
    ref = gemm.matmul_reference(x[:4], w)
    assert bool(((full[:4] - ref).abs() <= gemm.tolerance(x[:4], w)).all())


@pytest.mark.cuda
def test_kernel_batched_n_major_rows_do_not_depend_on_m(cuda):
    q = _t(64, 256, 128).to(cuda)
    k = _t(64, 512, 128).to(cuda)
    full = gemm.matmul(q, k.transpose(1, 2))
    for M in (1, 2, 16, 17):
        assert torch.equal(gemm.matmul(q[:, :M], k.transpose(1, 2)),
                           full[:, :M]), M
    ref = gemm.matmul_reference(q[:, :2], k.transpose(1, 2))
    assert bool(((full[:, :2] - ref).abs()
                 <= gemm.tolerance(q[:, :2], k.transpose(1, 2))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,M,K,N", [(1, 128, 768, 768),
                                         (1, 64, 600, 10),
                                         (128, 4, 1024, 128),
                                         (32, 128, 1024, 128),
                                         (1, 40, 11008, 4096)],
                         ids=["bert_batch1", "k600", "decode_pv_n128",
                              "chunk_pv", "ffn_out_split"])
def test_kernel_every_launch_gives_the_same_bits(cuda, batch, M, K, N):
    """Every launch the kernel takes (each K split, or each lane
    width) gives the chosen launch's bits, and its rows are those of the
    same rows in a longer product; within the tolerance of the plain
    version."""
    x = _t(batch, M, K).to(cuda)
    w = _t(batch, K, N).to(cuda)
    want = gemm.matmul(x, w)
    if M <= gemm.SKINNY_MAX_M:
        launches = [gemm.Plan(0, cpt, cl) for cpt in (1, 4)
                    for cl in range(1, min(gemm.chunks(K), 8) + 1)
                    if cpt == 1 or M <= 4]
    else:
        launches = [gemm.Plan(1, sp, 0) for sp in (1, 2, 3, 5)
                    if sp <= gemm.chunks(K)]
    for launch in launches:
        assert torch.equal(gemm.matmul(x, w, launch), want), launch
    longer = torch.cat([x, _t(batch, 24, K).to(cuda)], dim=1)
    assert torch.equal(gemm.matmul(longer, w)[:, :M], want)
    assert bool(((want - gemm.matmul_reference(x, w)).abs()
                 <= gemm.tolerance(x, w)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 17, 128])
def test_kernel_reads_a_misaligned_transposed_cache(cuda, M):
    """K^T read through a [batch, N, K] view one float off 16-byte
    alignment (the 4-byte path) gives the aligned view's bits."""
    q = _t(8, M, 128).to(cuda)
    k = _t(8, 300, 128).to(cuda)
    flat = torch.empty(k.numel() + 1, device=cuda)[1:]
    km = flat.view(8, 300, 128).copy_(k)
    assert km.data_ptr() % 16 != 0
    assert torch.equal(gemm.matmul(q, km.transpose(1, 2)),
                       gemm.matmul(q, k.transpose(1, 2)))


@pytest.mark.cuda
def test_kernel_raises_on_bf16(cuda):
    x = torch.zeros(2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        gemm.matmul(x, x.t())
