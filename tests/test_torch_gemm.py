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
    assert gemm.scratch_elems(1, 4, 10, 256) == 0       # one chunk
    assert gemm.scratch_elems(2, 4, 10, 600) == 2 * 3 * 4 * 10
    assert gemm.scratch_elems(1, 17, 10, 600) == 0      # tiled launch


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
def test_kernel_raises_on_bf16(cuda):
    x = torch.zeros(2, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        gemm.matmul(x, x.t())
