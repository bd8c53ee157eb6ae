"""The Hopper kernel against its plain version, on the card.

Marked ``cuda``: each test skips, with the reason, where
torch.cuda.is_available() is false.  On a machine with the card:
``python -m pytest -m cuda tests/test_torch_cuda_kernel.py``.
Tolerances as in chip_smoke.py: fp32 out 2e-5 and lse 1e-5 (TF32 off);
bf16 out 2e-2 against the fp32 plain version on the same rounded inputs;
fp16 a quarter of bf16's (OUT_ATOL, GRAD_ATOL): the kernels round the
same values (P, dS and the outputs) to 2**-11 where bf16 rounds them to
2**-8, eight times finer, and a quarter keeps a factor 2 of room; per
128-row block fp16 1e-3 (BLOCK_REL), between fp16's largest reading in
chip_smoke.py (3.4e-4) and bf16's smallest (1.8e-3).  The all-padding
batch row scores near -1e4, where one fp32 ulp is 2**-10: it is held to
half an ulp (out) and one ulp (lse); a 16-bit out to its dtype's out
limit, since the kernels round that row's P and output as a live row's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

OUT_ATOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 5e-3}
GRAD_ATOL = {"float32": 1e-4, "bfloat16": 5e-2, "float16": 1.25e-2}
BLOCK_REL = {"bfloat16": 1e-2, "float16": 1e-3}
NOT_TAKEN = "float32, bfloat16 or float16"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,nh,causal,with_bias",
                         [(4, 128, 768, 12, False, True),
                          (1, 128, 768, 12, False, True),   # serving B 1
                          (8, 128, 768, 12, False, True),   # serving B 8
                          (8, 512, 768, 12, False, True),   # training
                          (8, 512, 768, 12, True, True),
                          (2, 100, 256, 2, True, True),
                          (2, 64, 256, 2, False, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernel_matches_plain_version(cuda, B, S, H, nh, causal, with_bias,
                                      dtype):
    """The packed forward against its plain version.  In float32 on an
    H100 (132 SMs) serving at B 1 and the S 100 case take the 16-row q
    tiles, B 4, B 8 and the training shape (B 8, S 512) the 64-row ones."""
    rng = np.random.RandomState(B * S + H)
    qkv = torch.from_numpy(rng.randn(B, S, 3 * H).astype("float32"))
    qkv = qkv.to(cuda, getattr(torch, dtype))
    bias = None
    if with_bias:
        mask = (rng.rand(B, S) > 0.2).astype("float32")
        mask[-1] = 0.0
        bias = torch.from_numpy(mask * 1e4 - 1e4).to(cuda)
    before = tfa.flash_attention_packed.launches
    out, lse = tfa.flash_attention_packed(qkv, bias, nh, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_packed.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_packed_reference(
        qkv.float(), bias, nh, causal)
    atol = OUT_ATOL[dtype]
    assert out.dtype == qkv.dtype
    err = (out.float() - ref_out).abs()
    lerr = (lse - ref_lse).abs()
    live = slice(0, B - 1) if with_bias else slice(0, B)
    if B > 1 or not with_bias:  # at B 1 the one row is all padding
        assert err[live].max().item() <= atol
        assert lerr[live].max().item() <= 1e-5
    if with_bias:
        assert err[-1].max().item() <= max(atol, 2.0 ** -11)
        assert lerr[-1].max().item() <= 2.0 ** -10


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    qkv = torch.randn(2, 16, 3 * 128, device=cuda)
    with pytest.raises(TypeError, match=NOT_TAKEN):
        tfa.flash_attention_packed(qkv.double(), None, 2)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_packed(qkv, None, 4)           # head_dim 32
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_packed(
            torch.randn(16, 2, 3 * 128, device=cuda).transpose(0, 1), None, 2)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention_packed(qkv, torch.zeros(2, 15, device=cuda), 2)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention_packed(qkv, torch.zeros(2, 16), 2)  # on the CPU


@pytest.mark.cuda
def test_op_dispatch_on_the_card(cuda):
    """flash_attention_qkv launches the kernel for packed widths; at the
    others (head_dim 48) it runs the JAX package's formulation there,
    heads split then blockwise attention, on the card (counted in
    split_heads_attention.calls, no kernel launch; fp32 against the CPU:
    atol 2e-5)."""
    import paddle_tpu_torch as tpt

    def run(H, nh):
        main = tpt.Program()
        block = main.global_block()
        block.create_var(name="qkv", shape=[2, 16, 3 * H], dtype="float32",
                         is_data=True)
        block.append_op("flash_attention_qkv", inputs={"QKV": ["qkv"]},
                        outputs={"Out": ["o"]},
                        attrs={"num_heads": nh, "causal": False})
        x = np.random.RandomState(H).randn(2, 16, 3 * H).astype("float32")
        return tpt.Executor().run(main, feed={"qkv": x}, fetch_list=["o"],
                                  scope=tpt.Scope())[0], x

    before = tfa.flash_attention_packed.launches
    out, x = run(256, 2)
    assert tfa.flash_attention_packed.launches == before + 1
    ref, _ = tfa.flash_attention_packed_reference(torch.from_numpy(x), None, 2)
    np.testing.assert_allclose(out, ref.numpy(), atol=2e-5, rtol=0)
    before = tfa.flash_attention_packed.launches
    calls = tfa.split_heads_attention.calls
    out, x = run(96, 2)  # head_dim 48
    assert tfa.flash_attention_packed.launches == before
    assert tfa.split_heads_attention.calls == calls + 1
    ref = tfa.split_heads_attention(torch.from_numpy(x), None, 2)
    np.testing.assert_allclose(out, ref.numpy(), atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_small_bert_on_the_card_matches_the_cpu(cuda):
    """Executor + Predictor on the card against the same program and
    weights on the CPU (fp32, TF32 off: logits atol 1e-4, loss rel 1e-5)."""
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models import build_bert_pretrain

    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        feeds, outs = build_bert_pretrain(
            is_test=True, seq_len=32, vocab_size=97, hidden=128,
            num_layers=2, num_heads=2, intermediate=256)
    logits = [op for op in main.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0].input("Logits")[0]
    scope = tpt.Scope()
    tpt.Executor().run(startup, scope=scope)
    rng = np.random.RandomState(0)
    mask = np.ones((3, 32), "float32")
    mask[1, 10:] = 0.0
    feed = {"input_ids": rng.randint(0, 97, (3, 32)),
            "token_type_ids": np.zeros((3, 32), "int64"), "attn_mask": mask,
            "mlm_mask": (rng.rand(3, 32) < 0.3).astype("float32"),
            "mlm_labels": rng.randint(0, 97, (3, 32))}
    fetch = [logits, outs["loss"].name]
    on_card = tpt.inference.Predictor(main, feeds, fetch, scope=scope)
    on_cpu = tpt.inference.Predictor(main, feeds, fetch, scope=scope,
                                     device="cpu")
    got, want = on_card.run(feed), on_cpu.run(feed)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)


def _bwd_inputs(B, S, H, nh, causal, with_bias, dtype, device, seed):
    """qkv, bias (last row all padding), and the forward's out / lse from
    the plain version; dout random."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(B, S, 3 * H).astype("float32"))
    qkv = qkv.to(device, getattr(torch, dtype))
    dout = torch.from_numpy(rng.randn(B, S, H).astype("float32"))
    dout = dout.to(device, getattr(torch, dtype))
    bias = None
    if with_bias:
        mask = (rng.rand(B, S) > 0.2).astype("float32")
        mask[-1] = 0.0
        bias = torch.from_numpy(mask * 1e4 - 1e4).to(device)
    out, lse = tfa.flash_attention_packed_reference(qkv.float(), bias, nh,
                                                    causal)
    return qkv, bias, out.to(qkv.dtype), lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,nh,causal,with_bias",
                         [(2, 128, 768, 12, False, True),
                          (2, 100, 256, 2, True, True),
                          (2, 64, 256, 2, False, False),
                          (1, 100, 768, 12, True, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_backward_kernels_match_plain_version(cuda, B, S, H, nh, causal,
                                              with_bias, dtype):
    """dqkv and dbias from the dK/dV and dQ kernels against the plain
    backward on the same (rounded) inputs in float32.  fp32: atol 1e-4 on
    dqkv and dbias (sums of up to S products of O(1) terms in another
    order); bf16: atol 5e-2 on dqkv, the kernel's bf16 output rounding
    (2**-8 relative on values up to ~10), fp16 a quarter of it, and 1e-4
    on the float32 dbias."""
    qkv, bias, out, lse, dout = _bwd_inputs(B, S, H, nh, causal, with_bias,
                                            dtype, cuda, seed=B * S + H)
    before = (tfa.flash_attention_packed_dkv.launches,
              tfa.flash_attention_packed_dq.launches)
    dqkv, dbias = tfa.flash_attention_packed_backward(
        qkv, bias, out, lse, dout, nh, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_packed_dkv.launches,
            tfa.flash_attention_packed_dq.launches) == (before[0] + 1,
                                                        before[1] + 1)
    ref, ref_db = tfa.flash_attention_packed_backward_reference(
        qkv.float(), bias, out.float(), lse, dout.float(), nh, causal)
    assert dqkv.dtype == qkv.dtype and dqkv.shape == qkv.shape
    atol = GRAD_ATOL[dtype]
    assert torch.isfinite(dqkv.float()).all()
    assert (dqkv.float() - ref).abs().max().item() <= atol
    if with_bias:
        assert dbias.dtype == torch.float32 and dbias.shape == (B, S)
        # float32 in both, on the same rounded inputs
        assert (dbias - ref_db).abs().max().item() <= 1e-4
    else:
        assert dbias is None


@pytest.mark.cuda
def test_autograd_function_on_the_card_matches_the_cpu(cuda):
    """flash_attention_packed_autograd: kernel forward and backward on the
    card against the plain versions on the CPU (fp32, atol 1e-4)."""
    rng = np.random.RandomState(11)
    x = rng.randn(2, 80, 3 * 256).astype("float32")
    mask = (rng.rand(2, 80) > 0.3).astype("float32")
    b = mask * 1e4 - 1e4
    grads = []
    for dev in (cuda, torch.device("cpu")):
        qkv = torch.from_numpy(x).to(dev).requires_grad_(True)
        bias = torch.from_numpy(b).to(dev).requires_grad_(True)
        out = tfa.flash_attention_packed_autograd(qkv, bias, 2, True)
        (out * out).sum().backward()
        grads.append((qkv.grad.cpu(), bias.grad.cpu()))
    for g, want in zip(grads[0], grads[1]):
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-4,
                                   rtol=0)


@pytest.mark.cuda
def test_backward_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    qkv, bias, out, lse, dout = _bwd_inputs(2, 16, 128, 2, False, True,
                                            "float32", cuda, seed=1)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_packed_backward(
            qkv, bias, out, lse, dout.transpose(0, 1).contiguous().transpose(0, 1),
            2)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_packed_backward(qkv, bias, out, lse[:, :1], dout,
                                            2)
    with pytest.raises(TypeError, match=NOT_TAKEN):
        tfa.flash_attention_packed_backward(qkv.double(), bias, out.double(),
                                            lse, dout.double(), 2)


# ---------------------------------------------------------------------------
# unpacked kernels (#4-#6 of the TPU kernel table): q [B,H,Sq,D], k/v
# [B,H,Sk,D], read through their strides
# ---------------------------------------------------------------------------

def _unpacked_inputs(B, H, Sq, Sk, D, with_bias, dtype, device, seed,
                     views):
    """q, k, v (as [B,H,S,D] views of [B,S,H,D] buffers when `views`, as
    the port's transpose2 and rope leave them; contiguous otherwise), a
    bias with an all-padding last row, and a cotangent."""
    rng = np.random.RandomState(seed)

    def heads(S):
        x = torch.from_numpy(rng.randn(B, S, H, D).astype("float32"))
        x = x.to(device, getattr(torch, dtype)).transpose(1, 2)
        return x if views else x.contiguous()

    q, k, v, dout = heads(Sq), heads(Sk), heads(Sk), heads(Sq)
    bias = None
    if with_bias:
        mask = (rng.rand(B, Sk) > 0.2).astype("float32")
        mask[-1] = 0.0
        bias = torch.from_numpy(mask * 1e4 - 1e4).to(device)
    return q, k, v, bias, dout


UNPACKED_CASES = [
    # (B, H, Sq, Sk, D, causal, with_bias, views)
    (2, 4, 128, 128, 64, True, False, True),
    (2, 2, 100, 100, 128, True, True, False),
    (2, 2, 128, 384, 64, False, True, True),
    (1, 2, 384, 128, 128, True, False, True),
    (3, 2, 64, 100, 64, False, False, False),
    # D 32 (MiniLM-L12-H384's heads): 64-byte-swizzled 16-bit tiles
    (2, 4, 128, 128, 32, True, True, True),
    (2, 2, 100, 100, 32, False, True, False),
    (1, 2, 384, 128, 32, True, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,with_bias,views",
                         UNPACKED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_unpacked_kernels_match_plain_versions(cuda, B, H, Sq, Sk, D,
                                               causal, with_bias, views,
                                               dtype):
    """Forward (out, lse) and backward (dq, dk, dv, dbias) on the card
    against the plain versions on the same rounded inputs in float32.
    Tolerances as for the packed kernels: fp32 out 2e-5, lse 1e-5, grads
    1e-4; bf16 out 2e-2, grads 5e-2 (the kernels' output rounding), fp16
    a quarter of those; the
    all-padding row of out to half an fp32 ulp at 1e4 (or the bf16
    tolerance), its lse to one ulp, its grads to 2**-6."""
    q, k, v, bias, dout = _unpacked_inputs(B, H, Sq, Sk, D, with_bias,
                                           dtype, cuda, B * Sq + Sk + D,
                                           views)
    before = (tfa.flash_attention_unpacked.launches,
              tfa.flash_attention_unpacked_dkv.launches,
              tfa.flash_attention_unpacked_dq.launches)
    out, lse = tfa.flash_attention_unpacked(q, k, v, bias, causal)
    dq, dk, dv, dbias = tfa.flash_attention_unpacked_backward(
        q, k, v, bias, out, lse, dout, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_unpacked.launches,
            tfa.flash_attention_unpacked_dkv.launches,
            tfa.flash_attention_unpacked_dq.launches) == tuple(
                n + 1 for n in before)
    f = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = tfa.flash_attention_reference(*f, bias, causal)
    ref = tfa.flash_attention_backward_reference(
        *f, bias, out.float(), lse, dout.float(), causal)
    live = slice(0, B - 1) if with_bias else slice(0, B)
    out_tol, grad_tol = OUT_ATOL[dtype], GRAD_ATOL[dtype]
    assert out.dtype == q.dtype and out.shape == q.shape
    assert (out.float() - ref_out)[live].abs().max().item() <= out_tol
    assert (lse - ref_lse)[live].abs().max().item() <= 1e-5
    for got, want in zip((dq, dk, dv), ref[:3]):
        assert got.dtype == q.dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        assert (got.float() - want.float())[live].abs().max().item() \
            <= grad_tol
    if with_bias:
        assert (dbias - ref[3])[live].abs().max().item() <= 1e-4
        assert (out.float() - ref_out)[-1].abs().max().item() <= max(
            out_tol, 2.0 ** -11)
        assert (lse - ref_lse)[-1].abs().max().item() <= 2.0 ** -10
        for got, want in zip((dq, dk, dv, dbias), ref):
            assert (got.float() - want.float())[-1].abs().max().item() <= \
                max(grad_tol, 2.0 ** -6)
    else:
        assert dbias is None


# The fp32 forward kernel's tile instantiations on an H100 (132 SMs): 16-row
# q tiles where B * H * ceil(Sq / 64) < 66, 64-row tiles otherwise; at D 64
# and 128, causal or not, ragged, Sq != Sk both ways.
F32_FWD_CASES = [
    # (B, H, Sq, Sk, D, causal, with_bias, views)
    (1, 32, 2048, 2048, 128, True, False, True),   # the Llama shape, 64 rows
    (2, 2, 100, 100, 128, True, True, False),      # ragged S 100, 16 rows
    (2, 2, 128, 384, 128, True, True, True),       # Sq < Sk, 16 rows
    (2, 2, 384, 128, 64, True, True, True),        # Sq > Sk, 16 rows
    (4, 24, 384, 300, 64, False, True, True),      # Sq > Sk ragged, 64 rows
    (3, 16, 300, 512, 128, True, True, False),     # Sq < Sk ragged, 64 rows
    (2, 12, 128, 128, 32, False, True, False),     # D 32: 64 rows always
    (2, 2, 100, 300, 32, True, True, True),        # D 32, Sq < Sk ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,with_bias,views",
                         F32_FWD_CASES)
def test_float32_forward_kernel_matches_plain_version(cuda, B, H, Sq, Sk, D,
                                                      causal, with_bias,
                                                      views):
    """The fp32 forward (out, lse) against the plain version: out 2e-5, lse
    1e-5; the all-padding row half an fp32 ulp at 1e4 (out) and one ulp
    (lse).  One launch, no operand realigned."""
    q, k, v, bias, _ = _unpacked_inputs(B, H, Sq, Sk, D, with_bias,
                                        "float32", cuda, 7 * Sq + Sk + D,
                                        views)
    w = tfa.flash_attention_unpacked
    before = (w.launches, w.realigned)
    out, lse = w(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert (w.launches, w.realigned) == (before[0] + 1, before[1])
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, bias, causal)
    live = slice(0, B - 1) if with_bias else slice(0, B)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out - ref_out)[live].abs().max().item() <= 2e-5
    assert (lse - ref_lse)[live].abs().max().item() <= 1e-5
    if with_bias:
        assert (out - ref_out)[-1].abs().max().item() <= 2.0 ** -11
        assert (lse - ref_lse)[-1].abs().max().item() <= 2.0 ** -10


# The fp32 backward kernels (fa_dkv_f32_kernel, fa_dq_f32_kernel: 8-warp
# blocks of 128 keys / q rows at D 64 and 64 at D 128, the other side
# streamed in 64-row tiles) at both D: causal or not, a bias with an
# all-padding last row or none, S 1, 65, 100 and 129 around the tile edges,
# Sq != Sk both ways, packed and unpacked, the [B, H, S, D] views rope
# leaves and contiguous tensors.
F32_BWD_CASES = [
    # (packed, B, H, Sq, Sk, D, causal, with_bias, views); packed cases
    # take H heads of D in one qkv [B, S, 3 H D] (Sq = Sk = S)
    (True, 8, 12, 512, 512, 64, False, True, False),   # BERT training
    (True, 2, 2, 65, 65, 128, True, True, False),
    (True, 3, 12, 1, 1, 64, False, True, False),
    (False, 1, 32, 2048, 2048, 128, True, False, True),  # the Llama shape
    (False, 2, 2, 100, 100, 64, True, True, False),
    (False, 2, 3, 1, 1, 128, False, True, True),
    (False, 2, 2, 65, 65, 64, True, False, True),
    (False, 2, 2, 65, 200, 128, True, True, False),    # Sq < Sk
    (False, 2, 2, 300, 65, 64, False, True, True),     # Sq > Sk
    (False, 1, 4, 130, 1, 64, True, False, False),     # one key
    (False, 2, 3, 100, 100, 32, False, True, True),    # D 32
    (False, 2, 2, 65, 200, 32, True, True, False),     # D 32, Sq < Sk
    (False, 2, 2, 129, 129, 64, True, True, True),     # 128-row edge
]


@pytest.mark.cuda
@pytest.mark.parametrize("packed,B,H,Sq,Sk,D,causal,with_bias,views",
                         F32_BWD_CASES)
def test_float32_backward_kernels_match_plain_version(cuda, packed, B, H, Sq,
                                                      Sk, D, causal,
                                                      with_bias, views):
    """dq, dk, dv and dbias from the fp32 dK/dV and dQ kernels against the
    plain backward: grads and dbias atol 1e-4 (sums of up to S O(1)
    products in another order); the all-padding row 2**-6 (p = exp(s -
    lse) with s and lse near -1e4, each good to an ulp there).  One launch
    of each kernel, no operand realigned."""
    seed = 11 * Sq + Sk + D
    if packed:
        w = (tfa.flash_attention_packed_dkv, tfa.flash_attention_packed_dq)
        qkv, bias, out, lse, dout = _bwd_inputs(B, Sq, H * D, H, causal,
                                                with_bias, "float32", cuda,
                                                seed)
    else:
        w = (tfa.flash_attention_unpacked_dkv,
             tfa.flash_attention_unpacked_dq)
        q, k, v, bias, dout = _unpacked_inputs(B, H, Sq, Sk, D, with_bias,
                                               "float32", cuda, seed, views)
        out, lse = tfa.flash_attention_reference(q, k, v, bias, causal)
    before = [(x.launches, x.realigned) for x in w]
    if packed:
        dqkv, dbias = tfa.flash_attention_packed_backward(
            qkv, bias, out, lse, dout, H, causal)
        ref_qkv, ref_db = tfa.flash_attention_packed_backward_reference(
            qkv, bias, out, lse, dout, H, causal)

        def split(x):  # dq, dk, dv as [B, H, S, D]
            return [x[..., j * H * D:(j + 1) * H * D].reshape(
                B, Sq, H, D).transpose(1, 2) for j in range(3)]

        got, ref = split(dqkv) + [dbias], split(ref_qkv) + [ref_db]
    else:
        got = list(tfa.flash_attention_unpacked_backward(
            q, k, v, bias, out, lse, dout, causal))
        ref = list(tfa.flash_attention_backward_reference(
            q, k, v, bias, out, lse, dout, causal))
    torch.cuda.synchronize()
    assert [(x.launches, x.realigned) for x in w] == [
        (n + 1, r) for n, r in before]
    live = slice(0, B - 1) if with_bias else slice(0, B)
    for name, g, want in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if want is None:
            assert g is None, name
            continue
        assert g.dtype == torch.float32 and g.shape == want.shape, name
        assert torch.isfinite(g).all(), name
        if B > 1 or not with_bias:
            assert (g - want)[live].abs().max().item() <= 1e-4, name
        if with_bias:
            assert (g - want)[-1].abs().max().item() <= 2.0 ** -6, name


@pytest.mark.cuda
def test_unpacked_wrapper_rejects_what_the_kernels_do_not_take(cuda):
    def t(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=cuda, dtype=dtype)

    q = t(1, 2, 32, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_unpacked(t(1, 2, 32, 96), t(1, 2, 32, 96),
                                     t(1, 2, 32, 96))
    # head_dim 48: no kernel takes it, and nothing falls back
    with pytest.raises(ValueError, match="take head_dim 32 / 64 / 128"):
        tfa.flash_attention_unpacked(t(1, 2, 32, 48), t(1, 2, 32, 48),
                                     t(1, 2, 32, 48))
    with pytest.raises(TypeError, match=NOT_TAKEN):
        tfa.flash_attention_unpacked(q.double(), q.double(), q.double())
    with pytest.raises(TypeError, match="one dtype"):
        tfa.flash_attention_unpacked(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous last dim"):
        tfa.flash_attention_unpacked(t(1, 2, 64, 32).transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="bias"):
        tfa.flash_attention_unpacked(q, q, q, torch.zeros(1, 31, device=cuda))
    with pytest.raises(ValueError, match="k must be"):
        tfa.flash_attention_unpacked(q, t(1, 2, 32, 128), q)
    out, lse = tfa.flash_attention_unpacked(q, q, q)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_unpacked_backward(q, q, q, None, out, lse[:, :1],
                                              out)


@pytest.mark.cuda
def test_flash_attention_op_on_the_card(cuda):
    """The flash_attention op launches the forward kernel once and its
    grad op both backward kernels (on the graph the forward kept, with no
    second forward), on the card (fp32 against the CPU: atol 1e-4);
    head_dim 96 raises; impl='xla' (the einsum formulation) launches no
    kernel and matches the CPU's."""
    import paddle_tpu_torch as tpt

    def run(place, D, impl="auto"):
        tpt.reset_unique_name()
        main = tpt.Program()
        block = main.global_block()
        for n in ("q", "k", "v"):
            block.create_var(name=n, shape=[2, 2, 80, D], dtype="float32",
                             is_data=True, stop_gradient=False)
        with tpt.program_guard(main, tpt.Program()):
            out = tpt.layers.flash_attention(block.var("q"), block.var("k"),
                                             block.var("v"), causal=True,
                                             impl=impl)
            loss = tpt.layers.mean(tpt.layers.elementwise_mul(out, out))
            tpt.append_backward(loss)
        rng = np.random.RandomState(D)
        feed = {n: rng.randn(2, 2, 80, D).astype("float32")
                for n in ("q", "k", "v")}
        return tpt.Executor(place).run(
            main, feed=feed, fetch_list=[out, "q@GRAD", "k@GRAD", "v@GRAD"],
            scope=tpt.Scope())

    before = (tfa.flash_attention_unpacked.launches,
              tfa.flash_attention_unpacked_dkv.launches,
              tfa.flash_attention_unpacked_dq.launches)
    got = run(None, 64)
    assert (tfa.flash_attention_unpacked.launches,
            tfa.flash_attention_unpacked_dkv.launches,
            tfa.flash_attention_unpacked_dq.launches) == (
                before[0] + 1, before[1] + 1, before[2] + 1)
    want = run(tpt.CPUPlace(), 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)
    # the op's lowering wraps the wrapper's ValueError with its context
    with pytest.raises(tpt.errors.EnforceNotMet, match="head_dim"):
        run(None, 96)
    before = tfa.flash_attention_unpacked.launches
    got = run(None, 64, impl="xla")
    assert tfa.flash_attention_unpacked.launches == before
    for g, w in zip(got, run(tpt.CPUPlace(), 64, impl="xla")):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the 16-bit tensor-core kernels (forward, dK/dV and dQ: wgmma, TMA loads),
# which every bf16 and fp16 call of the entries runs, packed or unpacked
# ---------------------------------------------------------------------------

TC_CASES = [
    # (B, H, Sq, Sk, D, causal, with_bias, views)
    (1, 32, 2048, 2048, 128, True, False, True),   # the Llama shape
    (2, 2, 128, 384, 128, True, True, True),       # Sq < Sk
    (2, 2, 384, 128, 128, False, True, False),     # Sq > Sk
    (2, 2, 384, 128, 128, True, False, True),      # Sq > Sk, causal
    (2, 2, 100, 100, 128, True, True, True),       # ragged S 100
    (3, 2, 100, 100, 64, False, True, False),
    (2, 3, 100, 100, 64, True, True, True),        # ragged S 100, D 64
    (2, 12, 512, 512, 32, False, True, False),     # MiniLM training, D 32
    (2, 3, 100, 300, 32, True, True, True),        # ragged, Sq < Sk, D 32
    (2, 2, 384, 128, 32, False, False, True),      # Sq > Sk, D 32
]


def _block_rel(got, want, block=128):
    """max over (batch, head, block of 128 rows) of ||got - want|| /
    ||want|| for [B, H, S, D] tensors: a long row's values (near
    sqrt(e / n) over n keys) are as small as the absolute limits, so the
    bf16 results are also held to 1e-2 of their own size (~4e-3 from
    rounding P or dS and the output to bf16), the fp16 ones to 1e-3
    (BLOCK_REL)."""
    B, H, S, D = want.shape
    pad = -S % block
    diff, ref = (torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
        B, H, -1, block * D) for t in (got.float() - want, want))
    num, den = diff.norm(dim=-1), ref.norm(dim=-1)
    return torch.where(num == 0, torch.zeros_like(num), num / den).max().item()


def _tc_counts():
    return tuple((w.launches, w.realigned) for w in (
        tfa.flash_attention_unpacked, tfa.flash_attention_unpacked_dkv,
        tfa.flash_attention_unpacked_dq))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,with_bias,views", TC_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_tensor_core_kernels_match_plain_versions(cuda, B, H, Sq, Sk, D,
                                                  causal, with_bias, views,
                                                  dtype):
    """The 16-bit forward (out, lse), dK/dV (dk, dv, the bias gradient's
    per-head partials) and dQ kernels against the plain versions on the
    same rounded inputs in float32: bf16 out atol 2e-2, dq, dk and dv
    5e-2 (P and dS are rounded to bf16 before their second product,
    ~2**-9 relative a term, and the outputs to bf16) and per 128-row block
    1e-2 of their own size, fp16 a quarter of each; lse and dbias 1e-4 /
    1e-5 (float32); the all-padding row of out to the 16-bit tolerance,
    its lse to one fp32 ulp at 1e4, its grads to 2**-6 or the 16-bit
    tolerance.  No operand needs realigning."""
    out_tol, grad_tol, rel = OUT_ATOL[dtype], GRAD_ATOL[dtype], \
        BLOCK_REL[dtype]
    q, k, v, bias, dout = _unpacked_inputs(B, H, Sq, Sk, D, with_bias,
                                           dtype, cuda, Sq + Sk + D,
                                           views)
    before = _tc_counts()
    out, lse = tfa.flash_attention_unpacked(q, k, v, bias, causal)
    scale = 1.0 / D ** 0.5
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    db_heads = (torch.empty((B, H, Sk), dtype=torch.float32, device=cuda)
                if with_bias else None)
    tfa.flash_attention_unpacked_dkv(q, k, v, bias, dout, lse, delta, dk, dv,
                                     db_heads, causal, scale)
    tfa.flash_attention_unpacked_dq(q, k, v, bias, dout, lse, delta, dq,
                                    causal, scale)
    torch.cuda.synchronize()
    assert _tc_counts() == tuple((n + 1, r) for n, r in before)
    f = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = tfa.flash_attention_reference(*f, bias, causal)
    ref = tfa.flash_attention_backward_reference(
        *f, bias, out.float(), lse, dout.float(), causal)
    live = slice(0, B - 1) if with_bias else slice(0, B)
    assert out.dtype == q.dtype
    assert (out.float() - ref_out)[live].abs().max().item() <= out_tol
    assert (lse - ref_lse)[live].abs().max().item() <= 1e-5
    assert _block_rel(out[live], ref_out[live]) <= rel
    for got, want in zip((dq, dk, dv), ref[:3]):
        assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
        assert (got.float() - want)[live].abs().max().item() <= grad_tol
        assert _block_rel(got[live], want[live]) <= rel
    if with_bias:
        dbias = db_heads.sum(1)
        assert (dbias - ref[3])[live].abs().max().item() <= 1e-4
        assert (out.float() - ref_out)[-1].abs().max().item() <= max(
            out_tol, 2.0 ** -11)
        assert (lse - ref_lse)[-1].abs().max().item() <= 2.0 ** -10
        for got, want in zip((dq, dk, dv, dbias), ref):
            assert (got.float() - want)[-1].abs().max().item() <= max(
                grad_tol, 2.0 ** -6)


@pytest.mark.cuda
def test_tensor_core_kernels_at_the_bert_training_shape(cuda):
    """Packed qkv [8, 512, 2304] bf16 (12 heads of 64) with a bias whose
    last row is all padding, the bias gradient on: the forward, the dq, dk
    and dv columns of d(qkv) and dbias against the plain versions,
    tolerances as above."""
    B, S, H, nh = 8, 512, 768, 12
    qkv, bias, out, lse, dout = _bwd_inputs(B, S, H, nh, False, True,
                                            "bfloat16", cuda, seed=5)
    got, got_lse = tfa.flash_attention_packed(qkv, bias, nh)
    dqkv, dbias = tfa.flash_attention_packed_backward(qkv, bias, out, lse,
                                                      dout, nh)
    torch.cuda.synchronize()
    ref_out, ref_lse = tfa.flash_attention_packed_reference(qkv.float(),
                                                            bias, nh)
    ref, ref_db = tfa.flash_attention_packed_backward_reference(
        qkv.float(), bias, out.float(), lse, dout.float(), nh)
    assert (got.float() - ref_out).abs().max().item() <= 2e-2
    assert (got_lse - ref_lse)[:-1].abs().max().item() <= 1e-5
    assert (got_lse - ref_lse)[-1].abs().max().item() <= 2.0 ** -10
    assert (dqkv.float() - ref)[:-1].abs().max().item() <= 5e-2
    assert (dqkv.float() - ref)[-1].abs().max().item() <= 5e-2
    assert (dbias - ref_db)[:-1].abs().max().item() <= 1e-4
    assert (dbias - ref_db)[-1].abs().max().item() <= 2.0 ** -6

    def heads(x):  # the live rows of [B, S, H] as [B - 1, nh, S, D]
        return x[:-1].reshape(B - 1, S, nh, H // nh).transpose(1, 2)

    assert _block_rel(heads(got), heads(ref_out)) <= 1e-2
    for j in range(3):  # dq, dk, dv
        cols = slice(j * H, (j + 1) * H)
        assert _block_rel(heads(dqkv[..., cols]), heads(ref[..., cols])) \
            <= 1e-2
    assert (tfa.flash_attention_packed.realigned,
            tfa.flash_attention_packed_dkv.realigned,
            tfa.flash_attention_packed_dq.realigned) == (0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_misaligned_operands_are_realigned_and_counted(cuda, dtype):
    """A view one element (2 or 4 bytes) into its storage cannot be read
    by 16-byte loads (TMA in 16 bits, cp.async in the fp32 forward): the
    wrapper copies it to contiguous memory, counts the copy in
    ``.realigned``, and the result still matches the plain version.  The
    unpacked forward, dK/dV and dQ (a misaligned q), then the packed
    forward and dK/dV (a misaligned qkv).  Tolerances as above: bf16 out
    2e-2, grads 5e-2; fp16 a quarter of those; fp32 out 2e-5, grads 1e-4;
    lse 1e-5."""
    dt = getattr(torch, dtype)
    out_tol, grad_tol = OUT_ATOL[dtype], GRAD_ATOL[dtype]
    B, H, S, D = 2, 2, 128, 64
    n = B * H * S * D
    rng = np.random.RandomState(3)
    flat = torch.from_numpy(rng.randn(n + 1).astype("float32")).to(cuda, dt)
    q = flat[1:].view(B, H, S, D)
    assert not tfa.tma_aligned(q)
    k, v, dout = (torch.from_numpy(rng.randn(B, H, S, D).astype(
        "float32")).to(cuda, dt) for _ in range(3))
    wrappers = (tfa.flash_attention_unpacked, tfa.flash_attention_unpacked_dkv,
                tfa.flash_attention_unpacked_dq)
    before = [w.realigned for w in wrappers]
    out, lse = tfa.flash_attention_unpacked(q, k, v, None, True)
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    dq, dk, dv = (torch.empty_like(k) for _ in range(3))
    tfa.flash_attention_unpacked_dkv(q, k, v, None, dout, lse, delta, dk, dv,
                                     None, True, D ** -0.5)
    tfa.flash_attention_unpacked_dq(q, k, v, None, dout, lse, delta, dq,
                                    True, D ** -0.5)
    torch.cuda.synchronize()
    assert [w.realigned for w in wrappers] == [r + 1 for r in before]
    f = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = tfa.flash_attention_reference(*f, None, True)
    ref = tfa.flash_attention_backward_reference(
        *f, None, out.float(), lse, dout.float(), True)
    assert (out.float() - ref_out).abs().max().item() <= out_tol
    assert (lse - ref_lse).abs().max().item() <= 1e-5
    for got, want in zip((dq, dk, dv), ref[:3]):
        assert (got.float() - want).abs().max().item() <= grad_tol

    Bp, Sp, Hp, nh = 2, 64, 256, 2
    flat = torch.from_numpy(rng.randn(Bp * Sp * 3 * Hp + 1).astype(
        "float32")).to(cuda, dt)
    qkv = flat[1:].view(Bp, Sp, 3 * Hp)
    assert not tfa.tma_aligned(qkv)
    out, lse = tfa.flash_attention_packed_reference(qkv.float(), None, nh)
    before = tfa.flash_attention_packed.realigned
    got, got_lse = tfa.flash_attention_packed(qkv, None, nh)
    torch.cuda.synchronize()
    assert tfa.flash_attention_packed.realigned == before + 1
    assert (got.float() - out).abs().max().item() <= out_tol
    assert (got_lse - lse).abs().max().item() <= 1e-5
    out = out.to(dt)
    dout = torch.from_numpy(rng.randn(Bp, Sp, Hp).astype("float32")).to(
        cuda, dt)
    tfa.check_backward_inputs(qkv, None, out, lse, dout, nh)
    delta = tfa.backward_delta(out, dout, nh)
    dqkv = torch.zeros_like(qkv)
    before = tfa.flash_attention_packed_dkv.realigned
    tfa.flash_attention_packed_dkv(qkv, None, dout, lse, delta, dqkv, None,
                                   nh, False, (Hp // nh) ** -0.5)
    torch.cuda.synchronize()
    assert tfa.flash_attention_packed_dkv.realigned == before + 1
    ref, _ = tfa.flash_attention_packed_backward_reference(
        qkv.float(), None, out.float(), lse, dout.float(), nh)
    assert (dqkv.float() - ref)[..., Hp:].abs().max().item() <= grad_tol
