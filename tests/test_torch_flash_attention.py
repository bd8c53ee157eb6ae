"""The port's packed flash-attention plain version against the JAX
package's Pallas kernel (interpret mode, as tests/test_attention.py runs
it on the CPU) and its blockwise_attention scan.

Inputs come from numpy with a fixed seed and go to both packages, in
fp32 and in fp16; atol 1e-5 on out and on the log-sum-exp (the two sides
sum in different orders; values are O(1) for out and O(5) for lse).  A
batch row whose keys are all padding has every score near -1e4, where one
fp32 ulp is 2**-10: those rows are held to half an ulp there on out and
one ulp on the lse, set from that resolution, not from a run.  In fp16
both sides take the same fp16-rounded inputs, compute in fp32 and round
out once to fp16 (the lse stays fp32): out is held besides to rel 2**-10,
one fp16 ulp, the most that one rounding of two fp32 values 1e-5 apart
can part them.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

# the module (its package re-exports a function of the same name)
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

ATOL = 1e-5
DEAD_OUT_ATOL = 2.0 ** -11   # half an ulp of fp32 at 1e4
DEAD_LSE_ATOL = 2.0 ** -10   # one ulp of fp32 at 1e4
B, S = 2, 64
DEAD = 1  # the batch row _inputs(dead_row=True) pads out entirely
DTYPES = ["float32", "float16"]
OUT_RTOL = {"float32": 0.0, "float16": 2.0 ** -10}  # one fp16 ulp


def _inputs(H, seed, with_bias, dead_row=False):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, S, 3 * H).astype("float32")
    bias = None
    if with_bias:
        mask = (rng.rand(B, S) > 0.25).astype("float32")
        if dead_row:
            mask[DEAD] = 0.0  # an all-padding row: softmax goes uniform
        bias = mask * 1e4 - 1e4  # models/bert.py's additive mask
    return qkv, bias


CASES = [
    # (H, num_heads, with_bias, causal, dead_row)
    (128, 2, False, False, False),
    (128, 2, False, True, False),
    (128, 2, True, False, False),
    (128, 2, True, True, True),
    (256, 2, False, False, False),
    (256, 2, True, False, True),
    (256, 2, True, True, False),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,nh,with_bias,causal,dead_row", CASES)
def test_reference_matches_pallas_interpret(H, nh, with_bias, causal,
                                            dead_row, dtype):
    qkv, bias = _inputs(H, seed=H + nh + causal, with_bias=with_bias,
                        dead_row=dead_row)
    qkv = qkv.astype(dtype)
    j_out, j_lse = jfa._packed_forward(
        jnp.asarray(qkv), nh, causal, None, 64, 32, True,
        bias=None if bias is None else jnp.asarray(bias))
    t_out, t_lse = tfa.flash_attention_packed_reference(
        torch.from_numpy(qkv), None if bias is None else
        torch.from_numpy(bias), nh, causal, None)
    # TPU layout [B, H/128, 128/D, S] is the port's [B, num_heads, S]
    D = H // nh
    t_lse_tpu = t_lse.numpy().reshape(B, H // 128, 128 // D, S)
    live = [b for b in range(B) if not (dead_row and b == DEAD)]
    j_out, j_lse = np.asarray(j_out), np.asarray(j_lse)
    assert t_out.numpy().dtype == j_out.dtype == qkv.dtype
    assert t_lse.dtype == torch.float32
    rtol = OUT_RTOL[dtype]
    t_out = t_out.float().numpy()
    j_out = j_out.astype("float32")
    np.testing.assert_allclose(t_out[live], j_out[live], atol=ATOL,
                               rtol=rtol)
    np.testing.assert_allclose(t_lse_tpu[live], j_lse[live], atol=ATOL,
                               rtol=0)
    if dead_row:
        np.testing.assert_allclose(t_out[DEAD], j_out[DEAD],
                                   atol=DEAD_OUT_ATOL, rtol=rtol)
        np.testing.assert_allclose(t_lse_tpu[DEAD], j_lse[DEAD],
                                   atol=DEAD_LSE_ATOL, rtol=0)


@pytest.mark.parametrize("causal,kv_offset,with_bias",
                         [(False, 0, False), (True, 0, True),
                          (True, 16, False)])
def test_blockwise_attention_matches_jax(causal, kv_offset, with_bias):
    rng = np.random.RandomState(7)
    q = rng.randn(2, 3, 48, 64).astype("float32")
    k = rng.randn(2, 3, 48, 64).astype("float32")
    v = rng.randn(2, 3, 48, 64).astype("float32")
    bias = (np.where(rng.rand(2, 48) > 0.3, 0.0, -1e4).astype("float32")
            if with_bias else None)
    j_out, (j_m, j_l) = jfa.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_k=16, kv_offset=kv_offset,
        bias=None if bias is None else jnp.asarray(bias))
    t_out, (t_m, t_l) = tfa.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_k=16, kv_offset=kv_offset,
        bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(t_l.numpy(), np.asarray(j_l), rtol=1e-5)


def test_reference_lse_matches_blockwise_stats():
    qkv, bias = _inputs(128, seed=3, with_bias=True)
    x = qkv.reshape(B, S, 3, 2, 64)
    q, k, v = (np.ascontiguousarray(x[:, :, i].transpose(0, 2, 1, 3))
               for i in range(3))
    j_out, (j_m, j_l) = jfa.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jnp.asarray(bias))
    t_out, t_lse = tfa.flash_attention_packed_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias), 2)
    np.testing.assert_allclose(
        t_out.numpy(),
        np.asarray(j_out).transpose(0, 2, 1, 3).reshape(B, S, 128),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_lse.numpy(),
                               np.asarray(j_m) + np.log(np.asarray(j_l)),
                               atol=ATOL, rtol=0)


def test_wrapper_on_cpu_takes_plain_version_and_launches_nothing():
    qkv, bias = _inputs(128, seed=5, with_bias=True)
    launches = tfa.flash_attention_packed.launches
    calls = tfa.flash_attention_packed_reference.calls
    out, lse = tfa.flash_attention_packed(
        torch.from_numpy(qkv), torch.from_numpy(bias), 2, False, None)
    ref_out, ref_lse = tfa.flash_attention_packed_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias), 2, False, None)
    assert tfa.flash_attention_packed.launches == launches
    assert tfa.flash_attention_packed_reference.calls == calls + 2
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    assert out.shape == (B, S, 128) and lse.shape == (B, 2, S)
    assert lse.dtype == torch.float32


def test_wrapper_rejects_other_devices():
    qkv = torch.empty((2, 16, 384), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_packed(qkv, None, 2)


def test_reference_bfloat16_tracks_float32():
    """bf16 inputs compute in fp32 and round only the output."""
    qkv, bias = _inputs(128, seed=9, with_bias=True, dead_row=True)
    q16 = torch.from_numpy(qkv).to(torch.bfloat16)
    out16, lse16 = tfa.flash_attention_packed_reference(
        q16, torch.from_numpy(bias), 2)
    out32, lse32 = tfa.flash_attention_packed_reference(
        q16.float(), torch.from_numpy(bias), 2)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               atol=2e-2, rtol=0)
    np.testing.assert_allclose(lse16.numpy(), lse32.numpy(), atol=0,
                               rtol=0)


def test_reference_float16_rounds_once():
    """fp16 inputs compute in fp32 and round only the output, to nearest:
    within half an fp16 ulp of the fp32 result (2**-11 relative, 2**-25
    absolute among the subnormals); the lse is the fp32 one."""
    qkv, bias = _inputs(128, seed=9, with_bias=True, dead_row=True)
    q16 = torch.from_numpy(qkv).to(torch.float16)
    out16, lse16 = tfa.flash_attention_packed_reference(
        q16, torch.from_numpy(bias), 2)
    out32, lse32 = tfa.flash_attention_packed_reference(
        q16.float(), torch.from_numpy(bias), 2)
    assert out16.dtype == torch.float16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               atol=2.0 ** -25, rtol=2.0 ** -11)
    np.testing.assert_array_equal(lse16.numpy(), lse32.numpy())
