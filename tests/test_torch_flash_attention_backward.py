"""The port's packed flash-attention backward against the JAX package.

The plain backward (``flash_attention_packed_backward_reference``) is held
to the Pallas backward kernels (``_packed_backward`` in interpret mode, as
tests/test_attention.py runs them on the CPU) and to ``jax.grad`` of
``flash_attention_packed_bias``; the ``torch.autograd.Function`` that the
``flash_attention_qkv`` op runs is held to both and to autograd through
the plain forward.  Inputs come from numpy with a fixed seed; fp32 and
fp16, S 64 with blocks of 32.  Tolerances are stated where they are set.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

# the module (its package re-exports a function of the same name)
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

B, S = 2, 64
DEAD = 1  # the batch row _inputs(dead_row=True) pads out entirely


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

BWD_ATOL = 5e-5   # dqkv and dbias: sums of 64 O(1) products, other order
# the all-padding row: p = exp(s - lse) with s and lse near -1e4, each
# carrying up to an ulp (2**-10) there, so p is good to ~2**-9 relative
BWD_DEAD_ATOL = 2.0 ** -6
# fp16: both sides take the same fp16-rounded inputs, compute in fp32 and
# round dqkv once to fp16 (dbias stays in the bias's fp32), so dqkv is
# held besides to rel 2**-10, one fp16 ulp
GRAD_RTOL = {"float32": 0.0, "float16": 2.0 ** -10}
# through autograd each side also rounds its own forward's out to fp16,
# and the two outs may part by an fp16 ulp (2**-11 of O(1) values); it
# enters every row's delta = rowsum(dO * O) and so each dS, and p sums
# to 1 over a row: 2**-12 on the fp16 grads (readings up to 7.6e-5)
AUTOGRAD_ATOL = {"float32": BWD_ATOL, "float16": 2.0 ** -12}
DTYPES = ["float32", "float16"]

BWD_CASES = [
    # (H, num_heads, with_bias, causal, dead_row): each width (two heads
    # per 128-lane chunk, and D 128) with and without bias, causal and
    # not, and with an all-padding row
    (128, 2, False, False, False),
    (128, 2, True, True, True),
    (256, 2, False, True, False),
    (256, 2, True, False, True),
]


def _bwd_case(H, nh, with_bias, causal, dead_row, seed, dtype="float32"):
    """Inputs and a cotangent in `dtype`, and the forward's out (in
    `dtype`) and lse [B, nh, S] (fp32) from the JAX package's
    blockwise_attention (the Pallas forward's equality to it is held
    above; interpret mode would triple this file's time)."""
    qkv, bias = _inputs(H, seed, with_bias, dead_row)
    qkv = qkv.astype(dtype)
    g = np.random.RandomState(seed + 1).randn(B, S, H).astype(dtype)
    D = H // nh
    x = qkv.reshape(B, S, 3, nh, D)
    q, k, v = (jnp.asarray(x[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    out, (m, l) = jfa.blockwise_attention(
        q, k, v, causal=causal, bias=None if bias is None
        else jnp.asarray(bias))
    out = np.asarray(out).transpose(0, 2, 1, 3).reshape(B, S, H)
    lse = np.asarray(m) + np.log(np.asarray(l))
    return qkv, bias, g, out.astype(dtype), lse.astype("float32")


def _assert_rows(got, want, dead_row, atol=BWD_ATOL, rtol=0.0):
    got, want = np.asarray(got, "float32"), np.asarray(want, "float32")
    live = [b for b in range(B) if not (dead_row and b == DEAD)]
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=rtol)
    if dead_row:
        np.testing.assert_allclose(got[DEAD], want[DEAD], atol=BWD_DEAD_ATOL,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,nh,with_bias,causal,dead_row", BWD_CASES)
def test_backward_reference_matches_pallas_interpret(H, nh, with_bias,
                                                     causal, dead_row,
                                                     dtype):
    qkv, bias, g, out, lse = _bwd_case(H, nh, with_bias, causal, dead_row,
                                       seed=H + 3 * causal + with_bias,
                                       dtype=dtype)
    # the TPU kernels' lse layout [B, H/128, 128/D, S] is [B, nh, S]
    j_dqkv, j_db = jfa._packed_backward(
        jnp.asarray(qkv), nh, jnp.asarray(out),
        jnp.asarray(lse.reshape(B, H // 128, 128 // (H // nh), S)),
        jnp.asarray(g), causal, None, 32, 32, True,
        bias=None if bias is None else jnp.asarray(bias))
    calls = tfa.flash_attention_packed_backward_reference.calls
    t_dqkv, t_db = tfa.flash_attention_packed_backward_reference(
        torch.from_numpy(qkv), None if bias is None else
        torch.from_numpy(bias), torch.from_numpy(out),
        torch.from_numpy(lse), torch.from_numpy(g), nh,
        causal, None)
    assert tfa.flash_attention_packed_backward_reference.calls == calls + 1
    assert t_dqkv.shape == (B, S, 3 * H)
    assert t_dqkv.numpy().dtype == np.asarray(j_dqkv).dtype == qkv.dtype
    _assert_rows(t_dqkv.float().numpy(), j_dqkv, dead_row,
                 rtol=GRAD_RTOL[dtype])
    if with_bias:
        assert t_db.dtype == torch.float32
        _assert_rows(t_db.numpy(), j_db, dead_row)
    else:
        assert t_db is None and j_db is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,nh,causal", [(128, 2, True)])
def test_autograd_function_matches_jax_grad(H, nh, causal, dtype):
    """d/d(qkv, bias) of <out, g> through the port's autograd.Function
    (plain versions on the CPU) against jax.grad of
    flash_attention_packed_bias in interpret mode.  In fp16 the grads of
    qkv are fp16 and the bias's fp32, both held besides to rel one fp16
    ulp (see AUTOGRAD_ATOL)."""
    import jax

    qkv, bias = _inputs(H, seed=21 + H, with_bias=True)
    qkv = qkv.astype(dtype)
    g = np.random.RandomState(5).randn(B, S, H).astype(dtype)

    def f(x, b):
        return (jfa.flash_attention_packed_bias(
            x, b, nh, causal, None, 32, 32, True) * g).sum()

    j_dx, j_db = jax.grad(f, argnums=(0, 1))(jnp.asarray(qkv),
                                             jnp.asarray(bias))
    x = torch.from_numpy(qkv).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    (tfa.flash_attention_packed_autograd(x, b, nh, causal).float()
     * torch.from_numpy(g).float()).sum().backward()
    assert x.grad.dtype == x.dtype and b.grad.dtype == torch.float32
    np.testing.assert_allclose(x.grad.float().numpy(),
                               np.asarray(j_dx, "float32"),
                               atol=AUTOGRAD_ATOL[dtype],
                               rtol=GRAD_RTOL[dtype])
    # the bias grad stays fp32 but sums the dS that the outs' ulp moved
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(j_db),
                               atol=BWD_ATOL, rtol=GRAD_RTOL[dtype])


@pytest.mark.parametrize("with_bias,causal", [(True, False), (False, True)])
def test_autograd_function_matches_autograd_of_plain_forward(with_bias,
                                                             causal):
    """On the CPU the Function's backward (the plain backward) equals
    torch.autograd through the plain forward's blockwise scan."""
    qkv, bias = _inputs(128, seed=31, with_bias=with_bias)
    g = torch.from_numpy(np.random.RandomState(6).randn(B, S, 128)
                         .astype("float32"))
    grads = []
    for fn in (lambda x, b: tfa.flash_attention_packed_autograd(
                   x, b, 2, causal),
               lambda x, b: tfa.flash_attention_packed_reference(
                   x, b, 2, causal)[0]):
        x = torch.from_numpy(qkv).requires_grad_(True)
        b = (None if bias is None
             else torch.from_numpy(bias).requires_grad_(True))
        (fn(x, b) * g).sum().backward()
        grads.append((x.grad, None if b is None else b.grad))
    np.testing.assert_allclose(grads[0][0].numpy(), grads[1][0].numpy(),
                               atol=BWD_ATOL, rtol=0)
    if with_bias:
        np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(),
                                   atol=BWD_ATOL, rtol=0)


def test_backward_wrapper_on_cpu_takes_plain_version():
    qkv, bias = _inputs(128, seed=41, with_bias=True)
    qkv, bias = torch.from_numpy(qkv), torch.from_numpy(bias)
    out, lse = tfa.flash_attention_packed_reference(qkv, bias, 2)
    dout = torch.ones_like(out)
    counts = (tfa.flash_attention_packed_dkv.launches,
              tfa.flash_attention_packed_dq.launches)
    calls = tfa.flash_attention_packed_backward_reference.calls
    dqkv, db = tfa.flash_attention_packed_backward(qkv, bias, out, lse, dout,
                                                   2)
    _, none_db = tfa.flash_attention_packed_backward(
        qkv, bias, out, lse, dout, 2, need_dbias=False)
    ref, ref_db = tfa.flash_attention_packed_backward_reference(
        qkv, bias, out, lse, dout, 2)
    assert (tfa.flash_attention_packed_dkv.launches,
            tfa.flash_attention_packed_dq.launches) == counts
    assert tfa.flash_attention_packed_backward_reference.calls == calls + 3
    assert torch.equal(dqkv, ref) and torch.equal(db, ref_db)
    assert none_db is None


def test_backward_reference_zeroes_rows_without_a_live_key():
    """A row whose lse is -inf (no live key, the forward kernel's
    convention) gets p = 0: finite, zero gradients."""
    qkv, _ = _inputs(128, seed=51, with_bias=False)
    qkv = torch.from_numpy(qkv)
    bias = torch.zeros(B, S)
    bias[DEAD] = float("-inf")
    out, lse = tfa.flash_attention_packed_reference(qkv, torch.zeros(B, S), 2)
    lse[DEAD] = float("-inf")
    dqkv, db = tfa.flash_attention_packed_backward_reference(
        qkv, bias, out, lse, torch.ones_like(out), 2)
    assert torch.isfinite(dqkv).all() and torch.isfinite(db).all()
    assert not dqkv[DEAD].any() and not db[DEAD].any()
