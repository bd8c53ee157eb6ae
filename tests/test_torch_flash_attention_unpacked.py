"""The port's unpacked flash attention (q [B,H,Sq,D], k/v [B,H,Sk,D])
against the JAX package.

The plain forward and backward (``flash_attention_reference``,
``flash_attention_backward_reference``) are held to the Pallas kernels
``_fa_fwd_kernel`` / ``_fa_dkv_kernel`` / ``_fa_dq_kernel`` in interpret
mode (``_flash_forward``, ``_flash_backward``, with the small blocks
tests/test_attention.py uses), and the ``torch.autograd.Function`` that
the ``flash_attention`` op runs is held to ``jax.grad`` through the
``flash_attention`` / ``flash_attention_bias`` custom_vjp.  Inputs come
from numpy with a fixed seed; fp32 and fp16.

Tolerances: atol 1e-5 on out and lse and 5e-5 on the gradients (sums of
up to 128 O(1) products in another order).  A batch row whose keys are all
padding scores near -1e4, where one fp32 ulp is 2**-10: that row is held
to half an ulp on out, one on the lse, and 2**-6 on the gradients
(p = exp(s - lse) with s and lse each carrying up to an ulp).  In fp16
both sides take the same fp16-rounded q, k, v and dO, compute in fp32 and
round out, dq, dk and dv once to fp16 (lse and dbias stay fp32): those
are held besides to rel 2**-10, one fp16 ulp.  Through autograd each
side also rounds its own forward's out, which may part by an fp16 ulp
and enters every delta = rowsum(dO * O): 2**-12 on the fp16 grads and
rel 2**-10 on dbias there.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

# the module (its package re-exports a function of the same name)
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

B, H = 2, 2
BQ, BK = 32, 32          # Pallas blocks: several per sequence
ATOL, GRAD_ATOL = 1e-5, 5e-5
DEAD_OUT_ATOL = 2.0 ** -11   # half an ulp of fp32 at 1e4
DEAD_LSE_ATOL = 2.0 ** -10   # one ulp of fp32 at 1e4
DEAD_GRAD_ATOL = 2.0 ** -6
DEAD = 1  # the batch row an all-padding bias masks out entirely
DTYPES = ["float32", "float16"]
RTOL = {"float32": 0.0, "float16": 2.0 ** -10}  # one fp16 ulp
AUTOGRAD_ATOL = {"float32": GRAD_ATOL, "float16": 2.0 ** -12}

CASES = [
    # (Sq, Sk, D, causal, with_bias, dead_row): D 16, 32, 64 and 128, causal
    # or not, bias or not, Sq = Sk and Sq != Sk both ways
    (64, 64, 16, False, False, False),
    (64, 64, 64, True, False, False),
    (64, 96, 16, False, True, True),
    (96, 64, 64, True, True, False),
    (64, 128, 64, True, False, False),
    (64, 64, 128, True, True, True),
    # D 32 (MiniLM-L12-H384's heads, the kernels' 64-byte-swizzled tiles)
    (64, 64, 32, True, True, True),
    (64, 96, 32, False, True, True),
    (96, 64, 32, True, False, False),
    (64, 64, 32, False, False, False),
]
IDS = [f"Sq{c[0]}_Sk{c[1]}_D{c[2]}_{'causal' if c[3] else 'full'}"
       f"{'_bias' if c[4] else ''}{'_dead' if c[5] else ''}" for c in CASES]


def _inputs(Sq, Sk, D, with_bias, dead_row, seed, dtype="float32"):
    """q, k, v and a cotangent in `dtype`; the bias in fp32."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Sq, D).astype(dtype)
    k = rng.randn(B, H, Sk, D).astype(dtype)
    v = rng.randn(B, H, Sk, D).astype(dtype)
    g = rng.randn(B, H, Sq, D).astype(dtype)
    bias = None
    if with_bias:
        mask = (rng.rand(B, Sk) > 0.25).astype("float32")
        if dead_row:
            mask[DEAD] = 0.0  # an all-padding row: softmax goes uniform
        bias = mask * 1e4 - 1e4
    return q, k, v, g, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_rows(got, want, dead_row, atol, dead_atol, rtol=0.0):
    got, want = np.asarray(got, "float32"), np.asarray(want, "float32")
    live = [b for b in range(B) if not (dead_row and b == DEAD)]
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=rtol)
    if dead_row:
        np.testing.assert_allclose(got[DEAD], want[DEAD], atol=dead_atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,D,causal,with_bias,dead_row", CASES,
                         ids=IDS)
def test_forward_reference_matches_pallas_interpret(Sq, Sk, D, causal,
                                                    with_bias, dead_row,
                                                    dtype):
    q, k, v, _, bias = _inputs(Sq, Sk, D, with_bias, dead_row, seed=Sq + D,
                               dtype=dtype)
    j_out, j_lse = jfa._flash_forward(_j(q), _j(k), _j(v), causal, None, BQ,
                                      BK, True, bias=_j(bias))
    calls = tfa.flash_attention_reference.calls
    t_out, t_lse = tfa.flash_attention_reference(_t(q), _t(k), _t(v),
                                                 _t(bias), causal)
    assert tfa.flash_attention_reference.calls == calls + 1
    assert t_out.shape == (B, H, Sq, D) and t_lse.shape == (B, H, Sq)
    assert t_lse.dtype == torch.float32
    assert t_out.numpy().dtype == np.asarray(j_out).dtype == q.dtype
    _assert_rows(t_out.float(), j_out, dead_row, ATOL, DEAD_OUT_ATOL,
                 RTOL[dtype])
    _assert_rows(t_lse.numpy(), j_lse, dead_row, ATOL, DEAD_LSE_ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,D,causal,with_bias,dead_row", CASES,
                         ids=IDS)
def test_backward_reference_matches_pallas_interpret(Sq, Sk, D, causal,
                                                     with_bias, dead_row,
                                                     dtype):
    """dq, dk, dv and dbias of the plain backward against ``_flash_backward``
    in interpret mode, both from the JAX forward's out and lse."""
    q, k, v, g, bias = _inputs(Sq, Sk, D, with_bias, dead_row,
                               seed=3 * Sq + D, dtype=dtype)
    out, lse = jfa._flash_forward(_j(q), _j(k), _j(v), causal, None, BQ, BK,
                                  True, bias=_j(bias))
    want = jfa._flash_backward(_j(q), _j(k), _j(v), out, lse, _j(g), causal,
                               None, BQ, BK, True, bias=_j(bias))
    calls = tfa.flash_attention_backward_reference.calls
    got = tfa.flash_attention_backward_reference(
        _t(q), _t(k), _t(v), _t(bias), _t(np.array(out)),
        _t(np.array(lse)), _t(g), causal)
    assert tfa.flash_attention_backward_reference.calls == calls + 1
    for name, t, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert t.shape == w.shape, name
        assert t.numpy().dtype == np.asarray(w).dtype == q.dtype, name
        _assert_rows(t.float(), w, dead_row, GRAD_ATOL, DEAD_GRAD_ATOL,
                     RTOL[dtype])
    if with_bias:
        assert got[3].dtype == torch.float32
        _assert_rows(got[3].numpy(), want[3], dead_row, GRAD_ATOL,
                     DEAD_GRAD_ATOL)
    else:
        assert got[3] is None and want[3] is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,D,causal,with_bias,dead_row",
                         [CASES[1], CASES[3], CASES[4], CASES[6]],
                         ids=[IDS[1], IDS[3], IDS[4], IDS[6]])
def test_autograd_function_matches_jax_grad(Sq, Sk, D, causal, with_bias,
                                            dead_row, dtype):
    """d/d(q, k, v, bias) of <out, g> through the port's autograd.Function
    (plain versions on the CPU) against jax.grad of the custom_vjp
    ``flash_attention`` / ``flash_attention_bias`` in interpret mode."""
    q, k, v, g, bias = _inputs(Sq, Sk, D, with_bias, dead_row,
                               seed=5 * Sq + D, dtype=dtype)
    if bias is None:
        def f(q, k, v):
            return (jfa.flash_attention(q, k, v, causal, None, BQ, BK, True)
                    * g).sum()
        want = jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    else:
        def f(q, k, v, b):
            return (jfa.flash_attention_bias(q, k, v, b, causal, None, BQ,
                                             BK, True) * g).sum()
        want = jax.grad(f, argnums=(0, 1, 2, 3))(_j(q), _j(k), _j(v),
                                                 _j(bias))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    (tfa.flash_attention_autograd(*xs, b, causal).float()
     * _t(g).float()).sum().backward()
    got = [x.grad for x in xs] + ([] if b is None else [b.grad])
    assert len(got) == len(want)
    for t, w in zip(got, want):
        assert t.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_allclose(t.float().numpy(), np.asarray(w, "float32"),
                                   atol=AUTOGRAD_ATOL[dtype],
                                   rtol=RTOL[dtype])


@pytest.mark.parametrize("with_bias,causal", [(True, False), (False, True)])
def test_autograd_function_matches_autograd_of_plain_forward(with_bias,
                                                             causal):
    """On the CPU the Function's backward (the plain backward) equals
    torch.autograd through the plain forward's blockwise scan."""
    q, k, v, g, bias = _inputs(64, 96, 64, with_bias, False, seed=7)
    grads = []
    for fn in (lambda *a: tfa.flash_attention_autograd(*a, causal),
               lambda *a: tfa.flash_attention_reference(*a, causal)[0]):
        xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        b = (None if bias is None
             else torch.from_numpy(bias).requires_grad_(True))
        (fn(*xs, b) * _t(g)).sum().backward()
        grads.append([x.grad for x in xs] + ([] if b is None else [b.grad]))
    for a, w in zip(*grads):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   rtol=0)


def test_bias_grad_only_when_autograd_asks():
    """A bias that does not require grad gets none computed: the backward
    wrapper's need_dbias follows ctx.needs_input_grad."""
    q, k, v, g, bias = _inputs(64, 64, 16, True, False, seed=9)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = torch.from_numpy(bias)
    (tfa.flash_attention_autograd(*xs, b) * _t(g)).sum().backward()
    assert b.grad is None and all(x.grad is not None for x in xs)
    out, lse = tfa.flash_attention_unpacked(*(_t(x) for x in (q, k, v)), b)
    *_, none_db = tfa.flash_attention_unpacked_backward(
        _t(q), _t(k), _t(v), b, out, lse, _t(g), need_dbias=False)
    assert none_db is None


def test_wrappers_on_cpu_take_plain_versions_and_launch_nothing():
    q, k, v, g, bias = (_t(x) for x in _inputs(64, 96, 64, True, False, 11))
    launches = (tfa.flash_attention_unpacked.launches,
                tfa.flash_attention_unpacked_dkv.launches,
                tfa.flash_attention_unpacked_dq.launches)
    calls = (tfa.flash_attention_reference.calls,
             tfa.flash_attention_backward_reference.calls)
    out, lse = tfa.flash_attention_unpacked(q, k, v, bias, True)
    grads = tfa.flash_attention_unpacked_backward(q, k, v, bias, out, lse, g,
                                                  True)
    ref_out, ref_lse = tfa.flash_attention_reference(q, k, v, bias, True)
    ref = tfa.flash_attention_backward_reference(q, k, v, bias, out, lse, g,
                                                 True)
    assert (tfa.flash_attention_unpacked.launches,
            tfa.flash_attention_unpacked_dkv.launches,
            tfa.flash_attention_unpacked_dq.launches) == launches
    assert (tfa.flash_attention_reference.calls,
            tfa.flash_attention_backward_reference.calls) == (
                calls[0] + 2, calls[1] + 2)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    for a, w in zip(grads, ref):
        assert torch.equal(a, w)


def test_wrappers_reject_other_devices():
    x = torch.empty((1, 2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_unpacked(x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_unpacked_backward(x, x, x, None, x,
                                              x[..., 0], x)


def test_backward_reference_zeroes_rows_without_a_live_key():
    """A row whose lse is -inf (no live key, the forward kernel's
    convention) gets p = 0: finite, zero gradients for it."""
    q, k, v, g, _ = (_t(x) for x in _inputs(32, 32, 16, False, False, 13))
    bias = torch.zeros(B, 32)
    bias[DEAD] = float("-inf")
    out, lse = tfa.flash_attention_reference(q, k, v, torch.zeros(B, 32))
    lse[DEAD] = float("-inf")
    dq, dk, dv, db = tfa.flash_attention_backward_reference(
        q, k, v, bias, out, lse, g)
    for t in (dq, dk, dv, db):
        assert torch.isfinite(t).all() and not t[DEAD].any()


def test_reference_bfloat16_tracks_float32():
    """bf16 inputs compute in fp32 and round only the outputs."""
    q, k, v, g, bias = (_t(x) for x in _inputs(64, 64, 64, True, False, 15))
    q16, k16, v16 = (x.to(torch.bfloat16) for x in (q, k, v))
    out16, lse16 = tfa.flash_attention_reference(q16, k16, v16, bias, True)
    out32, lse32 = tfa.flash_attention_reference(q16.float(), k16.float(),
                                                 v16.float(), bias, True)
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(),
                               atol=2e-2, rtol=0)
    np.testing.assert_array_equal(lse16.numpy(), lse32.numpy())
    grads16 = tfa.flash_attention_backward_reference(
        q16, k16, v16, bias, out16, lse16, g.to(torch.bfloat16), True)
    assert all(t.dtype == torch.bfloat16 for t in grads16[:3])
    assert grads16[3].dtype == torch.float32
