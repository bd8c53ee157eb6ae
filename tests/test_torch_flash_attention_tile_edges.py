"""The port's plain fp32 attention backward against the JAX package's, at
the edges of the fp32 backward kernels' 64-row tiles: S 1, 65, 100 and
130, Sq != Sk both ways, D 64 and 128, causal or not, bias or not, and a
batch row whose keys are all padding.

The plain versions (``flash_attention_backward_reference``,
``flash_attention_packed_backward_reference``) are the kernels' oracles on
the card; here they are held to the Pallas backward kernels in interpret
mode (``_flash_backward``, ``_packed_backward``, one block per sequence),
from the JAX forward's out and lse, as
tests/test_torch_flash_attention_unpacked.py and
tests/test_torch_flash_attention_backward.py do at the Pallas blocks'
sizes.  Inputs come from numpy with a fixed seed.

Tolerances: 5e-5 on dq, dk, dv and dbias (sums of up to 130 O(1) products
in another order); the all-padding row 2**-6 (p = exp(s - lse) with s and
lse near -1e4, each carrying up to an fp32 ulp, 2**-10, there).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

# the module (its package re-exports a function of the same name)
jfa = importlib.import_module("paddle_tpu.ops.pallas.flash_attention")

B = 2
DEAD = 1  # the batch row an all-padding bias masks out entirely
GRAD_ATOL, DEAD_GRAD_ATOL = 5e-5, 2.0 ** -6


def _bias(rng, Sk, dead_row):
    mask = (rng.rand(B, Sk) > 0.25).astype("float32")
    mask[:, 0] = 1.0
    if dead_row:
        mask[DEAD] = 0.0  # an all-padding row: softmax goes uniform
    return mask * 1e4 - 1e4  # models/bert.py's additive mask


def _assert_rows(got, want, dead_row):
    got, want = np.asarray(got), np.asarray(want)
    live = [b for b in range(B) if not (dead_row and b == DEAD)]
    np.testing.assert_allclose(got[live], want[live], atol=GRAD_ATOL, rtol=0)
    if dead_row:
        np.testing.assert_allclose(got[DEAD], want[DEAD],
                                   atol=DEAD_GRAD_ATOL, rtol=0)


UNPACKED = [
    # (Sq, Sk, D, causal, with_bias, dead_row), two heads
    (1, 1, 64, False, True, False),
    (65, 65, 64, True, False, False),
    (65, 65, 128, False, True, True),
    (100, 100, 64, True, True, False),
    (65, 130, 128, True, False, False),
    (130, 65, 64, True, True, False),
    (1, 65, 64, False, True, False),
    (65, 1, 128, True, False, False),
]


@pytest.mark.parametrize("Sq,Sk,D,causal,with_bias,dead_row", UNPACKED,
                         ids=[f"Sq{c[0]}_Sk{c[1]}_D{c[2]}" for c in UNPACKED])
def test_unpacked_backward_reference_at_tile_edges(Sq, Sk, D, causal,
                                                   with_bias, dead_row):
    rng = np.random.RandomState(7 * Sq + Sk + D)
    q, g = (rng.randn(B, 2, Sq, D).astype("float32") for _ in range(2))
    k, v = (rng.randn(B, 2, Sk, D).astype("float32") for _ in range(2))
    bias = _bias(rng, Sk, dead_row) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    j = [jnp.asarray(x) for x in (q, k, v)]
    out, lse = jfa._flash_forward(*j, causal, None, Sq, Sk, True, bias=jb)
    want = jfa._flash_backward(*j, out, lse, jnp.asarray(g), causal, None,
                               Sq, Sk, True, bias=jb)
    got = tfa.flash_attention_backward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if bias is None else torch.from_numpy(bias),
        torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
        torch.from_numpy(g), causal)
    for name, t, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert t.shape == w.shape and t.dtype == torch.float32, name
        _assert_rows(t.numpy(), w, dead_row)
    if with_bias:
        _assert_rows(got[3].numpy(), want[3], dead_row)
    else:
        assert got[3] is None and want[3] is None


PACKED = [
    # (S, H, num_heads, causal, with_bias, dead_row)
    (1, 128, 2, False, True, False),
    (65, 128, 1, True, True, True),
    (100, 256, 4, False, False, False),
    (130, 256, 2, True, True, False),
]


@pytest.mark.parametrize("S,H,nh,causal,with_bias,dead_row", PACKED,
                         ids=[f"S{c[0]}_D{c[1] // c[2]}" for c in PACKED])
def test_packed_backward_reference_at_tile_edges(S, H, nh, causal,
                                                 with_bias, dead_row):
    rng = np.random.RandomState(5 * S + H + nh)
    qkv = rng.randn(B, S, 3 * H).astype("float32")
    g = rng.randn(B, S, H).astype("float32")
    bias = _bias(rng, S, dead_row) if with_bias else None
    D = H // nh
    x = qkv.reshape(B, S, 3, nh, D)
    q, k, v = (jnp.asarray(x[:, :, i].transpose(0, 2, 1, 3))
               for i in range(3))
    out, (m, l) = jfa.blockwise_attention(
        q, k, v, causal=causal, bias=None if bias is None
        else jnp.asarray(bias))
    out = np.array(out).transpose(0, 2, 1, 3).reshape(B, S, H)
    lse = (np.asarray(m) + np.log(np.asarray(l))).astype("float32")
    # the TPU kernels' lse layout [B, H/128, 128/D, S] is [B, nh, S]
    j_dqkv, j_db = jfa._packed_backward(
        jnp.asarray(qkv), nh, jnp.asarray(out),
        jnp.asarray(lse.reshape(B, H // 128, 128 // D, S)), jnp.asarray(g),
        causal, None, S, S, True,
        bias=None if bias is None else jnp.asarray(bias))
    t_dqkv, t_db = tfa.flash_attention_packed_backward_reference(
        torch.from_numpy(qkv), None if bias is None else
        torch.from_numpy(bias), torch.from_numpy(out), torch.from_numpy(lse),
        torch.from_numpy(g), nh, causal)
    assert t_dqkv.shape == (B, S, 3 * H) and t_dqkv.dtype == torch.float32
    _assert_rows(t_dqkv.numpy(), j_dqkv, dead_row)
    if with_bias:
        _assert_rows(t_db.numpy(), j_db, dead_row)
    else:
        assert t_db is None and j_db is None
