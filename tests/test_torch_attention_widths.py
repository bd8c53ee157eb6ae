"""``flash_attention_qkv`` at widths the packed kernels do not take
(hidden % 128 != 0, or head_dim not 64 / 128) against the JAX package,
whose op runs its blockwise formulation there (heads split, then
``blockwise_attention``): each ``OpCase`` is built in the JAX package,
serialised and run in the port (tests/torch_op_util.py).  Out and the
grads of QKV and Bias within atol 2e-5 (fp32 online-softmax sums of 32
keys in the same blocks; the grads through autograd of each formulation).

The port takes ``split_heads_attention`` there on any device, counted in
its own ``.calls``; at the packed widths the op still runs the packed
path (its plain version on the CPU) and that count stays put.
"""
import numpy as np
import pytest

from op_test import OpCase
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from torch_op_util import check_case

B, S = 2, 32
ATOL = 2e-5


def _qkv(H, seed):
    return np.random.RandomState(seed).randn(B, S, 3 * H).astype("float32")


def _bias(seed):
    mask = (np.random.RandomState(seed).rand(B, S) > 0.25).astype("float32")
    mask[:, 0] = 1.0
    return (mask * 1e4 - 1e4).astype("float32")


# (hidden, heads, causal, bias): head_dim 48 (hidden 96), head_dim 32 at
# hidden 64 (64 % 128 != 0) and at hidden 256 (8 heads), head_dim 16
WIDTHS = [(96, 2, False, True), (96, 2, True, False), (64, 2, False, True),
          (256, 8, True, True), (32, 2, False, False)]


@pytest.mark.parametrize("H,nh,causal,with_bias", WIDTHS,
                         ids=[f"H{w[0]}_h{w[1]}_{'causal' if w[2] else 'full'}"
                              f"{'_bias' if w[3] else ''}" for w in WIDTHS])
def test_other_widths_follow_the_jax_blockwise_path(H, nh, causal,
                                                    with_bias):
    inputs = {"QKV": _qkv(H, H + nh)}
    grad = ["QKV"]
    if with_bias:
        inputs["Bias"] = _bias(H)
        grad.append("Bias")
    case = OpCase("flash_attention_qkv", inputs,
                  attrs={"num_heads": nh, "causal": causal}, grad=grad,
                  rtol=0.0, atol=ATOL, name=f"flash_attention_qkv_H{H}")
    calls = tfa.split_heads_attention.calls
    packed = tfa.flash_attention_packed_reference.calls
    check_case(case)
    assert tfa.split_heads_attention.calls > calls
    assert tfa.flash_attention_packed_reference.calls == packed


def test_packed_widths_keep_the_packed_path():
    """Hidden 128, 2 heads of 64: the packed op (its plain version on the
    CPU), not the split-heads formulation."""
    case = OpCase("flash_attention_qkv", {"QKV": _qkv(128, 5)},
                  attrs={"num_heads": 2, "causal": False}, grad=["QKV"],
                  rtol=0.0, atol=ATOL)
    calls = tfa.split_heads_attention.calls
    packed = tfa.flash_attention_packed_reference.calls
    check_case(case)
    assert tfa.split_heads_attention.calls == calls
    assert tfa.flash_attention_packed_reference.calls > packed
