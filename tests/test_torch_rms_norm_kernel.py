"""The fp32 RMSNorm whose rows do not depend on the row count
(ops/cuda/rms_norm.py).

On the CPU: the routing rule, and the plain version, which is the op's
own formulation: bit-equal to the ``rms_norm`` op on the CPU (whose path
the kernel leaves as it was) and to the JAX package's op within 1e-6.
Marked ``cuda`` (skip without a card): every row of an M-row norm
bit-equal to the same row of a longer one and of a row-permuted one, and
the kernel within 2e-6 (relative to the largest output) of the plain
version: a few float32 ulps of a mean of squares summed in another
order, then one sqrt and one division.  On the card:
``python -m pytest -m cuda tests/test_torch_rms_norm_kernel.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu_torch.ops.cuda import rms_norm

R = np.random.RandomState(1357)


def _op(pkg, x, scale):
    main = pkg.Program()
    block = main.global_block()
    block.create_var(name="x", shape=list(x.shape), dtype="float32",
                     is_data=True)
    block.create_var(name="s", shape=list(scale.shape), dtype="float32",
                     is_data=True)
    block.append_op("rms_norm", inputs={"X": ["x"], "Scale": ["s"]},
                    outputs={"Y": ["y"]}, attrs={"epsilon": 1e-6})
    return pkg.Executor(pkg.CPUPlace()).run(
        main, feed={"x": x, "s": scale}, fetch_list=["y"],
        scope=pkg.Scope())[0]


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 64), (1, 1, 4096)],
                         ids=["2d", "3d", "one_row_llama_width"])
def test_plain_version_is_the_op(shape):
    x = (R.randn(*shape) * 3).astype("float32")
    scale = (R.rand(shape[-1]) + 0.5).astype("float32")
    calls = rms_norm.rms_norm_rows_reference.calls
    got = rms_norm.rms_norm_rows(torch.from_numpy(x),
                                 torch.from_numpy(scale), 1e-6)
    assert rms_norm.rms_norm_rows_reference.calls == calls + 1
    np.testing.assert_array_equal(got.numpy(), _op(tpt, x, scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(_op(jpt, x, scale)),
                               rtol=0, atol=1e-6)


def test_plain_version_without_scale():
    x = torch.from_numpy(R.randn(4, 32).astype("float32"))
    y = rms_norm.rms_norm_rows_reference(x, None, 1e-6)
    want = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6)
    assert torch.equal(y, want)


def test_routing_rule():
    x, s = torch.ones(2, 8), torch.ones(8)
    assert not rms_norm.routes(x, s)                  # CPU
    assert not rms_norm.routes(torch.empty(2, 8, device="meta"), None)
    assert not rms_norm.routes(x.bfloat16(), s)
    assert not rms_norm.routes(x.requires_grad_(), s)


def test_rms_norm_op_on_the_cpu_never_calls_the_wrapper():
    x = R.randn(2, 8).astype("float32")
    s = np.ones(8, "float32")
    before = (rms_norm.rms_norm_rows.launches,
              rms_norm.rms_norm_rows_reference.calls)
    _op(tpt, x, s)
    assert (rms_norm.rms_norm_rows.launches,
            rms_norm.rms_norm_rows_reference.calls) == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 4096, 11008, 100, 300, 8192],
                         ids=["tiny", "llama_hidden", "wide", "ragged",
                              "two_a_thread", "widest_in_registers"])
def test_kernel_rows_do_not_depend_on_m(cuda, n):
    x = torch.from_numpy(R.randn(512, n).astype("float32") * 3).to(cuda)
    scale = torch.from_numpy(R.rand(n).astype("float32") + 0.5).to(cuda)
    launches = rms_norm.rms_norm_rows.launches
    full = rms_norm.rms_norm_rows(x, scale, 1e-6)
    assert rms_norm.rms_norm_rows.launches == launches + 1
    perm = torch.from_numpy(R.permutation(512)).to(cuda)
    assert torch.equal(rms_norm.rms_norm_rows(x[perm], scale, 1e-6),
                       full[perm])
    for M in (1, 2, 3, 4, 16, 128, 500):
        assert torch.equal(rms_norm.rms_norm_rows(x[:M], scale, 1e-6),
                           full[:M]), M
    ref = rms_norm.rms_norm_rows_reference(x, scale, 1e-6)
    assert float((full - ref).abs().max() / ref.abs().max()) <= 2e-6


@pytest.mark.cuda
def test_kernel_raises_on_a_wrong_scale(cuda):
    x = torch.ones(2, 8, device=cuda)
    with pytest.raises(ValueError, match="scale"):
        rms_norm.rms_norm_rows(x, torch.ones(7, device=cuda), 1e-6)
