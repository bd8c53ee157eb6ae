"""The vision slice on the card: the convolution routes, batch norm's
running statistics under capture and higher-order grads captured.

Marked ``cuda`` (they skip without a card; no jax import, so they run on
the card's machine with ``--noconftest``):

* the forward-only fp32 route (``nn_ops.conv2d_rows``) launches the
  product kernel once a convolution (in its own count too), gives every
  image the bits it has alone and in a permuted batch, and stays within
  ``gemm.tolerance`` of its plain version (the same im2col product by
  ``gemm.matmul_reference``);
* the training route (``nn_ops.conv2d_library``) runs cuDNN with TF32
  off and deterministic algorithms whatever the caller has set (the
  caller's TF32 setting allowed here), puts the caller's settings back,
  and gives the same bits in two backward passes; its grads equal
  cuDNN's backward with TF32 off bit for bit, and cuDNN's TF32 backward,
  the control, lies outside float32 limits of the grads in float64
  (``chip_smoke.conv_grad_ratios``) in one grad at least (for the other
  cuDNN may pick a float32 algorithm: the 7 x 7 stem's weight grad here);
* a conv + batch norm training step captured as a CUDA graph writes the
  moving mean and variance into the scope's own tensors at every replay,
  bit-equal to the same steps run eagerly;
* second- and third-order ``gradients`` (``x * x * x``) replayed from a
  captured graph give the eager run's bits and the analytic values.

On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_vision_cuda.py``.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu_torch as tpt
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.cuda import gemm

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _randn(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, device=device, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw,oc,k,s,p", [(3, 32, 16, 7, 2, 3),
                                           (64, 14, 32, 3, 1, 1),
                                           (256, 7, 64, 1, 1, 0)])
def test_forward_only_route_runs_the_product_kernel_row_for_row(
        cuda, c, hw, oc, k, s, p):
    x = _randn((8, c, hw, hw), 1, cuda)
    w = _randn((oc, c, k, k), 2, cuda) * (2.0 / (c * k * k)) ** 0.5
    args = ([s, s], [(p, p), (p, p)], [1, 1])
    launches = gemm.matmul.launches
    own = nn_ops.conv2d_rows.launches
    full = nn_ops.conv2d_rows(x, w, *args)
    assert gemm.matmul.launches - launches == 1
    assert nn_ops.conv2d_rows.launches - own == 1
    perm = torch.randperm(8, device=cuda)
    assert torch.equal(nn_ops.conv2d_rows(x[perm], w, *args), full[perm])
    for i in range(8):
        assert torch.equal(nn_ops.conv2d_rows(x[i:i + 1], w, *args),
                           full[i:i + 1])
    cols = F.unfold(F.pad(x, (p,) * 4), (k, k), stride=s)
    a = cols.transpose(1, 2).reshape(-1, c * k * k)
    b = w.reshape(oc, -1).t()
    oh = full.shape[2]

    def nchw(t):
        return t.view(8, oh, oh, oc).permute(0, 3, 1, 2)
    d = (full - nchw(gemm.matmul_reference(a, b))).abs()
    assert bool((d <= nchw(gemm.tolerance(a, b))).all())


@pytest.mark.cuda
def test_training_route_sets_its_own_cudnn_settings(cuda):
    x = _randn((4, 32, 28, 28), 3, cuda).requires_grad_(True)
    w = _randn((64, 32, 3, 3), 4, cuda).requires_grad_(True)
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
           torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = True  # the caller's setting
    try:
        out = nn_ops.conv2d_library(x, w, [1, 1], [(1, 1), (1, 1)], [1, 1])
        assert torch.backends.cudnn.allow_tf32  # put back
        gout = _randn(out.shape, 5, cuda)
        g1 = torch.autograd.grad(out, [x, w], gout, retain_graph=True)
        g2 = torch.autograd.grad(out, [x, w], gout)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))
        cols = F.unfold(F.pad(x.detach(), (1,) * 4), (3, 3))
        a = cols.transpose(1, 2).reshape(-1, 32 * 9)
        b = w.detach().reshape(64, -1).t()
        ref = gemm.matmul_reference(a, b).view(4, 28, 28, 64).permute(
            0, 3, 1, 2)
        tol = gemm.tolerance(a, b).view(4, 28, 28, 64).permute(0, 3, 1, 2)
        assert bool(((out.detach() - ref).abs() <= tol).all())
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = old


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw,oc,k,s,p", [(3, 32, 16, 7, 2, 3),
                                           (64, 14, 32, 3, 1, 1),
                                           (256, 7, 64, 1, 1, 0)])
def test_training_route_grads_stay_fp32_when_the_caller_allows_tf32(
        cuda, c, hw, oc, k, s, p):
    x = _randn((4, c, hw, hw), 6, cuda)
    w = _randn((oc, c, k, k), 7, cuda) * (2.0 / (c * k * k)) ** 0.5
    oh = (hw + 2 * p - k) // s + 1
    gout = _randn((4, oc, oh, oh), 8, cuda)
    before = torch.backends.cudnn.allow_tf32
    port = smoke.conv_grads(nn_ops, x, w, gout, s, p)
    assert torch.backends.cudnn.allow_tf32 == before
    off = smoke.cudnn_conv_grads(x, w, gout, s, p, False)
    assert all(torch.equal(a, b) for a, b in zip(port, off))
    control = smoke.cudnn_conv_grads(x, w, gout, s, p, True)
    assert max(smoke.conv_grad_ratios(gemm, x, w, gout, s, p,
                                      *control)) > 1


def _conv_bn_program():
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    main.random_seed = startup.random_seed = 3
    with tpt.program_guard(main, startup):
        img = tpt.layers.data("img", [-1, 3, 16, 16],
                              append_batch_size=False)
        label = tpt.layers.data("label", [-1, 1], dtype="int64",
                                append_batch_size=False)
        h = tpt.layers.conv2d(img, 8, 3, padding=1, bias_attr=False)
        h = tpt.layers.batch_norm(h, act="relu")
        h = tpt.layers.adaptive_pool2d(h, 1, pool_type="avg")
        logits = tpt.layers.fc(h, 4)
        loss = tpt.layers.mean(
            tpt.layers.softmax_with_cross_entropy(logits, label))
        tpt.optimizer.MomentumOptimizer(0.1, 0.9).minimize(loss)
    stats = [n for op in main.global_block().ops if op.type == "batch_norm"
             for n in op.input("Mean") + op.input("Variance")]
    return main, startup, loss, stats


@pytest.mark.cuda
def test_batch_norm_statistics_update_in_place_under_capture(cuda):
    main, startup, loss, stats = _conv_bn_program()
    rng = np.random.RandomState(0)
    feeds = [{"img": rng.rand(4, 3, 16, 16).astype("float32"),
              "label": rng.randint(0, 4, (4, 1)).astype("int64")}
             for _ in range(5)]
    lives = []
    for eager in (False, True):
        exe, scope = tpt.Executor(), tpt.Scope()
        exe.run(startup, scope=scope)
        ptrs = {n: scope.find_var(n).data_ptr() for n in stats}
        seen = []
        for feed in feeds:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                    use_program_cache=not eager)
            seen.append([scope.find_var(n).clone() for n in stats])
        if not eager:
            assert exe.cache_info()["entries"][-1]["aot"]
            assert {n: scope.find_var(n).data_ptr() for n in stats} == ptrs
        # every replay moved the statistics
        assert not any(torch.equal(a, b) for a, b in zip(seen[-1], seen[-2]))
        lives.append(seen)
        exe.close()
    for a, b in zip(*lives):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_third_order_gradients_replay_from_a_captured_graph(cuda):
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [4], append_batch_size=False)
        x.stop_gradient = False
        g1 = tpt.gradients(tpt.layers.reduce_sum(x * x * x), x)[0]
        g2 = tpt.gradients(tpt.layers.reduce_sum(g1), x)[0]
        g3 = tpt.gradients(tpt.layers.reduce_sum(g2), x)[0]
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    xv = np.array([1.0, 2.0, 3.0, 4.0], "float32")
    runs = [exe.run(main, feed={"x": xv}, fetch_list=[g1, g2, g3],
                    scope=scope) for _ in range(3)]
    assert exe.cache_info()["entries"][-1]["aot"]
    for r in runs[1:]:
        assert all(a.tobytes() == b.tobytes() for a, b in zip(r, runs[0]))
    np.testing.assert_allclose(runs[0][0], 3 * xv ** 2, rtol=1e-6)
    np.testing.assert_allclose(runs[0][1], 6 * xv, rtol=1e-6)
    np.testing.assert_allclose(runs[0][2], np.full(4, 6.0), rtol=1e-6)
    exe.close()
