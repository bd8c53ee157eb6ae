"""The SelectedRows merge kernel (ops/cuda/selected_rows.py) on the card.

Marked ``cuda`` (they skip without a card; no jax import, so they run on
the card's machine with ``--noconftest``):

* the kernel gives its plain version's bits, the plain version run on
  the CPU on the same inputs (tolerance 0: both add each unique row's
  values one after another in the order of a stable sort, from +0), at
  Wide&Deep's K (4096 rows x 26 slots = 106,496 ids, Zipf(1.1) over a
  permutation of 1,000,001 rows, so one row repeats thousands of times)
  for 10 columns and 1, and on small uniform draws with sentinel slots;
* two launches on the same inputs give the same bits;
* a Wide&Deep step with sparse tables and lazy Adam, captured as a CUDA
  graph and replayed, gives the eager step's bits (every loss and every
  persistable over 4 steps), and launches the merge kernel twice a step
  (one merge a table) with no plain call.

On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_selected_rows_cuda.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch.ops.cuda import selected_rows as kernel

HEIGHT, K = 1000001, 4096 * 26


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def zipf_rows(seed, k=K, height=HEIGHT, s=1.1):
    """k ids, Zipf(s) ranks over a seeded permutation of the rows."""
    rng = np.random.RandomState(seed)
    ranks = rng.zipf(s, 4 * k)
    ranks = ranks[ranks <= height][:k] - 1
    return rng.permutation(height)[ranks].astype("int64")


def _merge_both(rows, vals, height, device):
    got = kernel.merge_rows(torch.from_numpy(rows).to(device),
                            torch.from_numpy(vals).to(device), height)
    want = kernel.merge_rows_reference(torch.from_numpy(rows),
                                       torch.from_numpy(vals), height)
    return [t.cpu() for t in got], want


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [10, 1])
def test_kernel_gives_the_plain_versions_bits_at_wide_deeps_k(cuda, cols):
    rows = zipf_rows(7)
    vals = np.random.RandomState(cols).randn(K, cols).astype("float32")
    launches = kernel.merge_rows.launches
    (gr, gv), (wr, wv) = _merge_both(rows, vals, HEIGHT, cuda)
    assert kernel.merge_rows.launches == launches + 1
    assert torch.equal(gr, wr)
    assert gv.numpy().tobytes() == wv.numpy().tobytes()
    again = kernel.merge_rows(torch.from_numpy(rows).to(cuda),
                              torch.from_numpy(vals).to(cuda), HEIGHT)
    assert again[1].cpu().numpy().tobytes() == gv.numpy().tobytes()
    assert torch.equal(again[0].cpu(), gr)


@pytest.mark.cuda
@pytest.mark.parametrize("k,height,cols", [(1, 5, 3), (37, 4, 33),
                                           (1000, 50, 65)])
def test_kernel_on_small_draws_with_sentinels(cuda, k, height, cols):
    rng = np.random.RandomState(k)
    rows = rng.randint(0, height + 1, k).astype("int64")
    vals = rng.randn(k, cols).astype("float32")
    vals[rows == height] = 0.0
    (gr, gv), (wr, wv) = _merge_both(rows, vals, height, cuda)
    assert torch.equal(gr, wr)
    assert gv.numpy().tobytes() == wv.numpy().tobytes()


@pytest.mark.cuda
def test_kernel_raises_on_another_dtype(cuda):
    with pytest.raises(ValueError, match="float32"):
        kernel.merge_rows(torch.zeros(4, dtype=torch.int64, device=cuda),
                          torch.zeros(4, 2, dtype=torch.float16,
                                      device=cuda), 9)


def _wide_deep(lazy=True):
    from paddle_tpu_torch.models import wide_deep_net
    from paddle_tpu_torch.ops.registry import reset_op_seed

    tpt.reset_unique_name()
    reset_op_seed()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        net = wide_deep_net(num_sparse=26, vocab_size=HEIGHT, embed_dim=10,
                            hidden=(64, 64), is_sparse=True)
        tpt.optimizer.AdamOptimizer(1e-3, lazy_mode=lazy).minimize(
            net["loss"])
    return main, startup, net["loss"]


def _feeds(n, batch=512):
    rng = np.random.RandomState(3)
    return [{"sparse_ids": zipf_rows(10 + i, k=batch * 26).reshape(batch, 26),
             "dense_x": rng.randn(batch, 13).astype("float32"),
             "label": (rng.rand(batch, 1) < 0.25).astype("float32")}
            for i in range(n)]


@pytest.mark.cuda
def test_lazy_step_captured_is_the_eager_step(cuda):
    main, startup, loss = _wide_deep()
    names = [v.name for v in main.list_vars() if v.persistable]
    exe, eager = tpt.Executor(), tpt.Executor()
    scope, escope = tpt.Scope(), tpt.Scope()
    exe.run(startup, scope=scope)
    eager.run(startup, scope=tpt.Scope())
    for n in names:
        escope.set_var(n, scope.find_var(n).clone())
    feeds = _feeds(4)
    launches, calls = (kernel.merge_rows.launches,
                       kernel.merge_rows_reference.calls)
    got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in feeds]
    assert kernel.merge_rows.launches - launches == 2 * len(feeds)
    want = [eager.run(main, feed=f, fetch_list=[loss], scope=escope,
                      use_program_cache=False)[0] for f in feeds]
    assert kernel.merge_rows_reference.calls == calls
    assert exe.cache_info()["entries"][-1]["aot"]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    for n in names:
        assert torch.equal(scope.find_var(n), escope.find_var(n)), n
    exe.close()
    eager.close()
