"""Fetches a caller keeps: ordinary host memory that no later run touches.

``fetch_to_numpy`` copies each fetch into a fresh array in pageable host
memory, as the JAX package's ``np.asarray`` does (a large one's pages
faulted in by one mmap call), and pins nothing: a caller that keeps every
response (a server does) holds no pinned memory, and the next run
neither allocates pinned memory nor writes into an array handed out
before.

On the CPU: arrays kept from earlier runs of ``Executor.run`` (a fetch
of state the step updates in place) and ``Predictor.run`` keep their
values; ``fetch_to_numpy`` keeps the bits of float32 and bfloat16.
Marked ``cuda``: on the card the kept arrays are not pinned and later
runs leave them alone.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch.framework.executor import fetch_to_numpy


def _counter_program():
    """acc += x, acc persistable: the step updates it in place."""
    main = tpt.Program()
    block = main.global_block()
    block.create_var(name="acc", shape=[4], dtype="float32",
                     persistable=True)
    block.create_var(name="x", shape=[4], dtype="float32", is_data=True)
    block.append_op("elementwise_add", inputs={"X": ["acc"], "Y": ["x"]},
                    outputs={"Out": ["acc"]})
    return main


def _run_kept(place):
    main = _counter_program()
    scope = tpt.Scope()
    scope.set_var("acc", np.zeros(4, "float32"))
    exe = tpt.Executor(place)
    kept = [exe.run(main, feed={"x": np.full(4, i + 1.0, "float32")},
                    fetch_list=["acc"], scope=scope)[0] for i in range(4)]
    exe.close()
    return kept


def test_kept_executor_fetches_are_not_changed_by_later_runs():
    kept = _run_kept(tpt.CPUPlace())
    for i, a in enumerate(kept):
        np.testing.assert_array_equal(
            a, np.full(4, sum(range(1, i + 2)), "float32"))


def test_kept_predictor_fetches_are_not_changed_by_later_runs(tmp_path):
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [3], dtype="float32")
        y = tpt.layers.fc(x, 5)
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    with tpt.scope_guard(scope):
        tpt.io.save_inference_model(str(tmp_path), ["x"], [y], exe,
                                    main_program=main)
    pred = tpt.inference.Predictor(str(tmp_path), device="cpu")
    feeds = [np.random.RandomState(i).randn(2, 3).astype("float32")
             for i in range(3)]
    kept = [pred.run({"x": f})[0] for f in feeds]
    copies = [k.copy() for k in kept]
    pred.run({"x": np.zeros((2, 3), "float32")})
    for k, c in zip(kept, copies):
        np.testing.assert_array_equal(k, c)
    assert not np.array_equal(kept[0], kept[1])


@pytest.mark.parametrize("shape,dtype", [((3,), "int64"),
                                         ((4, 128, 1024), "float32"),
                                         ((2, 1 << 20), "float32"),
                                         ((512, 1024), ml_dtypes.bfloat16)],
                         ids=["small", "large", "large_2d", "bf16"])
def test_host_arrays_are_fresh_writable_memory(shape, dtype):
    from paddle_tpu_torch.framework.executor import _host_array

    a, b = _host_array(shape, dtype), _host_array(shape, dtype)
    assert a.shape == shape and a.dtype == np.dtype(dtype)
    assert a.flags.writeable and not np.shares_memory(a, b)
    before = b.view(np.uint8).copy()
    a[...] = 1
    np.testing.assert_array_equal(b.view(np.uint8), before)
    assert not torch.from_numpy(a.view(np.uint8)).is_pinned()


def test_fetch_to_numpy_keeps_the_bits():
    f = torch.randn(3, 5)
    b = torch.randn(2, 7).to(torch.bfloat16)
    got_f, got_b = fetch_to_numpy([f, b])
    np.testing.assert_array_equal(got_f, f.numpy())
    assert got_b.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got_b.view(np.int16),
                                  b.view(torch.int16).numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kept_fetches_on_the_card_are_pageable_and_stay(cuda):
    kept = _run_kept(None)
    for i, a in enumerate(kept):
        assert not torch.from_numpy(a).is_pinned()
        np.testing.assert_array_equal(
            a, np.full(4, sum(range(1, i + 2)), "float32"))
