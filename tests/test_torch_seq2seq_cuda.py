"""The sequence slice on the card: its ops under CUDA graph capture.

Marked ``cuda`` (they skip without a card; no jax import, so they run on
the card's machine with ``--noconftest``):

* ``assign_value`` (the beam decoder's first scores) is captured: its
  constant is copied from the host once, in the eager run, and every
  replay gives the eager run's value;
* a small seq2seq decode (beam 3 over 6 steps) replayed from a captured
  graph gives the eager decode's ids, scores and lengths bit for bit,
  each sentence decoded alone gives its row of the batch's, and the
  recurrences' step products run the product kernel, counted in
  ``sequence_ops.step_product.launches``;
* a two-layer ``rnn`` with dropout draws each layer's mask anew at every
  replay, as the eager runs at the same run counts do.

On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_seq2seq_cuda.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch.models import build_seq2seq_infer
from paddle_tpu_torch.ops import sequence_ops
from paddle_tpu_torch.ops.cuda import gemm


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graph capture)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_assign_value_is_captured():
    _card()
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [2, 3], append_batch_size=False)
        c = tpt.layers.assign(np.array([[1.5, -1e9, 2.0]], "float32"))
        out = tpt.layers.elementwise_add(x, c)
    exe = tpt.Executor()
    feed = {"x": np.ones((2, 3), "float32")}
    runs = [exe.run(main, feed=feed, fetch_list=[out])[0] for _ in range(3)]
    assert exe.cache_info()["entries"][-1]["aot"]
    want = np.ones((2, 3), "float32") + np.array([[1.5, -1e9, 2.0]],
                                                 "float32")
    for r in runs:
        np.testing.assert_array_equal(r, want)
    exe.close()


def _decoder(batch):
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    with tpt.program_guard(main, startup):
        _, outs = build_seq2seq_infer(batch, 7, 40, 30, emb_dim=16,
                                      hidden=16, beam_size=3, max_len=6)
    return main, startup, [outs[k] for k in ("ids", "scores", "lengths")]


@pytest.mark.cuda
def test_captured_decode_equals_eager_and_each_sentence_alone():
    _card()
    main, startup, fetch = _decoder(4)
    one, _, one_fetch = _decoder(1)
    scope = tpt.Scope()
    tpt.Executor().run(startup, scope=scope)
    rng = np.random.RandomState(0)
    lens = np.array([7, 3, 5, 2])
    feed = {"src_ids": rng.randint(2, 40, (4, 7)).astype("int64"),
            "src_mask": (np.arange(7)[None] < lens[:, None]).astype(
                "float32")}
    eager = tpt.Executor().run(main, feed=feed, fetch_list=fetch,
                               scope=scope, use_program_cache=False)
    exe = tpt.Executor()
    sequence_ops.step_product.launches = gemm.matmul.launches = 0
    runs = [exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            for _ in range(3)]
    assert exe.cache_info()["entries"][-1]["aot"]
    # two gru_rnn ops, two products a step over 7 steps, each run (a
    # replay adds what its capture counted)
    assert sequence_ops.step_product.launches == 3 * 2 * 2 * 7
    assert gemm.matmul.launches > sequence_ops.step_product.launches
    for run in runs:
        for got, want in zip(run, eager):
            assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    alone_exe = tpt.Executor()
    for r in range(4):
        alone = alone_exe.run(one, feed={k: v[r:r + 1]
                                         for k, v in feed.items()},
                              fetch_list=one_fetch, scope=scope)
        for got, want in zip(alone, eager):
            assert np.asarray(got).tobytes() == \
                np.asarray(want)[r:r + 1].tobytes(), r
    exe.close()
    alone_exe.close()


@pytest.mark.cuda
def test_rnn_dropout_masks_follow_the_run_count_under_capture():
    _card()
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    H = 32
    with tpt.program_guard(main, startup):
        block = main.global_block()
        x = tpt.layers.data("x", [8, 3, H], append_batch_size=False)
        ln = tpt.layers.data("ln", [8], dtype="int64",
                             append_batch_size=False)
        ws = []
        for i in range(2):
            for shape in ((H, H), (H, H), (H,), (H,)):
                v = block.create_var(name=f"w{len(ws)}", shape=shape,
                                     dtype="float32", is_data=True)
                ws.append(v)
        out = block.create_var(name="out", dtype="float32")
        last = block.create_var(name="last", dtype="float32")
        block.append_op("rnn", inputs={"Input": [x], "WeightList": ws,
                                       "Lengths": [ln]},
                        outputs={"Out": [out], "LastH": [last]},
                        attrs={"mode": "RNN_RELU", "hidden_size": H,
                               "num_layers": 2, "dropout_prob": 0.5})
    eye, zero = np.eye(H, dtype="float32"), np.zeros((H, H), "float32")
    feed = {"x": np.random.RandomState(1).uniform(
        0.5, 1.5, (8, 3, H)).astype("float32"),
        "ln": np.full(8, 3, "int64")}
    for i in range(2):
        feed.update({f"w{4 * i}": eye, f"w{4 * i + 1}": zero,
                     f"w{4 * i + 2}": np.zeros(H, "float32"),
                     f"w{4 * i + 3}": np.zeros(H, "float32")})
    captured = tpt.Executor()
    got = [captured.run(main, feed=feed, fetch_list=["last"])[0]
           for _ in range(4)]
    assert captured.cache_info()["entries"][-1]["aot"]
    eager = tpt.Executor()
    want = [eager.run(main, feed=feed, fetch_list=["last"],
                      use_program_cache=False)[0] for _ in range(4)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[2], got[3])
    captured.close()
