"""Wide&Deep (``models/wide_deep.py``) in the port, against the JAX package.

* ``wide_deep_net`` (at ``is_sparse`` True and False, with Adam at the
  default ``lazy_mode``) and ``wide_deep_serving_net`` serialise
  JSON-equal to the JAX package's at the builders' Criteo defaults (26
  slots, 13 dense features, 1,000,001 ids, embed 10, 400-400-400), main
  and startup programs.
* At a small width (4 slots, 1000 ids, embed 4, hidden (16, 16), batch
  8) 4 Adam steps from the JAX startup scope follow the JAX package
  within rtol 2e-5 / atol 1e-6 in every loss and every persistable, at
  ``is_sparse`` False, and True with ``lazy_mode`` off and on (the JAX
  program's ``adam`` ops are given ``lazy_mode`` by hand: its optimizer
  drops the flag).  Lazy steps leave every row no id touched at its
  startup bits in both tables and their moments.
* The serving net on the JAX startup weights gives the JAX forward's
  logits and probabilities within 1e-6, and each row of a batch of 8
  what it gets alone within 1e-6 (MKL sums a short product's rows in an
  order that depends on M; on the card, where the forward products run
  the product kernel, chip_smoke.py's phase 18e holds them bit for bit).
* The new ops of the slice (``concat``, ``flatten2``, ``sigmoid``,
  ``square``, ``reduce_mean``, ``sigmoid_cross_entropy_with_logits`` with
  ``ignore_index`` and ``normalize``, and the SelectedRows utilities on a
  dense input) run the JAX package's ``OpCase``s through
  tests/torch_op_util.py: outputs and grads within the cases' rtol 1e-5 /
  atol 1e-6.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from op_test import OpCase
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.models import wide_deep as j_wide_deep
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import wide_deep as t_wide_deep
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed
from torch_op_util import check_case

RTOL, ATOL = 2e-5, 1e-6
SMALL = dict(num_sparse=4, num_dense=13, vocab_size=1000, embed_dim=4,
             hidden=(16, 16))
BATCH, STEPS = 8, 4


def _models(pkg):
    return j_wide_deep if pkg is jpt else t_wide_deep


def _reset(pkg):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()


def _train_net(pkg, cfg, is_sparse, lazy, lr=0.05):
    """(main, startup, loss) of wide_deep_net + Adam in `pkg`; `lazy`
    sets ``lazy_mode`` on the adam ops (by hand in the JAX package)."""
    _reset(pkg)
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup):
        net = _models(pkg).wide_deep_net(is_sparse=is_sparse, **cfg)
        if pkg is jpt:
            pkg.optimizer.AdamOptimizer(lr).minimize(net["loss"])
            for op in main.global_block().ops:
                if op.type == "adam" and lazy:
                    op.attrs["lazy_mode"] = True
        else:
            pkg.optimizer.AdamOptimizer(lr, lazy_mode=lazy).minimize(
                net["loss"])
    return main, startup, net["loss"]


def _serving_net(pkg, cfg):
    _reset(pkg)
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    main.random_seed = startup.random_seed = 11
    with pkg.program_guard(main, startup):
        net = _models(pkg).wide_deep_serving_net(
            **{k: v for k, v in cfg.items() if k != "vocab_size"})
    return main, startup, net


def _json_equal(a, b):
    assert json.loads(j_to_json(a)) == json.loads(t_to_json(b))


@pytest.mark.parametrize("is_sparse", [True, False])
def test_training_program_is_json_equal_at_the_criteo_width(is_sparse):
    jm, js, _ = _train_net(jpt, {}, is_sparse, lazy=False)
    tm, ts, _ = _train_net(tpt, {}, is_sparse, lazy=False)
    _json_equal(jm, tm)
    _json_equal(js, ts)
    w = tm.global_block().var("deep_embedding_w@GRAD")
    assert (w.type == "selected_rows") == is_sparse
    assert w.shape == (1000001, 10)


def test_serving_program_is_json_equal_at_the_criteo_width():
    jm, js, _ = _serving_net(jpt, {})
    tm, ts, _ = _serving_net(tpt, {})
    _json_equal(jm, tm)
    _json_equal(js, ts)


def _feeds(cfg, steps, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        out.append({
            "sparse_ids": rng.randint(
                0, cfg["vocab_size"] // 4,
                (BATCH, cfg["num_sparse"])).astype("int64"),
            "dense_x": rng.randn(BATCH, cfg["num_dense"]).astype("float32"),
            "label": (rng.rand(BATCH, 1) < 0.3).astype("float32")})
    return out


def _persistables(main):
    return [v.name for v in main.list_vars() if v.persistable]


@pytest.mark.parametrize("is_sparse,lazy", [(False, False), (True, False),
                                            (True, True)],
                         ids=["dense", "sparse", "sparse_lazy"])
def test_training_follows_the_jax_package(is_sparse, lazy):
    jm, js, jl = _train_net(jpt, SMALL, is_sparse, lazy)
    tm, ts, tl = _train_net(tpt, SMALL, is_sparse, lazy)
    _json_equal(jm, tm)
    names = _persistables(jm)
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    j_exe.run(js, scope=j_scope)
    start = {n: np.asarray(j_scope.find_var(n)) for n in names}
    t_scope = scope_from_arrays(start, "cpu", tm)
    t_exe = tpt.Executor(tpt.CPUPlace())
    feeds = _feeds(SMALL, STEPS)
    for feed in feeds:
        want, = j_exe.run(jm, feed=feed, fetch_list=[jl], scope=j_scope)
        got, = t_exe.run(tm, feed=feed, fetch_list=[tl], scope=t_scope)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for n in names:
        np.testing.assert_allclose(
            t_scope.find_var(n).numpy(), np.asarray(j_scope.find_var(n)),
            rtol=RTOL, atol=ATOL, err_msg=n)
    if lazy:
        seen = np.unique(np.concatenate([f["sparse_ids"].ravel()
                                         for f in feeds]))
        untouched = np.setdiff1d(np.arange(SMALL["vocab_size"]), seen)
        tables = [n for n in names
                  if "embedding_w" in n and "_pow" not in n]
        assert len(tables) == 6  # two tables, each with two moments
        for n in tables:
            got = t_scope.find_var(n).numpy()
            assert got[untouched].tobytes() == start[n][untouched].tobytes()
            assert not np.array_equal(got[seen], start[n][seen]), n


def test_serving_net_follows_the_jax_forward_and_rows_stand_alone():
    jm, js, jn = _serving_net(jpt, SMALL)
    tm, ts, tn = _serving_net(tpt, SMALL)
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    j_exe.run(js, scope=j_scope)
    t_scope = scope_from_arrays(
        {n: np.asarray(j_scope.find_var(n)) for n in _persistables(jm)},
        "cpu", tm)
    t_exe = tpt.Executor(tpt.CPUPlace())
    rng = np.random.RandomState(9)
    feed = {"wide_rows": rng.randn(8, 4, 1).astype("float32"),
            "deep_rows": rng.randn(8, 4, 4).astype("float32"),
            "dense_x": rng.randn(8, 13).astype("float32")}
    fetch = ["logit", "prob"]
    want = j_exe.run(jm, feed=feed, fetch_list=[jn[k] for k in fetch],
                     scope=j_scope)
    got = t_exe.run(tm, feed=feed, fetch_list=[tn[k] for k in fetch],
                    scope=t_scope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6)
    for r in range(8):
        alone = t_exe.run(tm, feed={k: v[r:r + 1] for k, v in feed.items()},
                          fetch_list=[tn[k] for k in fetch], scope=t_scope)
        for g, a in zip(got, alone):
            np.testing.assert_allclose(g[r:r + 1], a, rtol=1e-6, atol=1e-7)


R = np.random.RandomState
_X = R(1).uniform(-2.0, 2.0, (3, 4)).astype("float32")
_X3 = R(2).uniform(-2.0, 2.0, (2, 3, 4)).astype("float32")
_LOGITS = R(3).uniform(-3.0, 3.0, (6, 1)).astype("float32")
_LABELS = np.array([[1.0], [0.0], [1.0], [0.0], [1.0], [1.0]], "float32")
_IGNORED = np.array([[1.0], [-1.0], [0.0], [-1.0], [1.0], [0.0]], "float32")

CASES = [
    OpCase("concat", {"X": [_X, R(4).uniform(-1, 1, (3, 2)).astype(
        "float32")]}, attrs={"axis": 1}, grad=["X"]),
    OpCase("flatten2", {"X": _X3}, outputs={"Out": 1, "XShape": 1},
           attrs={"axis": 1}, grad=["X"]),
    OpCase("sigmoid", {"X": _X}, grad=["X"]),
    OpCase("square", {"X": _X}, grad=["X"]),
    OpCase("reduce_mean", {"X": _X3}, attrs={"dim": [1], "keep_dim": False},
           grad=["X"], name="reduce_mean_dim1"),
    OpCase("reduce_mean", {"X": _X3}, attrs={"dim": [0], "keep_dim": True,
                                             "reduce_all": True},
           grad=["X"], name="reduce_mean_all"),
    OpCase("sigmoid_cross_entropy_with_logits",
           {"X": _LOGITS, "Label": _LABELS}, grad=["X"]),
    OpCase("sigmoid_cross_entropy_with_logits",
           {"X": _LOGITS, "Label": _IGNORED},
           attrs={"ignore_index": -1, "normalize": True}, grad=["X"],
           name="sigmoid_ce_ignore_normalize"),
    OpCase("merge_selected_rows", {"X": _X}, name="merge_selected_rows_dense"),
    OpCase("get_tensor_from_selected_rows", {"X": _X},
           name="get_tensor_from_selected_rows_dense"),
]


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_new_op_case_follows_jax(case):
    check_case(case)
