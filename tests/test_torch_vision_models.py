"""LeNet-5 and ResNet (``models/lenet.py``, ``models/resnet.py``) in the
port, against the JAX package, on the CPU.

* The programs serialise JSON-equal to the JAX package's, main and
  startup: LeNet's training program (``build_mnist_train`` + SGD) and its
  prediction alone, ResNet at depths 18 and 50 (training and
  ``is_test``), and bench.py's ResNet-50 leg (batch 64, 224 x 224, 1000
  classes, ``MomentumOptimizer(0.1, 0.9)`` under bf16 ``decorate``).
* Training from the JAX startup scope follows the JAX ``Executor`` over 3
  steps: LeNet at batch 8 with SGD 0.05 (tests/test_models.py's recipe)
  and ResNet-18 at 32 x 32, batch 4, 10 classes, Momentum 0.01 / 0.9.
  Every loss within rtol 1e-5, the accuracy exactly, and every
  persistable (weights, velocities, batch norm's moving mean and
  variance) within rtol 1e-4 / atol 1e-5: a ResNet-18 step runs 20
  convolutions whose sums XLA and oneDNN order differently (~1e-7
  relative each), and batch norm divides by batch statistics of 4 x 4 x
  4-pixel maps in the last stage.
* Served: the JAX package saves each model's inference directory after
  two training steps (the moving statistics away from 0 and 1); the
  port's CPU ``Predictor`` answers within 1e-5 of the JAX ``Predictor``,
  and each row of a batch of 8 gives the bits it has served alone
  (tolerance 0: the forward-only convolutions and products keep a row's
  sums apart from its batchmates').
"""
import json

import numpy as np
import pytest

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
import paddle_tpu.models as j_models
import paddle_tpu_torch.models as t_models
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.framework.serde import program_to_json as j_to_json
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.framework.serde import program_to_json as t_to_json
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

LOSS_RTOL = 1e-5
STATE_RTOL, STATE_ATOL = 1e-4, 1e-5
SERVE_ATOL = 1e-5
STEPS = 3


def _reset(pkg):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()


def _program(pkg, kind):
    """(main, startup, feed names, outputs) of one configuration in
    `pkg`."""
    _reset(pkg)
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    main.random_seed = startup.random_seed = 21
    m = j_models if pkg is jpt else t_models
    with pkg.program_guard(main, startup):
        if kind == "lenet":
            feeds, outs = m.build_mnist_train(batch_size=8)
            pkg.optimizer.SGDOptimizer(learning_rate=0.05).minimize(
                outs["loss"])
        elif kind == "lenet_prediction":
            images = pkg.layers.data("images", [-1, 1, 28, 28],
                                     append_batch_size=False)
            feeds, outs = ["images"], m.lenet(images)
        elif kind.startswith("resnet"):
            depth = int(kind[6:8])
            if kind.endswith("is_test"):
                images = pkg.layers.data("images", [-1, 3, 224, 224],
                                         append_batch_size=False)
                feeds = ["images"]
                outs = m.resnet(images, depth=depth, is_test=True)
            else:
                feeds, outs = m.build_resnet_train(depth=depth)
        elif kind == "bench_resnet50":
            feeds, outs = m.build_resnet_train(batch_size=64, depth=50,
                                               image_size=224,
                                               class_num=1000)
            opt = pkg.optimizer.MomentumOptimizer(0.1, momentum=0.9)
            opt = pkg.contrib.mixed_precision.decorate(opt,
                                                       dtype="bfloat16")
            opt.minimize(outs["loss"])
        elif kind == "resnet18_small":
            feeds, outs = m.build_resnet_train(batch_size=4, depth=18,
                                               image_size=32, class_num=10)
            pkg.optimizer.MomentumOptimizer(0.01, 0.9).minimize(
                outs["loss"])
    return main, startup, feeds, outs


PROGRAMS = ["lenet", "lenet_prediction", "resnet18", "resnet18_is_test",
            "resnet50", "resnet50_is_test", "bench_resnet50"]


@pytest.mark.parametrize("kind", PROGRAMS)
def test_program_is_json_equal_to_the_jax_packages(kind):
    jm, js, _, _ = _program(jpt, kind)
    tm, ts, _, _ = _program(tpt, kind)
    assert json.loads(j_to_json(jm)) == json.loads(t_to_json(tm))
    assert json.loads(j_to_json(js)) == json.loads(t_to_json(ts))
    if kind.startswith("resnet50"):
        types = [op.type for op in tm.global_block().ops]
        assert types.count("conv2d") == 53
        assert types.count("batch_norm") == 53


def _feeds(kind, steps, batch, seed=5):
    rng = np.random.RandomState(seed)
    if kind == "lenet":
        shape, classes = (batch, 1, 28, 28), 10
    else:
        shape, classes = (batch, 3, 32, 32), 10
    return [{"images": rng.rand(*shape).astype("float32"),
             "label": rng.randint(0, classes, (batch, 1)).astype("int64")}
            for _ in range(steps)]


def _persistables(main):
    return [v.name for v in main.list_vars() if v.persistable]


@pytest.mark.parametrize("kind,batch", [("lenet", 8), ("resnet18_small", 4)])
def test_training_follows_the_jax_package(kind, batch):
    jm, js, _, jo = _program(jpt, kind)
    tm, ts, _, to = _program(tpt, kind)
    names = _persistables(jm)
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    j_exe.run(js, scope=j_scope)
    t_scope = scope_from_arrays(
        {n: np.asarray(j_scope.find_var(n)) for n in names}, "cpu", tm)
    t_exe = tpt.Executor(tpt.CPUPlace())
    for feed in _feeds(kind, STEPS, batch):
        want = j_exe.run(jm, feed=feed, fetch_list=[jo["loss"], jo["acc"]],
                         scope=j_scope)
        got = t_exe.run(tm, feed=feed, fetch_list=[to["loss"], to["acc"]],
                        scope=t_scope)
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    moving = [n for n in names if n.endswith((".mean_0", ".var_0"))
              or ".mean_" in n or ".var_" in n]
    if kind.startswith("resnet"):
        assert len(moving) == 2 * 20  # 17 convs + 3 shortcuts, each a BN
    for n in names:
        np.testing.assert_allclose(
            t_scope.find_var(n).numpy(), np.asarray(j_scope.find_var(n)),
            rtol=STATE_RTOL, atol=STATE_ATOL, err_msg=n)


@pytest.mark.parametrize("kind,batch", [("lenet", 8), ("resnet18_small", 4)])
def test_served_model_follows_the_jax_predictor(tmp_path, kind, batch):
    jm, js, _, jo = _program(jpt, kind)
    j_scope, j_exe = jpt.Scope(), jpt.Executor()
    out = jo["prediction"] if kind == "lenet" else jo["logits"]
    with jpt.scope_guard(j_scope):
        j_exe.run(js)
        for feed in _feeds(kind, 2, batch, seed=6):
            j_exe.run(jm, feed=feed, fetch_list=[jo["loss"]])
        jpt.io.save_inference_model(str(tmp_path), ["images"], [out], j_exe,
                                    main_program=jm)
    images = _feeds(kind, 1, 8, seed=7)[0]["images"]
    want = jpt.inference.Predictor(str(tmp_path)).run({"images": images})
    pred = tpt.inference.Predictor(str(tmp_path), device="cpu")
    got = pred.run({"images": images})
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=0,
                               atol=SERVE_ATOL)
    for r in range(8):
        alone = pred.run({"images": images[r:r + 1]})
        assert np.array_equal(alone[0], got[0][r:r + 1]), r


def test_served_convolutions_follow_a_weight_swap(tmp_path):
    """The forward-only route reshapes the filter inside each step, so a
    hot swap (contents exchanged in place) is served at once: after
    swap_weights the Predictor answers as a fresh one on the new weights,
    bit for bit, and revert_weights brings the old answers back."""
    tm, ts, _, to = _program(tpt, "lenet")
    images = _feeds("lenet", 1, 4, seed=8)[0]["images"]
    dirs = []
    for seed in (1, 2):
        scope = tpt.Scope()
        tm.random_seed = ts.random_seed = seed
        exe = tpt.Executor(tpt.CPUPlace())
        with tpt.scope_guard(scope):
            exe.run(ts)
            d = str(tmp_path / f"w{seed}")
            tpt.io.save_inference_model(d, ["images"], [to["prediction"]],
                                        exe, main_program=tm)
        dirs.append(d)
    pred = tpt.inference.Predictor(dirs[0], device="cpu")
    old = pred.run({"images": images})[0]
    want = tpt.inference.Predictor(dirs[1], device="cpu").run(
        {"images": images})[0]
    assert not np.array_equal(old, want)
    pred.swap_weights(dirs[1])
    assert np.array_equal(pred.run({"images": images})[0], want)
    pred.revert_weights()
    assert np.array_equal(pred.run({"images": images})[0], old)


@pytest.mark.parametrize("layer", ["conv2d_transpose", "auc"])
def test_layers_left_for_later_raise_naming_their_queue_item(layer):
    with pytest.raises(NotImplementedError, match="item 7"):
        getattr(tpt.layers, layer)(None, None)
