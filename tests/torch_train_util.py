"""Shared helpers of the TrainGuard, checkpoint and executor-telemetry
twins (tests/test_torch_checkpoint.py, test_torch_train_guard.py,
test_torch_telemetry_executor.py, test_torch_profiler_memory.py): the
reference tests' ``_net`` and ``_feed`` built in either package with the
same variable names, and a started executor on the CPU.
"""
import numpy as np

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed


def net(pkg=tpt, lr=0.1, dropout=0.0):
    """The reference tests' ``_net``: x [N, 4] -> fc(1, name "gfc") ->
    mean(square_error_cost), SGD(lr); with `dropout` the fc's input goes
    through dropout first.  Names and op seeds restart, so both packages
    build the same program.  Returns (main, startup, loss, weight name)."""
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
    else:
        tpt.reset_unique_name()
        t_reset_seed()
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [1])
        if dropout:
            x = pkg.layers.dropout(x, dropout_prob=dropout)
        pred = pkg.layers.fc(x, 1, name="gfc")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGDOptimizer(lr).minimize(loss)
    w = main.global_block().all_parameters()[0]
    return main, startup, loss, w.name


def feed(seed=0, nan=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(8, 4).astype("float32")
    if nan:
        x = np.full_like(x, np.nan)
    return {"x": x, "y": (x.sum(1, keepdims=True) * 0.5).astype("float32")}


def started(main, startup, scope=None):
    """A CPU executor that has run `startup` into `scope` (a new one by
    default); returns (executor, scope)."""
    scope = scope if scope is not None else tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    return exe, scope


def copied(scope, names):
    """A new scope holding a copy of `scope`'s values of `names` (the
    executor updates state in place: two runs from one startup scope need
    two copies)."""
    out = tpt.Scope()
    for n in names:
        out.set_var(n, scope.find_var(n).clone())
    return out


def arrays(scope, program):
    """Every persistable of `program` in `scope`, as numpy."""
    return {v.name: np.asarray(scope.find_var(v.name))
            for v in program.list_vars() if v.persistable
            and scope.find_var(v.name) is not None}
