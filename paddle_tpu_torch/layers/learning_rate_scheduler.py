"""Learning-rate schedules as graph ops on a step counter.

Counterpart of ``paddle_tpu/layers/learning_rate_scheduler.py``: each
schedule appends ops (role LRSched) that recompute the LR var from a
global int64 counter the program increments once per run.  Only
``linear_lr_warmup`` over a constant LR, the flagship's schedule, is
ported; the decay schedules wait.
"""
from __future__ import annotations

from ..framework.core import OpRole, op_role_guard, unique_name
from . import tensor

__all__ = ["linear_lr_warmup"]


def _decay_step_counter(begin: int = 0):
    """Global step counter, incremented once per executed run; an int64
    var (a float32 one would stop counting at 2**24), returned as float32
    for the schedule math."""
    counter = tensor.create_global_var(
        [1], float(begin - 1), "int64", persistable=True,
        name=unique_name("@LR_DECAY_COUNTER@"))
    tensor.increment(counter, 1.0)
    return tensor.cast(counter, "float32")


def _const(value):
    return tensor.fill_constant([1], "float32", float(value))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear ramp start_lr -> end_lr over warmup_steps, then
    `learning_rate` (a float or a [1] float32 Variable)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        ramp = tensor.scale(
            step, (float(end_lr) - float(start_lr)) / float(warmup_steps),
            bias=float(start_lr), bias_after_scale=True)
        if not hasattr(learning_rate, "name"):  # plain float
            learning_rate = _const(learning_rate)
        cond = tensor.less_than(step, _const(warmup_steps))
        lr = tensor.where(cond, ramp, learning_rate)
    return lr
