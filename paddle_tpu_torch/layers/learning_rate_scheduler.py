"""Learning-rate schedules as graph ops on a step counter.

Counterpart of ``paddle_tpu/layers/learning_rate_scheduler.py``: each
schedule appends ops (role LRSched) that recompute the LR var from a
global int64 counter the program increments once per run: ``noam_decay``,
``exponential_decay``, ``natural_exp_decay``, ``inverse_time_decay``,
``polynomial_decay`` (with ``cycle``), ``piecewise_decay``,
``cosine_decay``, and ``linear_lr_warmup`` around any of them or a
float.  Each schedule has a counter of its own, so a warmup's wrapped
decay counts from the first run, not from the warmup's end.  All return a
[1] float32 Variable for an optimizer's ``learning_rate``.
"""
from __future__ import annotations

import math

from ..framework.core import OpRole, op_role_guard, unique_name
from . import nn, tensor

__all__ = [
    "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]


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


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    """lr * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5) (Vaswani
    et al.); its counter starts at 1."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter(begin=1)
        a = tensor.pow(step, -0.5)
        b = tensor.elementwise_mul(step, _const(warmup_steps ** -1.5))
        lr = tensor.scale(tensor.elementwise_min(a, b),
                          float(learning_rate) * (d_model ** -0.5))
    return lr


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate ^ (step / decay_steps)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        ratio = tensor.scale(step, 1.0 / decay_steps)
        if staircase:
            ratio = nn.floor(ratio)
        lr = tensor.scale(
            tensor.elementwise_pow(_const(decay_rate), ratio),
            float(learning_rate))
    return lr


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        ratio = tensor.scale(step, 1.0 / decay_steps)
        if staircase:
            ratio = nn.floor(ratio)
        lr = tensor.scale(
            nn.exp(tensor.scale(ratio, -float(decay_rate))),
            float(learning_rate))
    return lr


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        ratio = tensor.scale(step, 1.0 / decay_steps)
        if staircase:
            ratio = nn.floor(ratio)
        denom = tensor.scale(ratio, float(decay_rate), bias=1.0)
        lr = tensor.elementwise_div(_const(learning_rate), denom)
    return lr


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end_lr) * (1 - step/decay_steps)^power + end_lr."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        if cycle:
            # decay_steps grows: decay_steps * ceil(step / decay_steps)
            div = tensor.elementwise_div(step, _const(decay_steps))
            ceil_div = nn.ceil(div)
            # step 0 gives ceil 0: one period all the same
            zero = _const(0.0)
            is_zero = tensor.cast(tensor.equal(step, zero), "float32")
            ceil_div = tensor.elementwise_add(ceil_div, is_zero)
            steps_var = tensor.scale(ceil_div, float(decay_steps))
        else:
            steps_var = _const(decay_steps)
            step = tensor.elementwise_min(step, steps_var)
        frac = tensor.elementwise_sub(
            _const(1.0), tensor.elementwise_div(step, steps_var))
        poly = tensor.elementwise_pow(frac, _const(power))
        lr = tensor.scale(poly, float(learning_rate - end_learning_rate),
                          bias=float(end_learning_rate),
                          bias_after_scale=True)
    return lr


def piecewise_decay(boundaries, values):
    """Step-function schedule: values[i] while step < boundaries[i], as
    a chain of ``where`` selects, one a boundary."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("piecewise_decay: len(values) must be "
                         "len(boundaries) + 1")
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        lr = _const(values[-1])
        for bound, val in reversed(list(zip(boundaries, values))):
            cond = tensor.less_than(step, _const(bound))
            lr = tensor.where(cond, _const(val), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """0.5 * lr * (1 + cos(pi * epoch / epochs)), epoch = floor(step /
    step_each_epoch): down to 0 at `epochs` (it has no floor above 0)."""
    with op_role_guard(OpRole.LRSched):
        step = _decay_step_counter()
        epoch = nn.floor(tensor.scale(step, 1.0 / step_each_epoch))
        cos_arg = tensor.scale(epoch, math.pi / epochs)
        lr = tensor.scale(nn.cos(cos_arg),
                          0.5 * float(learning_rate),
                          bias=0.5 * float(learning_rate),
                          bias_after_scale=True)
    return lr


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear ramp start_lr -> end_lr over warmup_steps, then the wrapped
    schedule (a Variable from any decay above, or a float)."""
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
