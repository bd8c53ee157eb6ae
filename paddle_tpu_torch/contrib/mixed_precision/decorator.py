"""OptimizerWithMixedPrecision, as in
``paddle_tpu/contrib/mixed_precision/decorator.py``.

Autocast happens at lowering time: ``backward`` sets
``program._amp_lowering`` and ``ops/registry._lower_with_amp`` casts each
white-list op's float inputs to the low-precision type (black-list ops
to float32), so the scope keeps float32 master weights.  bfloat16 has
float32's exponent range and needs no loss scaling: ``loss_scaling_0`` is
created (1.0) and never applied.  Dynamic loss scaling for float16
(``check_finite_and_unscale``, ``update_loss_scaling``) waits and raises.
"""
from __future__ import annotations

from ...layers import tensor as T
from .fp16_lists import AutoMixedPrecisionLists


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None,
                 init_loss_scaling=2.0 ** 15,
                 use_dynamic_loss_scaling=True,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.5, dtype="bfloat16"):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._dtype = dtype
        if use_dynamic_loss_scaling and dtype == "float16":
            raise NotImplementedError(
                "float16 with dynamic loss scaling is not ported yet; use "
                "dtype='bfloat16'")
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        loss.block.program._amp_lowering = {
            "dtype": self._dtype,
            "white": self._amp_lists.white_list,
            "black": self._amp_lists.black_list,
        }
        self._loss_scaling = T.create_global_var(
            [1], 1.0, "float32", persistable=True, name="loss_scaling_0")
        return self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads

    def __getattr__(self, item):
        return getattr(self.__dict__["_optimizer"], item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5,
             use_dynamic_loss_scaling=True, dtype="bfloat16"):
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dtype=dtype)
