"""OptimizerWithMixedPrecision, as in
``paddle_tpu/contrib/mixed_precision/decorator.py``: minimize() = scale
the loss -> backward -> check_finite_and_unscale -> update_loss_scaling
-> apply the gradients.

Autocast happens at lowering time: ``backward`` sets
``program._amp_lowering`` and ``ops/registry._lower_with_amp`` casts each
white-list op's float inputs to the low-precision type (black-list ops
to float32), so the scope keeps float32 master weights.  bfloat16 has
float32's exponent range and needs no loss scaling: ``loss_scaling_0``
is created (1.0) and never applied.  float16 with dynamic loss scaling
multiplies the loss by ``loss_scaling_0`` (``elementwise_mul``), unscales
the gradients and updates the scale (``ops/amp_ops.py``).

A non-finite step zeroes every gradient and the optimizer ops still run,
as in the JAX package (the reference skips them conditionally): under
Adam such a step still decays the moments and advances the beta powers.
"""
from __future__ import annotations

from ... import layers
from ...framework.core import OpRole
from ...framework.layer_helper import LayerHelper
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
        # bf16 has fp32's exponent range: scaling is pointless
        self._use_scaling = use_dynamic_loss_scaling and dtype == "float16"
        self._init_loss_scaling = init_loss_scaling if self._use_scaling \
            else 1.0
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
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
            [1], self._init_loss_scaling, "float32", persistable=True,
            name="loss_scaling_0")
        scaled = layers.elementwise_mul(loss, self._loss_scaling) \
            if self._use_scaling else loss
        return self._optimizer.backward(
            scaled, startup_program, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        if self._use_scaling:
            self._unscale_and_update_scaling(params_grads)
        return self._optimizer.apply_gradients(params_grads)

    def _unscale_and_update_scaling(self, params_grads):
        """Append check_finite_and_unscale and update_loss_scaling over
        every gradient, each writing the gradients in place."""
        helper = LayerHelper("amp_check")
        grads = [g for _, g in params_grads if g is not None]
        found_inf = helper.create_variable_for_type_inference("bool")
        helper.append_op(
            "check_finite_and_unscale",
            inputs={"X": grads, "Scale": [self._loss_scaling]},
            outputs={"Out": grads, "FoundInfinite": [found_inf]},
            attrs={"op_role": OpRole.Backward})
        good = T.create_global_var([1], 0, "int32", persistable=True,
                                   name="loss_scaling_good_0")
        bad = T.create_global_var([1], 0, "int32", persistable=True,
                                  name="loss_scaling_bad_0")
        helper.append_op(
            "update_loss_scaling",
            inputs={"X": grads, "FoundInfinite": [found_inf],
                    "PrevLossScaling": [self._loss_scaling],
                    "InGoodSteps": [good], "InBadSteps": [bad]},
            outputs={"Out": grads, "LossScaling": [self._loss_scaling],
                     "OutGoodSteps": [good], "OutBadSteps": [bad]},
            attrs={"incr_every_n_steps": self._incr_every_n_steps,
                   "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
                   "incr_ratio": self._incr_ratio,
                   "decr_ratio": self._decr_ratio,
                   "op_role": OpRole.Backward})

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
    """The reference's mixed_precision.decorate."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dtype=dtype)
