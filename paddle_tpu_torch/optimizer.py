"""Static-graph optimizers: ``Optimizer``, ``SGDOptimizer``,
``AdamOptimizer``, ``AdamW`` and ``RecomputeOptimizer``.

Counterpart of ``paddle_tpu/optimizer.py:34-152``, ``:217-227``,
``:323-384`` and ``:604-641``.
``minimize(loss)`` = append_backward + clip (the optimizer's, else the
program's from ``clip.set_gradient_clip``) + regularization + one
optimizer op per parameter, with the accumulators (moments, beta powers)
as persistable vars filled by the startup program.  The dygraph branches,
``state_dict`` and the other optimizers wait for later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .framework.backward import append_backward
from .framework.core import (OpRole, Program, Variable, default_main_program,
                             default_startup_program, unique_name)
from .framework.initializer import ConstantInitializer
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Adam", "AdamOptimizer",
           "AdamW", "RecomputeOptimizer"]


class Optimizer:
    op_type = None

    def __init__(self, learning_rate=0.001, parameter_list=None,
                 regularization=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = parameter_list
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name or unique_name(self.__class__.__name__.lower())
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None

    def _create_lr_var(self, program: Program) -> Variable:
        if self._lr_var is not None and \
                self._lr_var.block.program is program:
            return self._lr_var
        from .layers.tensor import create_global_var
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return self._lr_var
        self._lr_var = create_global_var(
            [1], float(self._learning_rate), "float32", persistable=True,
            name=unique_name(f"{self._name}.lr"))
        return self._lr_var

    def _add_accumulator(self, name: str, param: Variable, shape=None,
                         fill_value=0.0, dtype="float32") -> Variable:
        acc = self._accumulators.setdefault(name, {})
        if param.name in acc:
            return acc[param.name]
        shape = list(shape if shape is not None else param.shape)
        v = default_main_program().global_block().create_var(
            name=unique_name(f"{self._name}.{param.name}.{name}"),
            shape=shape, dtype=dtype, persistable=True, stop_gradient=True)
        ConstantInitializer(fill_value)(
            v, default_startup_program().global_block())
        acc[param.name] = v
        return v

    def _get_accumulator(self, name: str, param: Variable) -> Variable:
        return self._accumulators[name][param.name]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list or self._parameter_list,
                               no_grad_set, callbacks)

    def apply_gradients(self, params_grads: List[Tuple[Variable, Variable]]):
        clip = self._grad_clip
        if clip is None:
            # the program's default from clip.set_gradient_clip, over its
            # parameter list where it has one
            program = default_main_program()
            clip = getattr(program, "_gradient_clip", None)
            only = getattr(program, "_gradient_clip_params", None)
            if clip is not None and only:
                keep = [(p, g) for p, g in params_grads if p.name in only]
                rest = [(p, g) for p, g in params_grads
                        if p.name not in only]
                params_grads = clip(keep) + rest
                clip = None
        if clip is not None:
            params_grads = clip(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        return self.apply_optimize(params_grads)

    def apply_optimize(self, params_grads):
        program = default_main_program()
        lr = self._create_lr_var(program)
        for p, _ in params_grads:
            self._create_accumulators(p)
        ops = []
        for p, g in params_grads:
            op = self._append_optimize_op(p, g, lr)
            if op is not None:
                op.attrs["op_role"] = OpRole.Optimize
                ops.append(op)
        program.bump()
        return ops

    def _create_accumulators(self, param: Variable):
        pass

    def _append_optimize_op(self, param, grad, lr):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    """Plain gradient descent (the ``sgd`` op)."""
    op_type = "sgd"

    def _append_optimize_op(self, param, grad, lr):
        return default_main_program().current_block().append_op(
            "sgd", inputs={"Param": [param], "Grad": [grad],
                           "LearningRate": [lr]},
            outputs={"ParamOut": [param]})


class AdamOptimizer(Optimizer):
    """Adam with bias correction folded into the step size (the
    reference's adam_op).  ``lazy_mode`` is accepted and, as in the JAX
    package, has no effect on a dense gradient."""
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, param):
        self._add_accumulator("moment1", param)
        self._add_accumulator("moment2", param)
        self._add_accumulator("beta1_pow", param, shape=[1],
                              fill_value=self._beta1)
        self._add_accumulator("beta2_pow", param, shape=[1],
                              fill_value=self._beta2)

    def _append_optimize_op(self, param, grad, lr):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        return default_main_program().current_block().append_op(
            self.op_type,
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, **self._extra_attrs()})

    def _extra_attrs(self):
        return {}


class AdamW(AdamOptimizer):
    """Adam with decoupled weight decay (the ``adamw`` op): the parameter
    is scaled by 1 - lr * weight_decay before the Adam update.  A
    parameter for which ``apply_decay_param_fun(name)`` is false is not
    decayed (``with_decay`` False on its op)."""
    op_type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, apply_decay_param_fun=None,
                 **kwargs):
        kwargs.pop("coeff", None)
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._coeff = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _extra_attrs(self):
        return {"coeff": self._coeff}

    def _append_optimize_op(self, param, grad, lr):
        op = super()._append_optimize_op(param, grad, lr)
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(param.name):
            op.attrs["with_decay"] = False
        return op


class RecomputeOptimizer:
    """Activation recompute around an inner optimizer: set checkpoints
    with ``_set_checkpoints([...vars...])``, then ``minimize``; the
    backward re-emits each segment between checkpoints
    (``append_backward(checkpoints=...)``).  Any other attribute is the
    inner optimizer's."""

    def __init__(self, optimizer):
        self.inner_optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = list(checkpoints)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if not self._checkpoints:
            raise ValueError("RecomputeOptimizer: call _set_checkpoints "
                             "before minimize (reference semantics)")
        return append_backward(loss,
                               parameter_list or
                               self.inner_optimizer._parameter_list,
                               no_grad_set, callbacks,
                               checkpoints=self._checkpoints)

    def apply_gradients(self, params_grads):
        return self.inner_optimizer.apply_gradients(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        return self.apply_gradients(params_grads), params_grads

    def __getattr__(self, item):
        return getattr(self.__dict__["inner_optimizer"], item)


SGD = SGDOptimizer
Adam = AdamOptimizer
