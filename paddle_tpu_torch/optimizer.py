"""Static-graph optimizers: ``Optimizer`` and its updates (SGD, Momentum,
LARS, Adam, AdamW, Adagrad, Adamax, Adadelta, RMSProp, FTRL, LAMB,
DecayedAdagrad, DP-SGD), the wrappers ``RecomputeOptimizer``,
``GradientMergeOptimizer`` and ``LookaheadOptimizer``, and the parameter
swaps ``ExponentialMovingAverage`` and ``ModelAverage``.

Counterpart of ``paddle_tpu/optimizer.py``; ``DGCMomentumOptimizer`` and
``PipelineOptimizer`` raise (multi-device, ROADMAP queue 1 item 9).
``lazy_mode`` on Adam / AdamW is kept and reaches the op (``"lazy_mode": True`` where it is set, nothing at the
default, so a default program stays JSON-equal to the JAX package's);
the JAX package accepts the flag and drops it.
``minimize(loss)`` = append_backward + clip (the optimizer's, else the
program's from ``clip.set_gradient_clip``) + regularization + one
optimizer op per parameter, with the accumulators (moments, beta powers)
as persistable vars filled by the startup program.  The dygraph branches
and ``state_dict`` wait for item 8.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .framework.backward import append_backward
from .framework.core import (OpRole, Program, Variable, default_main_program,
                             default_startup_program, unique_name)
from .framework.initializer import ConstantInitializer
from .regularizer import append_regularization_ops

__all__ = [
    "Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
    "Adam", "AdamOptimizer", "AdamW", "Adagrad", "AdagradOptimizer",
    "Adamax", "AdamaxOptimizer", "Adadelta", "AdadeltaOptimizer",
    "RMSProp", "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb",
    "LambOptimizer", "LarsMomentum", "LarsMomentumOptimizer",
    "DecayedAdagrad", "DecayedAdagradOptimizer", "Dpsgd", "DpsgdOptimizer",
    "ExponentialMovingAverage", "ModelAverage", "LookaheadOptimizer",
    "RecomputeOptimizer", "PipelineOptimizer", "GradientMergeOptimizer",
    "DGCMomentumOptimizer",
]


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


class MomentumOptimizer(Optimizer):
    """Momentum SGD (the ``momentum`` op), optionally Nesterov."""
    op_type = "momentum"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, param):
        self._add_accumulator("velocity", param)

    def _append_optimize_op(self, param, grad, lr):
        v = self._get_accumulator("velocity", param)
        return default_main_program().current_block().append_op(
            "momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [v],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "VelocityOut": [v]},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    """Adam with bias correction folded into the step size (the
    reference's adam_op).  ``lazy_mode`` makes a SelectedRows gradient
    update only the rows it touches (parameter and moments); it does
    nothing to a dense gradient."""
    op_type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = bool(lazy_mode)

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
        return {"lazy_mode": True} if self._lazy_mode else {}


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
        return {**super()._extra_attrs(), "coeff": self._coeff}

    def _append_optimize_op(self, param, grad, lr):
        op = super()._append_optimize_op(param, grad, lr)
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(param.name):
            op.attrs["with_decay"] = False
        return op


class AdagradOptimizer(Optimizer):
    """Adagrad (the ``adagrad`` op): the moment sums squared gradients,
    from ``initial_accumulator_value``."""
    op_type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, param):
        self._add_accumulator("moment", param, fill_value=self._initial)

    def _append_optimize_op(self, param, grad, lr):
        m = self._get_accumulator("moment", param)
        return default_main_program().current_block().append_op(
            "adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon})


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


class LarsMomentumOptimizer(Optimizer):
    """Momentum with a layer-wise rate (the ``lars_momentum`` op; You,
    Gitman, Ginsburg 2017), at Fluid's defaults."""
    op_type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _create_accumulators(self, param):
        self._add_accumulator("velocity", param)

    def _append_optimize_op(self, param, grad, lr):
        v = self._get_accumulator("velocity", param)
        return default_main_program().current_block().append_op(
            "lars_momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [v],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    """Adamax (the ``adamax`` op); its beta1 power advances by a ``scale``
    op after each update, as in the reference."""
    op_type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, param):
        self._add_accumulator("moment", param)
        self._add_accumulator("inf_norm", param)
        self._add_accumulator("beta1_pow", param, shape=[1],
                              fill_value=self._beta1)

    def _append_optimize_op(self, param, grad, lr):
        m = self._get_accumulator("moment", param)
        inf = self._get_accumulator("inf_norm", param)
        b1p = self._get_accumulator("beta1_pow", param)
        block = default_main_program().current_block()
        op = block.append_op(
            "adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "InfNorm": [inf], "Beta1Pow": [b1p],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "MomentOut": [m],
                     "InfNormOut": [inf]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        block.append_op("scale", inputs={"X": [b1p]},
                        outputs={"Out": [b1p]},
                        attrs={"scale": self._beta1,
                               "op_role": OpRole.Optimize})
        return op


class AdadeltaOptimizer(Optimizer):
    """Adadelta (the ``adadelta`` op): no learning rate reaches the op."""
    op_type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, param):
        self._add_accumulator("avg_squared_grad", param)
        self._add_accumulator("avg_squared_update", param)

    def _append_optimize_op(self, param, grad, lr):
        g1 = self._get_accumulator("avg_squared_grad", param)
        g2 = self._get_accumulator("avg_squared_update", param)
        return default_main_program().current_block().append_op(
            "adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [g1], "AvgSquaredUpdate": [g2]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [g1],
                     "AvgSquaredUpdateOut": [g2]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    """RMSProp (the ``rmsprop`` op), centered or not, with momentum."""
    op_type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, param):
        self._add_accumulator("mean_square", param)
        self._add_accumulator("moment", param)
        self._add_accumulator("mean_grad", param)

    def _append_optimize_op(self, param, grad, lr):
        ms = self._get_accumulator("mean_square", param)
        mom = self._get_accumulator("moment", param)
        mg = self._get_accumulator("mean_grad", param)
        return default_main_program().current_block().append_op(
            "rmsprop",
            inputs={"Param": [param], "Grad": [grad], "MeanSquare": [ms],
                    "Moment": [mom], "MeanGrad": [mg],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "MeanSquareOut": [ms],
                     "MomentOut": [mom], "MeanGradOut": [mg]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    """FTRL-proximal (the ``ftrl`` op) at any ``lr_power``."""
    op_type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, param):
        self._add_accumulator("squared", param)
        self._add_accumulator("linear", param)

    def _append_optimize_op(self, param, grad, lr):
        sq = self._get_accumulator("squared", param)
        lin = self._get_accumulator("linear", param)
        return default_main_program().current_block().append_op(
            "ftrl",
            inputs={"Param": [param], "Grad": [grad],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class LambOptimizer(AdamOptimizer):
    """LAMB (the ``lamb`` op; You et al. 2020): Adam's moments and a
    trust ratio a parameter.  A parameter for which
    ``exclude_from_weight_decay_fn(param)`` is true gets weight decay 0
    (the usual recipe exempts the biases and LayerNorm's scales and
    shifts)."""
    op_type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6,
                 exclude_from_weight_decay_fn=None, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, param, grad, lr):
        m1 = self._get_accumulator("moment1", param)
        m2 = self._get_accumulator("moment2", param)
        b1p = self._get_accumulator("beta1_pow", param)
        b2p = self._get_accumulator("beta2_pow", param)
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(param):
            wd = 0.0
        return default_main_program().current_block().append_op(
            "lamb",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "Beta1Pow": [b1p], "Beta2Pow": [b2p],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class DecayedAdagradOptimizer(Optimizer):
    """Adagrad with a decaying moment (the ``decayed_adagrad`` op)."""
    op_type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, param):
        self._add_accumulator("moment", param)

    def _append_optimize_op(self, param, grad, lr):
        m = self._get_accumulator("moment", param)
        return default_main_program().current_block().append_op(
            "decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [m],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class DpsgdOptimizer(Optimizer):
    """Differentially private SGD (the ``dpsgd`` op): a clipped gradient
    plus noise from the op's own generator."""
    op_type = "dpsgd"

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0,
                 sigma=1.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, param, grad, lr):
        return default_main_program().current_block().append_op(
            "dpsgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [lr]},
            outputs={"ParamOut": [param]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


class DGCMomentumOptimizer(MomentumOptimizer):
    """Momentum with deep gradient compression: its sparse allreduce is
    multi-device work."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DGCMomentumOptimizer compresses gradients for a multi-device "
            "allreduce (dgc_ops), which waits for ROADMAP.md queue 1, "
            "item 9")


class PipelineOptimizer:
    """Pipeline-parallel training: multi-device work."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PipelineOptimizer runs stages across devices, which waits for "
            "ROADMAP.md queue 1, item 9")


class GradientMergeOptimizer:
    """Accumulate gradients for `k_steps` runs, then apply one update of
    the inner optimizer (any of them, the AMP decorator included) to
    their sum, or their mean with `avg`.

    The program is the reference's: a float32 step counter incremented
    every run, ``cond = (step mod k == 0)``, an accumulator a parameter
    added to every run, and one ``conditional_block`` holding the inner
    optimizer's ops (with their clip and regularization), the scale by
    1 / k and the accumulators' reset.  On the card the block is computed
    every run and selected on the device (``ops/control_flow_ops.py``),
    so the step stays one captured graph and a run that does not update
    leaves every parameter and optimizer state bit-identical."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner_optimizer = inner_optimizer
        self.k_steps = int(k_steps)
        self.avg = avg

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .framework.layer_helper import LayerHelper
        from .layers import tensor as T
        from .layers.control_flow import outer_writes

        params_grads = self.inner_optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set)
        main = loss.block.program
        block = main.global_block()
        helper = LayerHelper("gradient_merge")

        step = T.create_global_var([1], 0.0, "float32", persistable=True,
                                   name=unique_name("gm_step"))
        T.increment(step, 1.0)
        k_const = T.fill_constant([1], "float32", float(self.k_steps))
        mod = T.elementwise_mod(step, k_const)
        cond_var = T.equal(mod, T.fill_constant([1], "float32", 0.0))

        accs = []
        for p, g in params_grads:
            acc = T.create_global_var(list(g.shape), 0.0, "float32",
                                      persistable=True,
                                      name=unique_name(f"{p.name}.gm_acc"))
            helper.append_op("elementwise_add",
                             inputs={"X": [acc], "Y": [g]},
                             outputs={"Out": [acc]},
                             attrs={"op_role": OpRole.Backward})
            accs.append(acc)

        sub = main._create_block()
        merged = []
        for acc in accs:
            if self.avg:
                m = helper.create_variable_for_type_inference("float32")
                helper.append_op("scale", inputs={"X": [acc]},
                                 outputs={"Out": [m]},
                                 attrs={"scale": 1.0 / self.k_steps,
                                        "op_role": OpRole.Optimize})
            else:
                m = acc
            merged.append(m)
        self.inner_optimizer.apply_gradients(
            [(p, m) for (p, _), m in zip(params_grads, merged)])
        for acc in accs:
            helper.append_op("scale", inputs={"X": [acc]},
                             outputs={"Out": [acc]},
                             attrs={"scale": 0.0,
                                    "op_role": OpRole.Optimize})
        main._rollback()

        block.append_op("conditional_block",
                        inputs={"Cond": [cond_var]},
                        outputs={"Out": [block._find_var_recursive(n)
                                         for n in outer_writes(sub, block)]},
                        attrs={"sub_block": sub.idx,
                               "op_role": OpRole.Optimize},
                        infer_shape=False)
        main.bump()
        return [], params_grads

    def __getattr__(self, item):
        return getattr(self.__dict__["inner_optimizer"], item)


class _ParamSwapBase:
    """``apply()`` / ``restore()`` for strategies that evaluate with
    substituted parameter values (EMA, ModelAverage).  The swap exchanges
    contents in the scope's own tensors (``copy_``), as a weight swap
    does: every parameter keeps its tensor and ``data_ptr``, so no
    compiled entry captures again, and ``restore`` copies the saved
    values back bit for bit.  Subclasses give
    ``_substitute_value(scope, param)``: a tensor on the parameter's
    device, or None to keep the parameter."""

    _params: List[Variable]
    _backups: Dict[str, object]

    def apply(self, executor=None, need_restore=True, scope=None):
        """A context manager under which the parameters hold the
        substituted values; `scope` is the scope training ran in (the
        global one by default), `executor` is the reference's argument
        and unused."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            self._swap_in(scope)
            try:
                yield
            finally:
                if need_restore:
                    self.restore(executor, scope=scope)
        return _ctx()

    def _swap_in(self, scope=None):
        from .framework.executor import global_scope

        scope = scope or global_scope()
        self._backups = {}
        found = 0
        for p in self._params:
            cur = scope.find_var(p.name)
            if cur is None:
                continue  # startup not run in this scope
            found += 1
            sub = self._substitute_value(scope, p)
            if sub is None:
                continue  # nothing accumulated yet: keep the raw value
            self._backups[p.name] = cur.clone()
            cur.copy_(sub)
        if self._params and not found:
            raise RuntimeError(
                f"{type(self).__name__}.apply(): no parameter values found "
                "in the scope; did training run in a different scope? "
                "Pass it via apply(..., scope=your_scope).")

    def _substitute_value(self, scope, param):
        raise NotImplementedError

    def restore(self, executor=None, scope=None):
        from .framework.executor import global_scope

        scope = scope or global_scope()
        for name, val in self._backups.items():
            scope.find_var(name).copy_(val)
        self._backups = {}


def _host_scalar(value) -> float:
    return float(value.reshape(-1)[0])


class ExponentialMovingAverage(_ParamSwapBase):
    """EMA of the trainable parameters: ``update()`` (after the
    optimizer's ``minimize``) appends ema = decay ema + (1 - decay) p a
    parameter, the decay's running product and a step counter to the
    training step; ``apply()`` swaps in ema / (1 - prod decay) (bias
    corrected).  `thres_steps` ramps the decay as min(decay, (1 + t) /
    (10 + t)), t a step Variable or, with True, the EMA's own counter."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        from .framework.core import op_role_guard
        from .layers import tensor as T

        self._decay = float(decay)
        self._thres_steps = thres_steps
        self._name = name or unique_name("ema")
        self._ema_vars: Dict[str, Variable] = {}
        self._params = [p for p in
                        default_main_program().global_block()
                        .all_parameters() if p.trainable]
        self._backups = {}
        with op_role_guard(OpRole.Optimize):
            self._step = T.create_global_var(
                [1], 0.0, "int64", persistable=True,
                name=unique_name(f"{self._name}.step"))
            self._decay_pow = T.create_global_var(
                [1], 1.0, "float32", persistable=True,
                name=unique_name(f"{self._name}.decay_pow"))
            for p in self._params:
                self._ema_vars[p.name] = T.create_global_var(
                    list(p.shape), 0.0, "float32", persistable=True,
                    name=unique_name(f"{p.name}.ema"))

    def _decay_var(self):
        """This step's [1] float32 decay, constant or ramped."""
        from .layers import tensor as T

        const = T.fill_constant([1], "float32", self._decay)
        if self._thres_steps is None:
            return const
        t = (self._thres_steps if isinstance(self._thres_steps, Variable)
             else self._step)
        tf = T.cast(t, "float32")
        ramp = T.elementwise_div(T.scale(tf, 1.0, bias=1.0),
                                 T.scale(tf, 1.0, bias=10.0))
        return T.elementwise_min(const, ramp)

    def update(self):
        """Append the EMA update to the training step."""
        from .framework.core import op_role_guard
        from .framework.layer_helper import LayerHelper
        from .layers import tensor as T

        with op_role_guard(OpRole.Optimize):
            T.increment(self._step, 1.0)
            helper = LayerHelper("ema_update")
            decay = self._decay_var()
            helper.append_op(
                "elementwise_mul",
                inputs={"X": [self._decay_pow], "Y": [decay]},
                outputs={"Out": [self._decay_pow]})
            one_minus = T.scale(decay, -1.0, bias=1.0,
                                bias_after_scale=True)
            for p in self._params:
                ema = self._ema_vars[p.name]
                scaled_e = T.elementwise_mul(ema, decay)
                scaled_p = T.elementwise_mul(p, one_minus)
                helper.append_op(
                    "elementwise_add",
                    inputs={"X": [scaled_e], "Y": [scaled_p]},
                    outputs={"Out": [ema]})
        default_main_program().bump()

    def _substitute_value(self, scope, param):
        ema = scope.find_var(self._ema_vars[param.name].name)
        if ema is None:
            return None
        decay_pow = scope.find_var(self._decay_pow.name)
        correction = 1.0
        if decay_pow is not None:
            dp = _host_scalar(decay_pow)
            if dp < 1.0:
                correction = 1.0 - dp
        return ema / correction


class ModelAverage(_ParamSwapBase):
    """A sliding-window average of the parameters: one
    ``average_accumulates`` op a parameter in the training step (the
    reference's window rotation and spill); ``apply()`` swaps in
    (sum_1 + sum_2 + sum_3) / (num_accumulates + old_num_accumulates)."""

    _ACCS = (("sum_1", None, "float32"), ("sum_2", None, "float32"),
             ("sum_3", None, "float32"), ("num_accumulates", [1], "int64"),
             ("old_num_accumulates", [1], "int64"),
             ("num_updates", [1], "int64"))

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        from .framework.core import op_role_guard
        from .framework.layer_helper import LayerHelper
        from .layers import tensor as T

        self._name = name or unique_name("model_average")
        self._avg_rate = float(average_window_rate)
        self._min_win = int(min_average_window)
        self._max_win = int(max_average_window)
        self._accs: Dict[str, Dict[str, Variable]] = {}
        self._params = [p for p in
                        default_main_program().global_block()
                        .all_parameters() if p.trainable]
        self._backups = {}
        helper = LayerHelper("model_average")
        with op_role_guard(OpRole.Optimize):
            for p in self._params:
                a = {nm: T.create_global_var(
                    list(p.shape if shape is None else shape), 0.0, dtype,
                    persistable=True,
                    name=unique_name(f"{p.name}.{self._name}.{nm}"))
                    for nm, shape, dtype in self._ACCS}
                self._accs[p.name] = a
                helper.append_op(
                    "average_accumulates",
                    inputs={"Param": [p],
                            "InSum1": [a["sum_1"]],
                            "InSum2": [a["sum_2"]],
                            "InSum3": [a["sum_3"]],
                            "InNumAccumulates": [a["num_accumulates"]],
                            "InOldNumAccumulates":
                                [a["old_num_accumulates"]],
                            "InNumUpdates": [a["num_updates"]]},
                    outputs={"OutSum1": [a["sum_1"]],
                             "OutSum2": [a["sum_2"]],
                             "OutSum3": [a["sum_3"]],
                             "OutNumAccumulates": [a["num_accumulates"]],
                             "OutOldNumAccumulates":
                                 [a["old_num_accumulates"]],
                             "OutNumUpdates": [a["num_updates"]]},
                    attrs={"average_window": self._avg_rate,
                           "min_average_window": self._min_win,
                           "max_average_window": self._max_win})
        default_main_program().bump()

    def _substitute_value(self, scope, param):
        vals = {nm: scope.find_var(v.name)
                for nm, v in self._accs[param.name].items()}
        if any(v is None for v in vals.values()):
            return None
        total = _host_scalar(vals["num_accumulates"]) + \
            _host_scalar(vals["old_num_accumulates"])
        if total <= 0:
            return None
        return (vals["sum_1"] + vals["sum_2"] + vals["sum_3"]) / total


class LookaheadOptimizer:
    """Lookahead over a fast inner optimizer (k steps forward, one back):
    every k runs slow += alpha (fast - slow) and fast = slow, as a pair
    of where-selects in the step, the reference's own formulation."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError("alpha must be in [0, 1]")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from .framework.core import op_role_guard
        from .framework.layer_helper import LayerHelper
        from .layers import tensor as T

        result = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        main = default_main_program()
        startup = default_startup_program()
        params = [p for p in main.global_block().all_parameters()
                  if p.trainable]
        helper = LayerHelper("lookahead")
        with op_role_guard(OpRole.Optimize):
            step = T.create_global_var([1], 0.0, "int64",
                                       persistable=True,
                                       name=unique_name("lookahead_step"))
            T.increment(step, 1.0)
            mod = T.elementwise_mod(
                step, T.fill_constant([1], "int64", float(self.k)))
            sync = T.equal(mod, T.fill_constant([1], "int64", 0.0))
            for p in params:
                slow = T.create_global_var(
                    list(p.shape), 0.0, "float32", persistable=True,
                    name=unique_name(f"{p.name}.slow"))
                # the slow copy starts at the initialized parameter
                startup.global_block().append_op(
                    "assign", inputs={"X": [p.name]},
                    outputs={"Out": [slow.name]})
                new_slow = T.elementwise_add(
                    T.scale(slow, 1.0 - self.alpha),
                    T.scale(p, self.alpha))
                sel_slow = T.where(sync, new_slow, slow)
                sel_fast = T.where(sync, new_slow, p)
                helper.append_op("assign", inputs={"X": [sel_slow]},
                                 outputs={"Out": [slow]})
                helper.append_op("assign", inputs={"X": [sel_fast]},
                                 outputs={"Out": [p]})
        main.bump()
        return result

    def __getattr__(self, item):
        return getattr(self.__dict__["inner_optimizer"], item)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adagrad = AdagradOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Dpsgd = DpsgdOptimizer
