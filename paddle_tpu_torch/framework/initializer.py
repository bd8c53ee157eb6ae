"""Parameter initializers: append init ops to the startup program.

Counterpart of ``paddle_tpu/framework/initializer.py``: Constant, Uniform,
Normal, TruncatedNormal, Xavier, MSRA and NumpyArray (``fill_constant``,
``uniform_random``, ``gaussian_random``, ``truncated_gaussian_random``,
``assign_value``).  Each initializer emits the same op with the same
attrs as the JAX package; the random ones draw from the op's generator
(ops/registry.py ``LowerContext.rng``), other numbers than jax.random's.
"""
from __future__ import annotations

import math

import numpy as np

from .core import Variable, default_startup_program

__all__ = [
    "Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
    "Xavier", "MSRA", "NumpyArrayInitializer", "ConstantInitializer",
    "UniformInitializer", "NormalInitializer", "XavierInitializer",
    "MSRAInitializer", "TruncatedNormalInitializer",
]


class Initializer:
    def __call__(self, var: Variable, block=None):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0, force_cpu: bool = False):
        self.value = value

    def __call__(self, var: Variable, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
        return block.append_op(
            "fill_constant", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var: Variable, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
        return block.append_op(
            "uniform_random", outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var: Variable, block=None):
        return _random_init(var, block, "gaussian_random", self.loc,
                            self.scale, self.seed)


class TruncatedNormalInitializer(Initializer):
    """A normal draw truncated to two standard deviations."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var: Variable, block=None):
        return _random_init(var, block, "truncated_gaussian_random",
                            self.loc, self.scale, self.seed)


def _random_init(var, block, op_type, mean, std, seed):
    block = block or default_startup_program().global_block()
    block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                     persistable=True)
    return block.append_op(
        op_type, outputs={"Out": [var.name]},
        attrs={"shape": list(var.shape), "dtype": var.dtype,
               "mean": float(mean), "std": float(std), "seed": seed})


def _fan_in_out(var: Variable):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) > 2:  # conv filter OIHW
        receptive = int(np.prod(shape[2:]))
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    else:
        fan_in = fan_out = int(np.prod(shape)) if shape else 1
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init: uniform over sqrt(6 / (fan_in + fan_out)), or normal
    with std sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out
        self.seed = seed

    def __call__(self, var: Variable, block=None):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """Kaiming-He init from the fan-in: uniform over sqrt(6 / fan_in), or
    normal with std sqrt(2 / fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var: Variable, block=None):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / fi)
        return NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """The parameter set to a given array (``assign_value``)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var: Variable, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                         persistable=True)
        return block.append_op(
            "assign_value", outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                   "values": self.value.ravel().tolist()})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
