"""Carry parameters and training state from the JAX package into the port.

The two packages name and lay out persistable vars the same way (``fc``
weights [in, out], embeddings [V, H], layer-norm scale and bias [H],
Adam's moments and beta powers, the LR counter, ``loss_scaling_0``), so
moving a JAX scope across is a dtype and device conversion of numpy
arrays keyed by variable name, checked against the port's program.  Each
value takes its var's declared dtype: the JAX package without x64 hands
the int64 ``@LR_DECAY_COUNTER@`` back as int32.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np

from .framework.core import Program
from .framework.executor import Scope, to_tensor

__all__ = ["scope_from_arrays"]


def scope_from_arrays(arrays: Mapping[str, np.ndarray], device,
                      program: Union[Program, Sequence[Program], None] = None
                      ) -> Scope:
    """A Scope holding each array as a tensor on `device`.

    With `program`, the names must be exactly the program's persistable
    vars, each array must have its var's shape, and it is converted to
    its var's dtype; a missing, unknown or misshapen entry raises.  A
    list of programs that share parameters by name (a seq2seq's training
    and decoding programs) takes the union of their persistable vars; a
    name two of them declare with another shape or dtype raises.
    """
    from .device import resolve_device

    dev = resolve_device(device)
    scope = Scope()
    if program is None:
        for name, arr in arrays.items():
            scope.set_var(name, to_tensor(np.asarray(arr), dev))
        return scope
    programs = [program] if isinstance(program, Program) else list(program)
    want = {}
    for prog in programs:
        for v in prog.list_vars():
            if not v.persistable:
                continue
            seen = want.setdefault(v.name, v)
            if (seen.shape is not None and v.shape is not None
                    and tuple(seen.shape) != tuple(v.shape)) or \
                    seen.dtype != v.dtype:
                raise ValueError(
                    f"scope_from_arrays: {v.name!r} is {seen.dtype} "
                    f"{seen.shape} in one program and {v.dtype} {v.shape} "
                    f"in another")
    missing = sorted(set(want) - set(arrays))
    unknown = sorted(set(arrays) - set(want))
    if missing or unknown:
        raise ValueError(f"scope_from_arrays: missing {missing[:5]}, "
                         f"unknown {unknown[:5]} against the program's "
                         f"{len(want)} persistable vars")
    for name, var in want.items():
        arr = np.asarray(arrays[name])
        if var.shape is not None and tuple(arr.shape) != tuple(var.shape):
            raise ValueError(f"scope_from_arrays: {name!r} has shape "
                             f"{tuple(arr.shape)}, the program says "
                             f"{tuple(var.shape)}")
        scope.set_var(name, to_tensor(arr, dev, var.dtype))
    return scope
