"""Core IR: Program / Block / Operator / Variable.

Counterpart of ``paddle_tpu/framework/core.py``: the same build-time IR,
the same names and the same ``to_dict`` layout, so a program built here
serialises to the JSON the JAX package writes.  The difference is how it
runs: the port's Executor lowers a block into torch ops on one device
and, on the card, replays it as a CUDA graph (see framework/executor.py).

Shape/dtype inference runs at op-append time, as in the JAX package, so
graph construction errors surface where the op is appended.
"""
from __future__ import annotations

import copy
import itertools
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# dtype handling
# ---------------------------------------------------------------------------

# Canonical dtype strings (the JAX package's table).
_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "int32": "int32", "int64": "int64",
    "bool": "bool",
    "complex64": "complex64", "complex128": "complex128",
}

# canonical string -> torch dtype
_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_TORCH_TO_CANONICAL = {v: k for k, v in _TORCH_DTYPES.items()}


def convert_dtype(dtype) -> str:
    """Normalize any dtype spec (str / numpy / torch) to a canonical
    string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    if isinstance(dtype, torch.dtype):
        if dtype in _TORCH_TO_CANONICAL:
            return _TORCH_TO_CANONICAL[dtype]
        raise ValueError(f"unsupported dtype: {dtype!r}")
    name = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    raise ValueError(f"unsupported dtype: {dtype!r}")


def dtype_to_torch(dtype) -> torch.dtype:
    return _TORCH_DTYPES[convert_dtype(dtype)]


def dtype_to_np(dtype) -> np.dtype:
    """numpy dtype for a canonical dtype; numpy has no bfloat16."""
    d = convert_dtype(dtype)
    if d == "bfloat16":
        raise TypeError("numpy has no bfloat16; keep bfloat16 values as "
                        "torch tensors")
    return np.dtype(d)


# ---------------------------------------------------------------------------
# Variable type enum and operator roles (as in the JAX package)
# ---------------------------------------------------------------------------
class VarType:
    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    TENSOR_ARRAY = "tensor_array"
    STEP_SCOPES = "step_scopes"
    READER = "reader"
    RAW = "raw"


class OpRole:
    Forward = 0
    Backward = 1
    Optimize = 2
    RPC = 3
    Dist = 4
    LRSched = 16
    Loss = 256


_op_role_stack: List[int] = []


class op_role_guard:
    """Ops appended inside the guard default to the given role (the LR
    schedule and the clip ops are kept out of the backward sweep this
    way)."""

    def __init__(self, role: int):
        self.role = role

    def __enter__(self):
        _op_role_stack.append(self.role)
        return self

    def __exit__(self, *exc):
        _op_role_stack.pop()
        return False


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------
class Variable:
    """Build-time variable descriptor + graph handle.

    A shape entry of -1 denotes a data-dependent dimension (typically
    batch); the eager executor takes the real size from the tensors.
    """

    def __init__(self, block: "Block", name: str, shape=None, dtype="float32",
                 type: str = VarType.DENSE_TENSOR, persistable: bool = False,
                 stop_gradient: bool = False, is_data: bool = False,
                 initializer=None, trainable: bool = True,
                 need_check_feed: bool = False, **kwargs):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable
        self.need_check_feed = need_check_feed
        self.initializer = initializer
        self.regularizer = kwargs.get("regularizer")
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})

    def __bool__(self):
        raise TypeError(
            f"cannot convert graph Variable {self.name!r} to bool: Python "
            "`if`/`while` on tensor values is data-dependent control flow")

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": self.type,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "trainable": self.trainable,
        }

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")


class Parameter(Variable):
    """Persistable trainable variable."""

    def __init__(self, block, name, shape, dtype="float32", **kwargs):
        kwargs.setdefault("persistable", True)
        super().__init__(block, name, shape=shape, dtype=dtype, **kwargs)
        self.is_parameter = True


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------
class Operator:
    """One IR op: type + slotted input/output var names + attrs."""

    __slots__ = ("block", "type", "inputs", "outputs", "attrs", "idx")

    def __init__(self, block: "Block", type: str,
                 inputs: Optional[Dict[str, Any]] = None,
                 outputs: Optional[Dict[str, Any]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _as_name_list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.attrs.setdefault(
            "op_role",
            _op_role_stack[-1] if _op_role_stack else OpRole.Forward)
        self.idx = -1

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def single_input(self, slot: str) -> Optional[str]:
        names = self.inputs.get(slot, [])
        return names[0] if names else None

    def single_output(self, slot: str) -> Optional[str]:
        names = self.outputs.get(slot, [])
        return names[0] if names else None

    def input_arg_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_arg_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def to_dict(self) -> dict:
        return {
            "type": self.type,
            "inputs": {k: list(v) for k, v in self.inputs.items()},
            "outputs": {k: list(v) for k, v in self.outputs.items()},
            "attrs": _jsonable_attrs(self.attrs),
        }

    def __repr__(self):
        return f"Op({self.type}, in={self.inputs}, out={self.outputs})"


def _as_name_list(v) -> List[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [getattr(x, "name", None) or str(x) for x in v]
    name = getattr(v, "name", None)
    return [name if name is not None else str(v)]


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
class Block:
    """Ordered op list + var map; nestable for control flow."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name: Optional[str] = None, **kwargs) -> Variable:
        if name is None:
            name = unique_name("tmp")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype="float32", **kwargs) -> Parameter:
        # Parameters live in block 0 (the global block).
        gb = self.program.global_block()
        if name in gb.vars:
            return gb.vars[name]  # type: ignore[return-value]
        p = Parameter(gb, name, shape, dtype, **kwargs)
        gb.vars[name] = p
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name: str) -> bool:
        return name in self.vars

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (self.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values()
                if getattr(v, "is_parameter", False)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  infer_shape: bool = True) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        op.idx = len(self.ops)
        self.ops.append(op)
        self.program.bump()
        if infer_shape:
            from ..ops.registry import infer_op_shape
            infer_op_shape(op, self)
        return op

    def to_dict(self) -> dict:
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        lines = [f"Block[{self.idx}] ({len(self.vars)} vars, {len(self.ops)} ops)"]
        lines.extend("  " + repr(op) for op in self.ops)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
class Program:
    """A whole computation: list of blocks, block 0 global."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed = 0
        self._version = 1
        # cache token: executors key compiled steps on (_uid, _mod_count);
        # every mutation helper (append_op, append_backward, optimizers)
        # bumps _mod_count.  _uid is monotonic, never reused (unlike id(),
        # which can alias after GC).
        self._mod_count = 0
        self._uid = next(Program._uid_counter)
        self._is_startup = False

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def bump(self):
        self._mod_count += 1

    def clone(self, for_test: bool = False) -> "Program":
        p = copy.deepcopy(self)
        p._uid = next(Program._uid_counter)  # distinct cache identity
        if for_test:
            for blk in p.blocks:
                for op in blk.ops:
                    if op.type in ("dropout", "batch_norm", "sync_batch_norm"):
                        op.attrs["is_test"] = True
                blk.ops = [op for op in blk.ops
                           if op.attr("op_role") not in
                           (OpRole.Backward, OpRole.Optimize)]
        return p

    def list_vars(self) -> Iterator[Variable]:
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def to_dict(self) -> dict:
        return {"version": self._version,
                "blocks": [b.to_dict() for b in self.blocks]}

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)


# ---------------------------------------------------------------------------
# global default programs + guards
# ---------------------------------------------------------------------------
_main_program = Program()
_startup_program = Program()
_startup_program._is_startup = True


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, p
    return prev


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, p
    return prev


class program_guard:
    """`with program_guard(main, startup):` context."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self._main = main_program
        self._startup = startup_program

    def __enter__(self):
        self._prev_main = switch_main_program(self._main)
        if self._startup is not None:
            self._prev_startup = switch_startup_program(self._startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self._prev_main)
        if self._startup is not None:
            switch_startup_program(self._prev_startup)
        return False


# ---------------------------------------------------------------------------
# unique name generator
# ---------------------------------------------------------------------------
class _UniqueNameGenerator:
    def __init__(self):
        self._lock = threading.Lock()
        self._ids: Dict[str, int] = {}

    def __call__(self, prefix: str) -> str:
        with self._lock:
            i = self._ids.get(prefix, 0)
            self._ids[prefix] = i + 1
        return f"{prefix}_{i}"

    def reset(self):
        with self._lock:
            self._ids.clear()


_name_gen = _UniqueNameGenerator()


def unique_name(prefix: str = "tmp") -> str:
    return _name_gen(prefix)


def reset_unique_name():
    _name_gen.reset()


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX
