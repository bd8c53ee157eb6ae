"""IR pass framework: ``Graph`` / ``Pass`` / ``PassRegistry``.

Counterpart of ``paddle_tpu/framework/ir.py``: passes are program-level
transforms with the JAX package's shape (named, registered, composable,
inspectable); ``Graph`` is a def-use view of one block with a minimal
chain matcher.  Built in: ``graph_viz`` (the DOT dump of
``monitor.save_program_dot``), ``prune_by_fetch`` and ``test_mode``.
``quantization_transform`` waits for the quant ops (ROADMAP.md queue 1,
item 7) and ``ps_transpile`` for the parameter server (item 9); both
raise.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence

from .core import Program

__all__ = ["Graph", "Pass", "PassRegistry", "register_pass", "get_pass",
           "apply_passes"]


class Graph:
    """Def-use view of one block (reference framework/ir/graph.h:66)."""

    def __init__(self, program: Program, block_idx: int = 0):
        self.program = program
        self.block = program.block(block_idx)
        self._build()

    def _build(self):
        self.defs: Dict[str, object] = {}     # var -> producing op
        self.uses: Dict[str, List] = {}       # var -> consuming ops
        for op in self.block.ops:
            for n in op.output_arg_names():
                if n:
                    self.defs[n] = op
            for n in op.input_arg_names():
                if n:
                    self.uses.setdefault(n, []).append(op)

    def producer(self, var_name: str):
        return self.defs.get(var_name)

    def consumers(self, var_name: str) -> List:
        return list(self.uses.get(var_name, ()))

    def ops(self, op_type: Optional[str] = None) -> Iterator:
        for op in self.block.ops:
            if op_type is None or op.type == op_type:
                yield op

    def match_chain(self, *op_types: str) -> Iterator[List]:
        """Yield every op list [o1..ok] where o(i+1) consumes one of
        o(i)'s outputs — the minimal pattern detector
        (graph_pattern_detector.h analog) used by fusion-style passes.
        Explores ALL matching consumers (a greedy first-consumer walk
        would miss chains branching through a later consumer)."""

        def extend(chain, remaining):
            if not remaining:
                yield list(chain)
                return
            want = remaining[0]
            seen = set()
            for n in chain[-1].output_arg_names():
                for c in self.consumers(n):
                    if c.type == want and id(c) not in seen:
                        seen.add(id(c))
                        chain.append(c)
                        yield from extend(chain, remaining[1:])
                        chain.pop()

        for op in self.ops(op_types[0]):
            yield from extend([op], list(op_types[1:]))


class Pass:
    """A named program transform (reference framework/ir/pass.h:40).

    Subclasses implement ``apply_impl(program, **attrs) -> program`` and
    may mutate in place (returning the same Program).  ``set(attr, v)``
    mirrors the reference's pass attributes.
    """

    name = "pass"

    def __init__(self, **attrs):
        self._attrs = dict(attrs)

    def set(self, key: str, value):
        self._attrs[key] = value
        return self

    def get(self, key: str, default=None):
        return self._attrs.get(key, default)

    def apply(self, program: Program) -> Program:
        out = self.apply_impl(program, **self._attrs)
        result = out if out is not None else program
        result.bump()
        return result

    def apply_impl(self, program: Program, **attrs):
        raise NotImplementedError


class _FnPass(Pass):
    def __init__(self, name, fn, **attrs):
        super().__init__(**attrs)
        self.name = name
        self._fn = fn

    def apply_impl(self, program, **attrs):
        return self._fn(program, **attrs)


class PassRegistry:
    """reference pass registry (REGISTER_PASS + PassRegistry::Get)."""

    _passes: Dict[str, Callable[..., Pass]] = {}

    @classmethod
    def register(cls, name: str, ctor: Callable[..., Pass],
                 override: bool = False):
        if name in cls._passes and not override:
            raise ValueError(
                f"pass {name!r} is already registered (reference "
                "REGISTER_PASS rejects duplicates); pass override=True "
                "to replace it deliberately")
        cls._passes[name] = ctor

    @classmethod
    def get(cls, name: str, **attrs) -> Pass:
        if name not in cls._passes:
            raise KeyError(f"unknown pass {name!r}; registered: "
                           f"{sorted(cls._passes)}")
        return cls._passes[name](**attrs)

    @classmethod
    def registered(cls) -> List[str]:
        return sorted(cls._passes)


def register_pass(name: str):
    """Decorator: register a Pass subclass, or a function
    ``fn(program, **attrs)`` wrapped as one."""

    def deco(obj):
        if isinstance(obj, type) and issubclass(obj, Pass):
            obj.name = name
            PassRegistry.register(name, obj)
        else:
            PassRegistry.register(
                name, lambda **attrs: _FnPass(name, obj, **attrs))
        return obj

    return deco


def get_pass(name: str, **attrs) -> Pass:
    return PassRegistry.get(name, **attrs)


def apply_passes(program: Program, names: Sequence[str],
                 **shared_attrs) -> Program:
    """Run a pass pipeline in order (reference
    PassStrategy/ApplyPassesToProgram)."""
    for n in names:
        program = get_pass(n, **shared_attrs).apply(program)
    return program


# ---------------------------------------------------------------------------
# built-in passes over the existing transforms
# ---------------------------------------------------------------------------
@register_pass("graph_viz")
def _graph_viz_pass(program, graph_viz_path="program.dot", block_idx=0,
                    **_):
    """reference ir/graph_viz_pass.cc: dump the block's op/var dataflow
    as graphviz DOT to `graph_viz_path`; the program passes through
    unchanged."""
    from ..monitor import save_program_dot
    save_program_dot(program, graph_viz_path, block_idx=block_idx)
    return program


@register_pass("prune_by_fetch")
def _prune_pass(program, feeds=(), fetches=(), **_):
    from ..io import _prune_by_fetch
    if not fetches:
        raise ValueError(
            "prune_by_fetch: 'fetches' is required — pruning to an "
            "empty fetch set would delete every op in the program")
    _prune_by_fetch(program, list(feeds), list(fetches))
    return program


@register_pass("quantization_transform")
def _quant_pass(program, **_):
    raise NotImplementedError(
        "quantization_transform: the port has no quant ops or "
        "contrib/slim yet (ROADMAP.md queue 1, item 7)")


@register_pass("ps_transpile")
def _ps_pass(program, **_):
    raise NotImplementedError(
        "ps_transpile: the parameter server (distributed/ps) is "
        "multi-device work (ROADMAP.md queue 1, item 9)")


@register_pass("test_mode")
def _test_mode_pass(program, **_):
    return program.clone(for_test=True)
