"""Inference-model save & load.

Counterpart of ``paddle_tpu/io.py`` for the serving path, in the same
on-disk format: ``__model__`` is the program JSON (framework/serde.py)
plus an ``inference_meta`` entry, and ``__params__`` is a pickled
name -> numpy array dict.  A model directory saved by either package
loads in the other.  The port pickles with protocol 5 where the
reference uses 2, for the reason checkpoint.py gives; ``pickle.load``
reads either.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import List, Sequence

from .framework.core import Program, Variable, default_main_program
from .framework.executor import Scope, _op_io, global_scope, to_numpy
from .framework.serde import program_from_json, program_to_dict

__all__ = ["save_persistables", "save_inference_model",
           "get_program_persistable_vars"]

# protocol 2 writes an array's buffer as a latin-1 string through a
# per-character codec, both ways: a BERT-base replica spent 4.5 s of its
# start unpickling its 0.5 GB of weights (probe_replica_start.py)
_PICKLE_PROTOCOL = 5


def get_program_persistable_vars(program: Program) -> List[Variable]:
    return [v for v in program.list_vars() if v.persistable]


def _collect(scope: Scope, vars: Sequence[Variable]) -> dict:
    out = {}
    for v in vars:
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(f"variable {v.name!r} has no value in scope")
        out[v.name] = to_numpy(val)
    return out


def _write(path: str, payload: dict):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=_PICKLE_PROTOCOL)


def _read(path: str) -> dict:
    # only model directories this framework (either package) wrote:
    # unpickling runs code, so never point this at untrusted files
    with open(path, "rb") as f:
        return pickle.load(f)


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Persistable vars of the program, from the global scope, into one
    pickle file (`filename`, default ``__params__``)."""
    program = main_program or default_main_program()
    vars = get_program_persistable_vars(program)
    _write(os.path.join(dirname, filename or "__params__"),
           _collect(global_scope(), vars))


def _prune_by_fetch(program: Program, feed_names, fetch_names):
    """Keep only the ops on a path from the feeds to the fetches: a saved
    inference program must not demand labels/loss inputs at serve time."""
    block = program.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if op.type in ("feed", "fetch"):
            continue
        if set(op.output_arg_names()) & needed:
            keep.append(op)
            reads, _writes = _op_io(op, block)
            needed.update(n for n in reads if n)
    keep.reverse()
    block.ops[:] = keep
    for i, op in enumerate(block.ops):
        op.idx = i
    # drop vars no kept op references (feeds stay regardless)
    referenced = set(feed_names) | needed
    for op in keep:
        referenced.update(op.output_arg_names())
    for name in [n for n in block.vars if n not in referenced]:
        del block.vars[name]


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, program_only=False):
    """Prunes to the feed->fetch subgraph (test clone), serializes program
    + params (params from the global scope, as in the JAX package)."""
    program = main_program or default_main_program()
    inference_program = program.clone(for_test=True)
    target_names = [t.name if isinstance(t, Variable) else str(t)
                    for t in target_vars]
    _prune_by_fetch(inference_program, feeded_var_names, target_names)
    payload = program_to_dict(inference_program)
    payload["inference_meta"] = {"feeds": list(feeded_var_names),
                                 "fetches": target_names}
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or "__model__"), "w") as f:
        json.dump(payload, f)
    if not program_only:
        save_persistables(executor, dirname, program,
                          filename=params_filename or "__params__")
    return target_names


def _load_model_payload(dirname, model_filename=None):
    """The serialized inference program: returns (program, meta)."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        payload = json.load(f)
    meta = payload.pop("inference_meta", {"feeds": [], "fetches": []})
    return program_from_json(json.dumps(payload)), meta

