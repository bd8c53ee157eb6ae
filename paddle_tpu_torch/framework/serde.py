"""Program (de)serialization — the JSON format of
``paddle_tpu/framework/serde.py`` (FORMAT_VERSION 1), so each package
loads what the other writes, training programs (grad ops, recompute's
re-emitted forwards) included."""
from __future__ import annotations

import json

import numpy as np

from .core import Block, Parameter, Program

FORMAT_VERSION = 1

# program-level flags the JAX package's executors honour; the port keeps
# them as data so a program round-trips unchanged
_PROGRAM_FLAGS = ("_amp_lowering", "_pipeline", "_zero_sharding")


def program_to_dict(program: Program) -> dict:
    d = program.to_dict()
    d["format_version"] = FORMAT_VERSION
    d["random_seed"] = program.random_seed
    for key in _PROGRAM_FLAGS:
        val = getattr(program, key, None)
        if val is not None:
            if key == "_amp_lowering":
                val = {"dtype": val["dtype"],
                       "white": sorted(val["white"]),
                       "black": sorted(val["black"])}
            d[key] = val
    for blk, bd in zip(program.blocks, d["blocks"]):
        for v, vd in zip(blk.vars.values(), bd["vars"]):
            vd["is_parameter"] = isinstance(v, Parameter)
    return d


def program_to_json(program: Program, indent=None) -> str:
    return json.dumps(program_to_dict(program), indent=indent)


def _restore_attr(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        return np.asarray(v["__ndarray__"], dtype=v["dtype"])
    return v


def program_from_dict(d: dict) -> Program:
    from ..ops.registry import ensure_grad_op_registered, has_op

    if d.get("format_version", 1) > FORMAT_VERSION:
        raise ValueError(
            f"program format {d['format_version']} is newer than this "
            f"runtime ({FORMAT_VERSION})")
    p = Program()
    p.random_seed = d.get("random_seed", 0)
    while len(p.blocks) < len(d["blocks"]):
        p.blocks.append(Block(p, len(p.blocks)))
    for bd in d["blocks"]:
        blk = p.blocks[bd["idx"]]
        blk.parent_idx = bd.get("parent_idx", -1)
        for vd in bd["vars"]:
            if vd.get("is_parameter"):
                blk.create_parameter(vd["name"], vd.get("shape"),
                                     vd.get("dtype", "float32"),
                                     trainable=vd.get("trainable", True))
            else:
                blk.create_var(
                    name=vd["name"], shape=vd.get("shape"),
                    dtype=vd.get("dtype"),
                    type=vd.get("type", "dense_tensor"),
                    persistable=vd.get("persistable", False),
                    stop_gradient=vd.get("stop_gradient", False),
                    is_data=vd.get("is_data", False),
                    trainable=vd.get("trainable", True))
        for od in bd["ops"]:
            base = od["type"][:-len("_grad")]
            if od["type"].endswith("_grad") and has_op(base) and \
                    not has_op(od["type"]):
                # an auto-derived grad op: registered where backward
                # first emits one, so a loaded program registers it
                ensure_grad_op_registered(base)
            attrs = {k: _restore_attr(v) for k, v in od["attrs"].items()}
            blk.append_op(od["type"], inputs=od["inputs"],
                          outputs=od["outputs"], attrs=attrs,
                          infer_shape=False)
    if "_amp_lowering" in d:
        amp = d["_amp_lowering"]
        p._amp_lowering = {"dtype": amp["dtype"],
                           "white": set(amp["white"]),
                           "black": set(amp["black"])}
    if "_pipeline" in d:
        p._pipeline = d["_pipeline"]
    if "_zero_sharding" in d:
        p._zero_sharding = d["_zero_sharding"]
    p._current_block_idx = 0
    return p


def program_from_json(s: str) -> Program:
    return program_from_dict(json.loads(s))
