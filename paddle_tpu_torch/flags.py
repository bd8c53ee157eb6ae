"""Global flag registry: ``set_flags`` / ``get_flags``.

The port's copy of ``paddle_tpu/flags.py``'s registry (importing the JAX
package's module would import jax), holding only the flags the port
reads: ``FLAGS_check_nan_inf``, ``FLAGS_benchmark`` and
``FLAGS_guard_resolve_interval``, all read by the executor, with the
reference's help strings.  ``set_flags`` raises on any other name, so a
flag the port would ignore is an error, not a silent no-op; a later
slice registers a flag with the module that reads it.

Reference: platform/flags.cc:44 (gflags-backed registry) +
fluid/framework.py set_flags/get_flags.  Flags are initialized from
``FLAGS_*`` environment variables at import, like gflags does.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Union

__all__ = ["set_flags", "get_flags", "register_flag"]

_FLAGS: Dict[str, object] = {}
_DEFS: Dict[str, tuple] = {}  # name -> (type, default, help)


def register_flag(name: str, default, help_str: str = ""):
    typ = type(default)
    _DEFS[name] = (typ, default, help_str)
    env = os.environ.get(name)
    if env is not None:
        if typ is bool:
            _FLAGS[name] = env.lower() in ("1", "true", "yes", "on")
        else:
            _FLAGS[name] = typ(env)
    else:
        _FLAGS[name] = default


def _coerce(typ, value):
    if typ is bool and isinstance(value, str):
        # bool('0') is True; parse strings like the env path does
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def set_flags(flags: Dict[str, object]):
    """reference fluid.set_flags({'FLAGS_check_nan_inf': 1})."""
    for name, value in flags.items():
        if name not in _DEFS:
            raise ValueError(f"unknown flag {name!r}; known: "
                             f"{sorted(_DEFS)}")
        _FLAGS[name] = _coerce(_DEFS[name][0], value)


def get_flags(flags: Union[str, Iterable[str]]):
    """reference fluid.get_flags: str -> value, list -> dict."""
    if isinstance(flags, str):
        if flags not in _FLAGS:
            raise ValueError(f"unknown flag {flags!r}")
        return {flags: _FLAGS[flags]}
    return {f: get_flags(f)[f] for f in flags}


def flag_value(name: str):
    """Internal fast-path accessor."""
    return _FLAGS.get(name, _DEFS.get(name, (None, None))[1])


# -- the flag set (reference platform/flags.cc + nan_inf_utils) -------------
register_flag("FLAGS_check_nan_inf", False,
              "run ops eagerly and raise, naming the op, on the first "
              "non-finite output (framework/details/nan_inf_utils)")
register_flag("FLAGS_benchmark", False,
              "sync and print per-run wall time in Executor.run")
register_flag("FLAGS_guard_resolve_interval", 64,
              "deferred non-finite guard: resolve the pending on-device "
              "ok-verdict ring at most every N guarded steps when nothing "
              "else (a fetch read, a checkpoint, close) forces it; "
              "1 restores the synchronous per-step host check, 0 defers "
              "indefinitely (fetch/checkpoint/close only)")
