"""Global flag registry: ``set_flags`` / ``get_flags``.

The port's copy of ``paddle_tpu/flags.py``'s registry (importing the JAX
package's module would import jax), holding only the flags the port
reads, with the reference's defaults and help strings: the executor's
``FLAGS_check_nan_inf``, ``FLAGS_benchmark`` and
``FLAGS_guard_resolve_interval``; fault.py's ``FLAGS_fault_inject`` and
``FLAGS_fault_seed``; and the generation engine's ``FLAGS_serving_*``
(serving/generation.py registers its paged-cache and draft-size flags
itself, serving/disagg.py ``FLAGS_disagg_transport``).  ``set_flags`` raises on any other name, so a
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
register_flag("FLAGS_fault_inject", "",
              "deterministic fault-injection spec: comma-separated "
              "site:kind@N / site:kind@N+ / site:kind~p entries "
              "(fault.py; e.g. 'prefill:fail@2,decode_step:fail@5')")
register_flag("FLAGS_fault_seed", 0,
              "seed for probabilistic (~p) fault-injection triggers")
register_flag("FLAGS_serving_queue_cap", 256,
              "serving engine: bounded admission queue; submit() on a "
              "full queue sheds with an explicit OverloadedError instead "
              "of queuing unbounded latency")
register_flag("FLAGS_serving_deadline_ms", 1000.0,
              "serving engine: requests that waited longer than this in "
              "the queue are shed (OverloadedError) when a worker picks "
              "them up — bounds admission-latency p99 under overload")
register_flag("FLAGS_serving_decode_slots", 8,
              "generation engine: decode-slot grid size — the whole "
              "grid runs every decode iteration, finished sequences "
              "free their slot to the next queued request immediately "
              "(serving/generation.py)")
register_flag("FLAGS_serving_max_seq_len", 256,
              "generation engine: per-slot KV-cache sequence capacity "
              "(prompt + generated tokens); the cache footprint is "
              "slots * layers * 2 * n_kv_heads * max_seq_len * head_dim "
              "* 4 bytes")
register_flag("FLAGS_serving_prefill_buckets", "",
              "comma-separated prefill sequence-length buckets "
              "(prompts pad up to the smallest fitting bucket, one "
              "compiled step per bucket); empty = powers of two "
              "from 8 up to FLAGS_serving_max_seq_len")
register_flag("FLAGS_serving_max_new_tokens", 64,
              "generation engine: default per-request cap on generated "
              "tokens (a request's own max_new_tokens wins; a budget "
              "beyond the cache capacity left after the prompt decodes "
              "until the slot cache fills and finishes 'cache_full')")
register_flag("FLAGS_serving_paged", False,
              "generation engine: block-paged KV cache (a shared page "
              "pool + per-slot block tables) instead of the dense "
              "per-slot [slots, n_kv, max_seq_len, D] reservation; 0 "
              "keeps the dense cache")
register_flag("FLAGS_serving_prefill_chunk", 0,
              "paged generation: feed long prompts in slices of this "
              "many tokens, one slice per scheduler iteration "
              "interleaved with decode steps; 0 = whole-prompt prefill")
register_flag("FLAGS_serving_speculate", False,
              "paged generation: speculative decoding — a prompt-lookup "
              "n-gram drafter proposes up to FLAGS_serving_spec_tokens "
              "tokens per slot per scheduler iteration from the "
              "sequence's OWN prompt+generated history (no second "
              "model), a single chunk-shaped verify program scores the "
              "draft against the paged cache, and the longest "
              "argmax-agreeing prefix (plus the one bonus token) is "
              "accepted — bit-exact vs plain greedy decode, token-for-"
              "token and logit-for-logit.  Rejected draft tokens roll "
              "their provisionally-written KV pages back through the "
              "refcounted pool.  Requires FLAGS_serving_paged=1")
register_flag("FLAGS_serving_role", "both",
              "disaggregated serving role of this GenerationEngine / "
              "replica: 'both' (colocated prefill+decode, the default), "
              "'prefill' (runs paged prefill and exports each prompt's "
              "populated pages as a KVSegment, never occupies a decode "
              "slot), 'decode' (accepts segments via adopt()/POST "
              "/adopt and runs only the decode grid).  Non-'both' "
              "roles require FLAGS_serving_paged=1")
register_flag("FLAGS_serving_poison_value", "",
              "chaos/testing hook: a float sentinel; a generation prompt "
              "containing a token exactly equal to it raises "
              "PoisonedInput at prefill — a deterministic stand-in for an "
              "input that crashes the model; empty disables (the serve "
              "path pays nothing)")
