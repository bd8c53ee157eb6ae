"""Serving layer of the port: KV-cached generation over a slot grid.

Counterpart of ``paddle_tpu/serving``.  Ported so far: ``batcher`` (shape
and prompt buckets, padding, bit-exact split), the request errors and
futures of ``engine``, and ``GenerationEngine`` with the dense KV cache
(serving/generation.py)::

    from paddle_tpu_torch.serving import GenerationEngine

    gen = GenerationEngine({"vocab_size": 32000, "hidden": 4096,
                            "num_layers": 32, "num_heads": 32,
                            "intermediate": 11008},
                           num_slots=4, max_seq_len=1024)
    gen.warmup()
    out = gen.generate([1, 15043, 29892], max_new_tokens=64)

The dynamic-batching ``ServingEngine``, the HTTP front end, the router
and fleet, and the paged / disaggregated / speculative generation paths
are not ported yet (ROADMAP.md queue 1 items 2 and 6).
"""
from . import batcher  # noqa
from .engine import (OverloadedError, PoisonedInput, RequestFailed,  # noqa
                     ServingError, ServingFuture)
from .generation import GenerationEngine  # noqa

__all__ = ["GenerationEngine", "OverloadedError", "PoisonedInput",
           "RequestFailed", "ServingError", "ServingFuture", "batcher"]
