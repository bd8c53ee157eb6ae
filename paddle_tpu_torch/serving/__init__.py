"""Serving layer of the port: the dynamic-batching ``ServingEngine``, its
HTTP front end, and KV-cached generation over a slot grid.

Counterpart of ``paddle_tpu/serving``.  Ported so far: ``batcher`` (shape
and prompt buckets, padding, bit-exact split), ``ServingEngine``
(serving/engine.py: a pool of predictor clones, micro-batching,
admission, deadlines, drain, request traces, poison bisection, in-place
weight hot-swap, the stuck-worker watchdog), ``ServingServer`` /
``serve`` (serving/server.py: ``/predict``, ``/generate`` plain and
streamed, ``/adopt``, ``/swap``, ``/healthz``, ``/metrics``,
``/statusz``, ``/tracez``, ``/debugz``, ``/usagez``, ``/profilez``), the
usage ledger (serving/usage.py), ``GenerationEngine`` with the dense or the
block-paged KV cache, prefix reuse, chunked prefill, speculative decoding
and the prefill / decode roles (serving/generation.py), and the KV-segment
handoff between those roles (serving/disagg.py)::

    from paddle_tpu_torch.serving import GenerationEngine

    gen = GenerationEngine({"vocab_size": 32000, "hidden": 4096,
                            "num_layers": 32, "num_heads": 32,
                            "intermediate": 11008},
                           num_slots=4, max_seq_len=1024)
    gen.warmup()
    out = gen.generate([1, 15043, 29892], max_new_tokens=64)

``paged=True`` (``page_tokens``, ``num_pages``, ``prefix_reuse``,
``prefill_chunk``) serves from a page pool; ``speculate=True`` drafts and
verifies; ``DisaggPair(GenerationEngine(..., role="prefill"),
GenerationEngine(..., role="decode"))`` splits the roles.  Serving
BERT and Llama over HTTP::

    from paddle_tpu_torch.serving import ServingEngine, serve

    eng = ServingEngine(model_dir, workers=2, max_batch=8,
                        warmup_shapes={"input_ids": (128,), ...})
    eng.attach_generator(gen)
    srv = serve(eng, port=8000)   # POST /predict, /generate, ...

The fleet tier above them: ``python -m paddle_tpu_torch.serving.replica``
(one server process: a ``--model-dir`` model or the synthetic MLP, and
with ``--generate`` a Llama generator in role ``--role``; on the card
unless ``--device cpu``), ``FleetSupervisor`` (serving/fleet.py: spawns
and respawns the replicas, rolling restart, fleet hot swap, postmortem
attribution) and ``Router`` / ``RouterServer`` / ``serve_router``
(serving/router.py: least-loaded routing by live ``/healthz``, retry,
deadlines, canary rollouts, the prefill -> ``/adopt`` -> decode
pipeline, metrics federation on ``/fleetz`` and burn-rate alerts)::

    from paddle_tpu_torch.serving import FleetSupervisor, Router, RouterServer

    sup = FleetSupervisor(replicas=2, replica_argv=[
        "--model-dir", model_dir, "--shape", "x=64"])
    router = Router(sup.wait_ready())
    srv = RouterServer(router).start()   # POST srv.url + "/predict"

Not ported yet: the embedding tier (ROADMAP.md queue 1 item 8) and
mesh-sharded serving (item 9).
"""
from . import batcher  # noqa
from .disagg import (DeviceTransport, DisaggPair,  # noqa
                     HostBytesTransport, KVSegment, SegmentMismatch,
                     SegmentTransport)
from . import usage  # noqa
from .engine import (OverloadedError, PoisonedInput, RequestFailed,  # noqa
                     ServingEngine, ServingError, ServingFuture)
from .generation import GenerationEngine  # noqa
from .server import ServingServer, serve  # noqa
from .router import Router, RouterServer, serve_router  # noqa
from .fleet import FleetSupervisor  # noqa

__all__ = ["GenerationEngine", "OverloadedError", "PoisonedInput",
           "RequestFailed", "ServingError", "ServingFuture", "batcher",
           "ServingEngine", "ServingServer", "serve", "usage",
           "KVSegment", "SegmentMismatch", "SegmentTransport",
           "DeviceTransport", "HostBytesTransport", "DisaggPair",
           "FleetSupervisor", "Router", "RouterServer", "serve_router"]
