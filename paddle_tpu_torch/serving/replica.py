"""Replica server process: ``python -m paddle_tpu_torch.serving.replica``.

The port's counterpart of ``paddle_tpu/serving/replica.py``, with the same
arguments and startup contract and one more: ``--device`` (default
``cuda``).  As everywhere in the port the replica runs on the card
(``cuda:0``) unless asked for the CPU (``--device cpu``); with no GPU
and no ``--device cpu`` it exits non-zero before it binds, never falling
back.  ``--recsys`` (the embedding tier) is not ported yet and raises.

One fleet replica = one of these processes (spawned and supervised by
:mod:`paddle_tpu_torch.serving.fleet`): build a predictor, start the HTTP
front end FIRST (so the router can poll ``/healthz`` and see
``ready: false`` while warmup runs), prime every shape bucket, then
flip ready — the router never places traffic on a replica that would
pay a first-request compile.

Startup contract (what the supervisor relies on):

1. bind the port (``--port``, 0 = ephemeral; a port that cannot be
   bound is logged as ``fleet.BIND_ERROR`` with its errno, then exit 1) and
   write
   ``--endpoint-file`` atomically: ``{"url", "port", "pid",
   "replica_id", "restart_count"}`` — the supervisor learns the bound
   port from here and PINS it for respawns, so a replica's URL is
   stable across its lifetimes and the router registry never changes;
2. warm up (``Predictor.warmup`` over every bucket of the feed
   signature) with the engine constructed ``ready_requires_warmup``,
   so ``/healthz`` carries ``ready: false`` until buckets are primed;
3. install SIGTERM drain (stop admissions, flush in-flight, stop the
   listener) and block until the listener exits, then close the
   engines (their CUDA graphs and memory pools) before returning —
   exit code 0 is a PLANNED exit (rollout), anything else a crash the
   supervisor respawns with backoff.

The generation engine's weights come from ``--seed`` alone: the op-seed
counter is reset just before the engine is built, so every replica of
a fleet (whatever its role, whatever was built before) draws the same
weights, and they equal an in-process ``GenerationEngine`` built right
after ``ops.registry.reset_op_seed()`` with the same arguments.

Model source: ``--model-dir`` + repeated ``--shape name=d0,d1``, or
the synthetic MLP (``--feat/--hidden/--depth/--classes`` — the
reference's, so fleet tests need no files).
Environment: ``PADDLE_TPU_REPLICA_ID`` (also via ``--replica-id``)
tags logs and the endpoint file; ``FLAGS_metrics_dir`` etc. arrive as
normal flag env vars.
"""
from __future__ import annotations

import argparse
import errno
import json
import logging
import os
import sys
import tempfile
import time

logger = logging.getLogger("paddle_tpu_torch.serving.replica")


def _parse_shapes(specs):
    out = {}
    for spec in specs or []:
        name, _, dims = spec.partition("=")
        out[name] = tuple(int(d) for d in dims.split(",") if d)
    return out


def _write_endpoint(path: str, payload: dict):
    """Atomic publish (tmp + rename): the supervisor polling the file
    must never read a torn JSON."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".endpoint-")
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def build_synthetic_checkpoint(dirname: str, *, feat: int = 64,
                               hidden: int = 256, depth: int = 2,
                               classes: int = 8, seed: int = 0,
                               poison_nan: bool = False, device=None):
    """Write a hot-swap checkpoint (``__params__``) structurally
    identical to the synthetic-MLP replica's live weights — the
    rollout bench / chaos / tests mint "new model versions" with this
    (different ``seed`` = different weights, same structure; different
    ``hidden`` etc. = a deliberate :class:`SwapMismatch` 409).
    ``poison_nan=True`` fills every array with NaN: with
    ``FLAGS_serving_check_outputs=1`` on the replicas, that checkpoint
    fails every request it serves — the deterministic bad-rollout the
    canary burn-rate judge must catch and auto-revert.

    Resets the unique-name counter before building so parameter names
    match a FRESH replica process (``rep_fc0.w_0`` ...), which is how
    the spawned fleet names them.  ``device`` runs the startup program
    (None: the card; the card's and the CPU's random streams differ)."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    from .. import io
    from ..framework.core import reset_unique_name
    from ..framework.executor import to_numpy

    reset_unique_name()
    main, startup = pt.Program(), pt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = seed
    with pt.program_guard(main, startup):
        x = layers.data("x", [feat])
        h = x
        for i in range(depth):
            h = layers.fc(h, hidden, act="relu", name=f"rep_fc{i}")
        layers.fc(h, classes, name="rep_head")
    scope = pt.Scope()
    pt.Executor(device).run(startup, scope=scope)
    arrays = {}
    for n in scope.local_var_names():
        a = np.array(to_numpy(scope.find_var(n)))
        if poison_nan:
            a[...] = np.nan
        arrays[n] = a
    os.makedirs(dirname, exist_ok=True)
    io._write(os.path.join(dirname, "__params__"), arrays)
    return sorted(arrays)


def build_predictor(args):
    """(predictor, per_row_shapes) from the CLI args."""
    if getattr(args, "recsys", False):
        raise NotImplementedError(
            "--recsys: the embedding tier is not ported yet (ROADMAP.md "
            "queue 1 item 8)")
    if args.model_dir:
        from ..inference import Predictor
        shapes = _parse_shapes(args.shape)
        if not shapes:
            raise SystemExit("--model-dir needs at least one "
                             "--shape name=d0,d1")
        return Predictor(args.model_dir, device=args.device), shapes
    # synthetic MLP — the reference's builder, so the whole fleet path
    # is testable with no exported model on disk
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import layers
    from ..inference import Predictor

    main, startup = pt.Program(), pt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = args.seed
    with pt.program_guard(main, startup):
        x = layers.data("x", [args.feat])
        h = x
        for i in range(args.depth):
            h = layers.fc(h, args.hidden, act="relu", name=f"rep_fc{i}")
        out = layers.fc(h, args.classes, name="rep_head")
    scope = pt.Scope()
    pt.Executor(args.device).run(startup, scope=scope)
    return (Predictor(main, ["x"], [out], scope=scope, device=args.device),
            {"x": (args.feat,)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0])
    ap.add_argument("--model-dir", help="save_inference_model export")
    ap.add_argument("--shape", action="append", metavar="name=d0,d1",
                    help="per-row feed shape (with --model-dir)")
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the replica runs: 'cuda' (cuda:0, the "
                         "default) or 'cpu'.  With no GPU and no "
                         "--device cpu the replica exits non-zero "
                         "before it binds")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (published via --endpoint-file; "
                         "the supervisor pins it for respawns)")
    ap.add_argument("--endpoint-file",
                    default=os.environ.get("PADDLE_TPU_ENDPOINT_FILE"),
                    help="where to publish {url, port, pid, ...} once "
                         "the listener is bound")
    ap.add_argument("--replica-id", type=int,
                    default=int(os.environ.get("PADDLE_TPU_REPLICA_ID",
                                               "0") or 0))
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--max-delay-ms", type=float, default=None)
    ap.add_argument("--queue-cap", type=int, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--poison-value", default=None,
                    help="set FLAGS_serving_poison_value in this "
                         "replica (deterministic poison-input model "
                         "for bisection/chaos testing — see README "
                         "'Failure containment'); normally arrives as "
                         "the flag env var instead")
    ap.add_argument("--generate", action="store_true",
                    help="also attach a slot-based GenerationEngine so "
                         "this replica serves POST /generate (the "
                         "--gen-* flags size the decode model; without "
                         "this the route answers 404)")
    ap.add_argument("--gen-vocab", type=int, default=128)
    ap.add_argument("--gen-hidden", type=int, default=64)
    ap.add_argument("--gen-layers", type=int, default=2)
    ap.add_argument("--gen-heads", type=int, default=4)
    ap.add_argument("--gen-kv-heads", type=int, default=None)
    ap.add_argument("--gen-intermediate", type=int, default=128)
    ap.add_argument("--gen-slots", type=int, default=4)
    ap.add_argument("--gen-max-seq", type=int, default=64)
    ap.add_argument("--gen-max-new", type=int, default=32)
    ap.add_argument("--role", choices=("both", "prefill", "decode"),
                    default=None,
                    help="disaggregated serving role (see README "
                         "'Disaggregated serving'): 'prefill' exports "
                         "KV segments from /generate, 'decode' adopts "
                         "them via POST /adopt; default follows "
                         "FLAGS_serving_role.  Non-'both' roles force "
                         "the paged KV cache on")
    ap.add_argument("--gen-paged", action="store_true",
                    help="build the generator with the paged KV cache "
                         "(implied by --role prefill|decode)")
    ap.add_argument("--gen-page-tokens", type=int, default=None)
    ap.add_argument("--gen-pages", type=int, default=None)
    ap.add_argument("--gen-speculate", action="store_true",
                    help="enable speculative decoding on the generator "
                         "(n-gram self-drafts verified in one chunk "
                         "call — bit-exact vs plain decode; implies "
                         "the paged KV cache; see README 'Speculative "
                         "decoding').  Per-request opt-out rides the "
                         "/generate body's 'speculate' field")
    ap.add_argument("--gen-spec-tokens", type=int, default=None,
                    help="max draft tokens per verify (default "
                         "FLAGS_serving_spec_tokens)")
    ap.add_argument("--recsys", action="store_true",
                    help="the Wide&Deep recsys path through the "
                         "embedding tier: not ported yet (ROADMAP.md "
                         "queue 1 item 8); raises NotImplementedError")
    args = ap.parse_args(argv)

    from .. import blackbox
    from ..device import resolve_device
    from ..flags import set_flags
    from .engine import ServingEngine
    from .fleet import BIND_ERROR
    from .server import serve

    try:
        args.device = resolve_device(args.device)
    except RuntimeError as e:
        # never fall back to the CPU: a replica asked for the card
        # without one exits before it binds (the supervisor sees a
        # crash, the router never sees the port)
        raise SystemExit(f"replica: {e} (the replica's flag: "
                         f"--device cpu)")

    # arm crash forensics before anything heavy runs: faulthandler +
    # fatal-signal handlers + the thread excepthook, so even a crash
    # inside predictor build / warmup leaves a postmortem (main thread,
    # so the signal handlers are installable)
    blackbox.install()

    if args.role and args.role != "both" and not args.generate:
        raise SystemExit("--role prefill|decode requires --generate "
                         "(the role governs the generation engine)")
    if args.poison_value:
        set_flags({"FLAGS_serving_poison_value": args.poison_value})
    predictor, shapes = build_predictor(args)
    engine = ServingEngine(
        predictor, workers=args.workers, max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms, queue_cap=args.queue_cap,
        deadline_ms=args.deadline_ms, ready_requires_warmup=True)
    gen = None
    if args.generate:
        from ..flags import flag_value
        from ..ops.registry import reset_op_seed
        from .generation import GenerationEngine
        role = args.role or str(flag_value("FLAGS_serving_role")
                                or "both")
        # specialized roles (and speculation's verify-against-pages
        # contract) are page-block-based by definition: force the
        # paged cache on even without --gen-paged
        paged = True if (args.gen_paged or args.gen_speculate
                         or role != "both") else None
        # the weights from --seed alone: whatever was built before
        # (the MLP, another role's programs) must not shift them
        reset_op_seed()
        gen = GenerationEngine(
            dict(vocab_size=args.gen_vocab, hidden=args.gen_hidden,
                 num_layers=args.gen_layers, num_heads=args.gen_heads,
                 num_kv_heads=args.gen_kv_heads,
                 intermediate=args.gen_intermediate),
            num_slots=args.gen_slots, max_seq_len=args.gen_max_seq,
            max_new_tokens=args.gen_max_new,
            queue_cap=args.queue_cap,
            deadline_ms=args.deadline_ms, role=role, paged=paged,
            page_tokens=args.gen_page_tokens, num_pages=args.gen_pages,
            speculate=True if args.gen_speculate else None,
            spec_tokens=args.gen_spec_tokens, seed=args.seed,
            device=args.device)
        engine.attach_generator(gen)
    try:
        server = serve(engine, host=args.host, port=args.port)
    except OSError as e:
        # the port is taken (a pinned port another socket drew while this
        # replica was down): name it for the supervisor's crash record
        logger.error("%s: pid %d port %d errno %s (%s): %s", BIND_ERROR,
                     os.getpid(), args.port, e.errno,
                     errno.errorcode.get(e.errno, "UNKNOWN"), e.strerror)
        _close_engines(engine, predictor)
        return 1
    server.install_sigterm()

    restart_count = int(os.environ.get("PADDLE_TPU_RESTART_COUNT",
                                       "0") or 0)
    if args.endpoint_file:
        _write_endpoint(args.endpoint_file, {
            "url": server.url, "port": server.port, "pid": os.getpid(),
            "replica_id": args.replica_id,
            "restart_count": restart_count})
    logger.info("replica %d listening on %s (restart %d)",
                args.replica_id, server.url, restart_count)

    # warmup AFTER the listener is up: the router polls ready=false the
    # whole time, so no traffic lands on cold buckets
    warm_up(engine, shapes, gen, args.device)
    logger.info("replica %d ready (buckets primed)", args.replica_id)

    # block until SIGTERM drains the engine and stops the listener
    try:
        while server._thread is not None and server._thread.is_alive():
            server._thread.join(0.5)
    except KeyboardInterrupt:
        server.close()
    _close_engines(engine, predictor)
    return 0


def warm_up(engine, shapes, gen, device):
    """A replica's warm-up, in order: the generator (prefill buckets +
    the decode grid); on the card, the profiler (its first start, the
    slow one, before any traffic: ``observatory.warm_profiler``, a no-op
    with telemetry off); last the engine's one-shot warmup, which flips
    ``ready`` and must stay the LAST gate."""
    if gen is not None:
        gen.warmup()
    if device.type == "cuda":
        from .. import observatory
        observatory.warm_profiler()
    engine.warmup(shapes)


def _close_engines(engine, predictor):
    """A planned exit frees what the process holds on the card before
    the interpreter shuts down: wait for the SIGTERM drain thread (it
    closes the engine, its pool's clones and the generator), close
    anything it did not reach, then the base predictor's graphs, and
    hand the cached blocks back."""
    import threading

    import torch

    for t in threading.enumerate():
        if t.name == "serving-drain":
            t.join()
    engine.close(drain=True)
    if engine.generator is not None:
        engine.generator.close(drain=True)
    predictor.close()
    if predictor.device.type == "cuda":
        torch.cuda.synchronize(predictor.device)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    sys.exit(main())
