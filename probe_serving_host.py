#!/usr/bin/env python3
"""Where a ServingEngine's closed-loop throughput goes: the card, or the
host's per-request work.

    python3 probe_serving_host.py [--models 16384x4,16384x12,2048x4]
                                  [--requests 320] [--clients 16]
                                  [--workers 2] [--profile FILE]
                                  [--flag-sets defaults,...] [--dispatch]
                                  [--contend] [--device cuda|cpu]

For each model (``HIDDENxDEPTH``: ``tests/test_torch_serving.py``'s
weight-heavy MLP, 256 features in, ``DEPTH`` gelu layers of ``HIDDEN``,
8 out, fp32, random weights from the startup program's seed) it times:

* ``serial``: batch-1 ``Predictor.run`` one after another (the bar's
  denominator), and ``batch8``: one batch-8 run (the card's time for a
  full batch, so ``8 / batch8`` is what batching could reach on one
  worker);
* the engine (``workers`` clones, max batch 8, max delay 2 ms) under
  ``clients`` closed-loop client threads, once for each flag set of
  ``FLAG_SETS``: the defaults (every request traced: ``FLAGS_trace_sample``
  1), head sampling off, then the usage ledger and the flight recorder
  off as well, then telemetry off altogether.  For each: requests/s, the
  ratio to serial, rows a batch, the workers' batch p50 (``predict_ms``:
  dispatch to fetched outputs) and the host's share of a request
  (wall a request minus the card's share at the measured batch size).

``--contend`` then measures the first model's serial and engine rates
again, at the defaults, under each kind of host contention of
``CONTENTION``: a Python thread of the same process that spins (it holds
the interpreter lock whenever it can), and one spinning process a CPU
core (a host shared with other work).

``--dispatch`` measures each model at the defaults with each worker
layout of ``DISPATCH``: two workers as the engine runs them, one worker,
and two workers whose ``Predictor.run`` calls are held under one lock
(so the card runs one batch at a time and the workers take turns).
Every engine row gives the shares of the measured window during which
one worker, and two at once, were inside ``Predictor.run``.

``--profile FILE`` runs the defaults once more under ``cProfile`` (every
thread: Python 3.12's profiler is process-wide) and writes the 40
functions of most own time to FILE.  Prints one JSON line a
(model, flag set) and a last JSON line with all of them.  Needs the card
unless ``--device cpu``.
"""
import argparse
import json
import os
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: (name, flags) in the order run; each starts from the defaults
FLAG_SETS = (
    ("defaults", {}),
    ("trace_sample_0", {"FLAGS_trace_sample": 0.0}),
    ("trace_usage_blackbox_off", {"FLAGS_trace_sample": 0.0,
                                  "FLAGS_usage": False,
                                  "FLAGS_blackbox": False}),
    ("telemetry_off", {"FLAGS_trace_sample": 0.0, "FLAGS_usage": False,
                       "FLAGS_blackbox": False, "FLAGS_telemetry": False}),
)

#: (name, workers, exclusive) ``--dispatch`` measures, in order
DISPATCH = (("2_workers", 2, False), ("1_worker", 1, False),
            ("2_workers_exclusive_run", 2, True))

#: host contention ``--contend`` measures under, in order
CONTENTION = ("none", "spinning_thread", "spinning_process_a_core")


def _spin(stop):
    while not stop.is_set():
        sum(range(1000))


class contention:
    """Context manager: the named kind of host contention while open."""

    def __init__(self, kind):
        self.kind = kind
        self.workers = []

    def __enter__(self):
        import multiprocessing

        if self.kind == "spinning_thread":
            self.stop = threading.Event()
            self.workers = [threading.Thread(target=_spin, args=(self.stop,),
                                             daemon=True)]
        elif self.kind == "spinning_process_a_core":
            ctx = multiprocessing.get_context("spawn")
            self.stop = ctx.Event()
            self.workers = [ctx.Process(target=_spin, args=(self.stop,),
                                        daemon=True)
                            for _ in range(os.cpu_count() or 1)]
        for w in self.workers:
            w.start()
        return self

    def __exit__(self, *exc):
        if self.workers:
            self.stop.set()
            for w in self.workers:
                w.join(30)
        return False


def weight_heavy_mlp(tpt, device, hidden, depth, feat=256):
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.inference import Predictor

    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = layers.data("x", [feat])
        h = x
        for _ in range(depth):
            h = layers.fc(h, hidden, act="gelu")
        out = layers.fc(h, 8)
    scope = tpt.Scope()
    tpt.Executor(device).run(startup, scope=scope)
    return Predictor(main, ["x"], [out], scope=scope, device=device)


def closed_loop(eng, feeds, clients):
    """`clients` threads, each submitting the next feed once its last
    answer came back: requests/s."""
    nxt, lock, errors = [0], threading.Lock(), []

    def client():
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(feeds):
                return
            try:
                eng.submit(feeds[i]).result(120)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)
                return

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"closed loop failed: {errors[:2]}")
    return len(feeds) / (time.perf_counter() - t0)


def sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def serial_ms(predictor, feeds, n):
    t0 = time.perf_counter()
    for i in range(n):
        predictor.run(feeds[i % len(feeds)])
    return (time.perf_counter() - t0) * 1e3 / n


def overlap(intervals, t0, t1):
    """Shares of [t0, t1] during which at least one worker, and two or
    more workers at once, were inside ``Predictor.run``."""
    edges = sorted([(a, 1) for a, _ in intervals]
                   + [(b, -1) for _, b in intervals])
    depth, last, any_s, two_s = 0, t0, 0.0, 0.0
    for t, d in edges:
        t = min(max(t, t0), t1)
        if depth >= 1:
            any_s += t - last
        if depth >= 2:
            two_s += t - last
        depth, last = depth + d, t
    return any_s / (t1 - t0), two_s / (t1 - t0)


def run_engine(predictor, feeds, args, workers=None, exclusive=False):
    """Closed-loop requests/s through a ServingEngine over `predictor`'s
    clones.  Each clone's ``run`` is timed (and, with `exclusive`, held
    under one lock, so no two workers' runs overlap on the card)."""
    from paddle_tpu_torch.serving import ServingEngine

    intervals, gate = [], threading.Lock()
    with ServingEngine(predictor.clone(), workers=workers or args.workers,
                       max_batch=8, max_delay_ms=2.0, queue_cap=4096,
                       deadline_ms=600000,
                       warmup_shapes={"x": (feeds[0]["x"].shape[1],)}
                       ) as eng:
        for p in eng._pool:
            def timed(feed, _run=p.run):
                if exclusive:
                    gate.acquire()
                a = time.perf_counter()
                try:
                    return _run(feed)
                finally:
                    intervals.append((a, time.perf_counter()))
                    if exclusive:
                        gate.release()
            p.run = timed
        closed_loop(eng, feeds[:args.clients * 2], args.clients)  # warm
        before = dict(eng.stats()["counters"])
        t0 = time.perf_counter()
        qps = closed_loop(eng, feeds, args.clients)
        t1 = time.perf_counter()
        after = eng.stats()["counters"]
        p50 = [h["predict_ms"].get("p50") for h in eng.worker_health()]
    batches = after["batches"] - before["batches"]
    runs = [(a, b) for a, b in intervals if b > t0 and a < t1]
    in_run, two_in_run = overlap(runs, t0, t1)
    return dict(requests_per_s=qps,
                rows_per_batch=(after["served"] - before["served"])
                / max(batches, 1),
                batches=batches, worker_predict_ms_p50=p50,
                run_ms_mean=float(np.mean([b - a for a, b in runs])) * 1e3,
                share_in_run=in_run, share_two_in_run=two_in_run)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="16384x4,16384x12,2048x4")
    ap.add_argument("--requests", type=int, default=320)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--serial", type=int, default=64)
    ap.add_argument("--profile", default="")
    ap.add_argument("--contend", action="store_true")
    ap.add_argument("--dispatch", action="store_true")
    ap.add_argument("--flag-sets", default=",".join(n for n, _ in FLAG_SETS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, HERE)
    import paddle_tpu_torch as tpt

    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_serving_host: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    defaults = {n: tpt.get_flags([n])[n]
                for _, fl in FLAG_SETS for n in fl}
    rows = []
    for spec in args.models.split(","):
        hidden, depth = (int(v) for v in spec.lower().split("x"))
        predictor = weight_heavy_mlp(tpt, device, hidden, depth)
        rng = np.random.RandomState(0)
        feeds = [{"x": rng.rand(1, 256).astype("float32")}
                 for _ in range(args.requests)]
        eight = {"x": rng.rand(8, 256).astype("float32")}
        predictor.warmup([{"x": (1, 256)}, {"x": (8, 256)}])
        for _ in range(3):
            predictor.run(feeds[0])
            predictor.run(eight)
        sync(device)
        serial = serial_ms(predictor, feeds, args.serial)
        t0 = time.perf_counter()
        for _ in range(8):
            predictor.run(eight)
        batch8_ms = (time.perf_counter() - t0) * 1e3 / 8
        weights = sum(t.numel() * 4 for t in
                      (predictor.scope.find_var(n)
                       for n in predictor.scope.local_var_names())
                      if isinstance(t, torch.Tensor))
        for name, flags in FLAG_SETS:
            if name not in args.flag_sets.split(","):
                continue
            tpt.set_flags(dict(defaults, **flags))
            r = run_engine(predictor, feeds, args)
            # the card's share of a request at the batch size reached:
            # a batch's run over its rows, shared by the workers at most
            card_ms = batch8_ms / max(r["rows_per_batch"], 1e-9)
            row = dict(model=spec, flags=name, weight_bytes=weights,
                       serial_ms=serial,
                       serial_requests_per_s=1e3 / serial,
                       batch8_ms=batch8_ms,
                       ratio_to_serial=r["requests_per_s"] * serial / 1e3,
                       request_ms=1e3 / r["requests_per_s"],
                       card_ms_a_request=card_ms, **r)
            rows.append(row)
            print(json.dumps(row), flush=True)
        tpt.set_flags(defaults)
        for name, workers, exclusive in DISPATCH if args.dispatch else ():
            r = run_engine(predictor, feeds, args, workers, exclusive)
            row = dict(model=spec, flags="defaults", dispatch=name,
                       serial_ms=serial, batch8_ms=batch8_ms,
                       ratio_to_serial=r["requests_per_s"] * serial / 1e3,
                       **r)
            rows.append(row)
            print(json.dumps(row), flush=True)
        first = spec == args.models.split(",")[0]
        for kind in CONTENTION if args.contend and first else ():
            with contention(kind):
                ms = serial_ms(predictor, feeds, args.serial)
                r = run_engine(predictor, feeds, args)
            row = dict(model=spec, flags="defaults", contention=kind,
                       serial_ms=ms, serial_requests_per_s=1e3 / ms,
                       ratio_to_serial=r["requests_per_s"] * ms / 1e3,
                       **r)
            rows.append(row)
            print(json.dumps(row), flush=True)
        if args.profile and first:
            import cProfile
            import io
            import pstats

            prof = cProfile.Profile()
            prof.enable()
            r = run_engine(predictor, feeds, args)
            prof.disable()
            out = io.StringIO()
            out.write(f"# {spec}, defaults, under cProfile: "
                      f"{r['requests_per_s']:.1f} requests/s, "
                      f"{r['rows_per_batch']:.2f} rows a batch\n")
            pstats.Stats(prof, stream=out).sort_stats(
                "tottime").print_stats(40)
            os.makedirs(os.path.dirname(os.path.abspath(args.profile)),
                        exist_ok=True)
            with open(args.profile, "w") as f:
                f.write(out.getvalue())
        predictor.close()
        del predictor
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"serving_host": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
