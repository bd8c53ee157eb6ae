#!/usr/bin/env python3
"""How long does a replica stop answering /healthz while it serves a
/profilez capture under traffic?

    python3 probe_profilez.py [--captures 2,2,2,6,6,6] [--clients 8]
                              [--liveness-ms 0] [--checkout DIR]

Builds the kernels, saves chip_smoke.py's chaos model (BERT-base at seq
128, fp32), spawns chip_smoke.py's chaos fleet (3 replicas behind the
router) with the supervisor's liveness watchdog off (or at
--liveness-ms), and, while closed-loop traffic runs through the router,
asks replica 0 for one /profilez capture of each length given (after a
failed one, it waits for the fleet to be ready again).  For each capture it logs the
round trip, the status, the trace's events and the longest gap between
two /healthz answers of the profiled replica (polled every 100 ms, as
chip_smoke.py's HealthGaps does): what the watchdog, at its 5 s default,
would have seen, and the supervisor's hung kills of replica 0 so far.
--checkout runs another tree's package and chip_smoke.py.  The last
line is one JSON object: the card's name and power limit and every
capture's numbers.
"""
import argparse
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--captures", default="2,2,2,6,6,6",
                    help="seconds of each /profilez capture, in order")
    ap.add_argument("--clients", type=int, default=8,
                    help="closed-loop clients through the router")
    ap.add_argument("--liveness-ms", type=float, default=0.0,
                    help="the supervisor's liveness deadline (0: off)")
    ap.add_argument("--checkout", default=HERE,
                    help="directory holding paddle_tpu_torch and "
                         "chip_smoke.py")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_profilez: no CUDA device", file=sys.stderr)
        return 2
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    import chip_smoke as smoke

    smoke.use_bytecode_cache()
    import paddle_tpu_torch as tpt
    if not os.path.abspath(tpt.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"paddle_tpu_torch imported from {tpt.__file__},"
                           f" not from {checkout}")
    from paddle_tpu_torch.ops.cuda import build
    from paddle_tpu_torch.tools import chaos
    from paddle_tpu_torch.tools import serving_loadgen as lg

    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    smoke.log(f"probe_profilez of {checkout} on {card}")
    t0 = time.perf_counter()
    build.build_all()
    smoke.log(f"built in {time.perf_counter() - t0:.1f} s")

    feeds = smoke.chaos_feeds(0)
    make_feed = lambda i: feeds[i % len(feeds)]  # noqa: E731
    rows = []
    with smoke.tempfile.TemporaryDirectory(prefix="probe_profilez_") as wd:
        model, _ = smoke.chaos_model(tpt, wd)
        with smoke.fleet_workdir("probe_profilez_fleet_", "probe") as fd:
            sup, urls, _, _ = smoke.spawn_fleet(
                "probe fleet", replicas=smoke.CHAOS_REPLICAS,
                replica_argv=chaos.shared_fleet_argv(model, "cuda"),
                workdir=fd, liveness_timeout_ms=args.liveness_ms)
            router = server = None
            try:
                router, server = smoke.routed(sup)
                stop = threading.Event()

                def traffic():
                    reps = []
                    while not stop.is_set():
                        reps.append(lg.run_closed_loop_http(
                            server.url, make_feed, 64, args.clients))
                    return reps

                join = smoke.in_background(traffic)
                time.sleep(1.0)
                for sec in (float(s) for s in args.captures.split(",")):
                    gaps = smoke.HealthGaps([urls[0]])
                    time.sleep(0.5)
                    t = time.monotonic()
                    try:
                        status, body = smoke.get(
                            f"{urls[0]}/profilez?sec={sec}", timeout=300)
                        doc = json.loads(body)
                        with open(os.path.join(doc["dir"],
                                               "trace.json")) as f:
                            events = len(json.load(f).get(
                                "traceEvents", []))
                        error = None
                    except OSError as e:
                        status, doc, events = None, {}, None
                        error = f"{type(e).__name__}: {e}"
                    rt = time.monotonic() - t
                    time.sleep(1.0)
                    gap = gaps.stop()
                    row = dict(sec=sec, status=status, round_trip_s=rt,
                               events=events, bytes=doc.get("bytes"),
                               longest_healthz_gap_s=gap,
                               replica_alive=sup._replicas[0].proc.poll()
                               is None,
                               hung_kills=sup._replicas[0].hung_kills,
                               error=error)
                    rows.append(row)
                    smoke.log("  capture: " + json.dumps(row))
                    if error is not None:
                        sup.wait_ready(timeout_s=120)
                stop.set()
                reps = join()
                smoke.log(f"  traffic: {sum(r['ok'] for r in reps)} ok, "
                          f"{sum(r['failed'] for r in reps)} failed")
            finally:
                if server is not None:
                    server.close()
                    router.close()
                sup.close(timeout_s=120)
    print(json.dumps(dict(checkout=checkout, card=card, clients=args.clients,
                          liveness_ms=args.liveness_ms, captures=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
