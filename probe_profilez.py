#!/usr/bin/env python3
"""How long does a replica stop answering /healthz while it serves a
/profilez capture under traffic?

    python3 probe_profilez.py [--captures 2,2,2,6,6,6] [--clients 8]
                              [--liveness-ms 0] [--checkout DIR]
                              [--fleets 1] [--each] [--dump-after 0]
                              [--chaos-probe 0]

Builds the kernels, saves chip_smoke.py's chaos model (BERT-base at seq
128, fp32), spawns chip_smoke.py's chaos fleet (3 replicas behind the
router) with the supervisor's liveness watchdog off (or at
--liveness-ms), and, while closed-loop traffic runs through the router,
asks replica 0 for one /profilez capture of each length given (after a
failed one, it waits for the fleet to be ready again).  For each
capture it logs the round trip, the status, the trace's events and the
longest gap between two /healthz answers of the profiled replica
(polled every 100 ms, as chip_smoke.py's HealthGaps does, an answer
later than the watchdog's 1 s poll counting as none): what the
watchdog, at its 5 s default, would have seen, and the supervisor's
hung kills of replica 0 so far, and from the replica's log the
capture's profiler start and the life's profiler warm-up before it
reported ready (none where the checkout's replicas do not warm: a
parent's); after each capture, the profiler lines of the replica's log
go to chiprun_out/probe_profilez_dumps.txt.
--checkout runs another tree's package and chip_smoke.py.  --fleets
spawns that many fleets one after another; --each captures every
replica in turn, not only replica 0 (a replica's first capture is the
slow one).  --chaos-probe N first runs chip_smoke.py's 13b probe of a
chaos fleet (a closed-loop probe, then a capture under traffic) N
times.  --dump-after S: a capture whose GET has not come back after S
seconds gets its replica's threads read from /proc (state, CPU ticks,
wchan) and their Python stacks dumped (faulthandler on SIGUSR1,
registered in every replica through a sitecustomize the probe puts on
their PYTHONPATH) into the same file, then the replica is SIGKILLed.
The last line is one JSON object: the card's name and power limit and
every capture's numbers.
"""
import argparse
import json
import os
import signal
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DUMPS = os.path.join(HERE, "chiprun_out", "probe_profilez_dumps.txt")
# what every replica imports at start when --dump-after is on: its
# Python stacks on SIGUSR1, into PROBE_FH_DIR/<pid>.txt
SITECUSTOMIZE = """import faulthandler, os, signal
_d = os.environ.get("PROBE_FH_DIR")
if _d:
    _f = open(os.path.join(_d, f"{os.getpid()}.txt"), "w")
    faulthandler.register(signal.SIGUSR1, file=_f, all_threads=True)
"""


def thread_states(pid):
    """Each thread of `pid`: (tid, name, state, utime + stime ticks,
    wchan) from /proc."""
    rows = []
    base = f"/proc/{pid}/task"
    for tid in sorted(os.listdir(base), key=int):
        try:
            with open(f"{base}/{tid}/stat") as f:
                stat = f.read()
            with open(f"{base}/{tid}/wchan") as f:
                wchan = f.read().strip()
        except OSError:
            continue
        name = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        rows.append((int(tid), name, fields[0],
                     int(fields[11]) + int(fields[12]), wchan))
    return rows


def dump_replica(rep, fh_dir, what):
    """Append `rep`'s thread states (twice, 2 s apart) and its Python
    stacks to DUMPS, then SIGKILL it."""
    pid = rep.proc.pid
    os.makedirs(os.path.dirname(DUMPS), exist_ok=True)
    with open(DUMPS, "a") as out:
        out.write(f"==== {what}: replica {rep.idx} pid {pid}\n")
        first = {t[0]: t for t in thread_states(pid)}
        time.sleep(2.0)
        for t in thread_states(pid):
            was = first.get(t[0])
            out.write(f"  tid {t[0]} {t[1]!r} state {t[2]} ticks {t[3]} "
                      f"(+{t[3] - was[3] if was else '?'} in 2 s) "
                      f"wchan {t[4]}\n")
        os.kill(pid, signal.SIGUSR1)
        time.sleep(2.0)
        try:
            with open(os.path.join(fh_dir, f"{pid}.txt")) as f:
                out.write(f.read())
        except OSError as e:
            out.write(f"  no stacks: {e}\n")
    rep.proc.kill()


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
    ap.add_argument("--fleets", type=int, default=1,
                    help="fresh fleets, one after another")
    ap.add_argument("--each", action="store_true",
                    help="capture every replica in turn")
    ap.add_argument("--chaos-probe", type=int, default=0,
                    help="runs of chip_smoke.chaos_probe first")
    ap.add_argument("--dump-after", type=float, default=0.0,
                    help="seconds after which a capture's replica is "
                         "dumped and killed (0: never)")
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
        fh_dir = None
        if args.dump_after > 0:
            fh_dir = os.path.join(wd, "stacks")
            site = os.path.join(wd, "site")
            os.makedirs(fh_dir)
            os.makedirs(site)
            with open(os.path.join(site, "sitecustomize.py"), "w") as f:
                f.write(SITECUSTOMIZE)
            os.environ["PROBE_FH_DIR"] = fh_dir
            os.environ["PYTHONPATH"] = os.pathsep.join(
                [site] + [p for p in os.environ.get(
                    "PYTHONPATH", "").split(os.pathsep) if p])
        model, model_dir = smoke.chaos_model(tpt, wd)
        if args.chaos_probe:
            rows += chaos_probes(smoke, model, model_dir, args, fh_dir)
        for fleet in range(args.fleets):
            rows += profile_fleet(smoke, chaos, lg, model, make_feed, args,
                                  fleet, fh_dir)
    print(json.dumps(dict(checkout=checkout, card=card, clients=args.clients,
                          liveness_ms=args.liveness_ms, fleets=args.fleets,
                          captures=rows)))
    return 0


def watch(rep, fh_dir, after, what):
    """Dump and kill `rep` (dump_replica) unless the returned function is
    called within `after` seconds (never where `after` is 0); that
    function says whether it was dumped."""
    done, dumped = threading.Event(), []

    def run():
        if not done.wait(after):
            dumped.append(True)
            dump_replica(rep, fh_dir, f"{what} past {after} s")

    t = None
    if after > 0:
        t = threading.Thread(target=run, daemon=True)
        t.start()

    def unwatch():
        done.set()
        if t is not None:
            t.join()
        return bool(dumped)
    return unwatch


def chaos_probes(smoke, model, model_dir, args, fh_dir):
    """chip_smoke.chaos_probe (13b's probe fleet: its closed-loop probe,
    then a /profilez capture of replica 0 under traffic) --chaos-probe
    times, each capture watched as --dump-after says; the rows."""
    plain = smoke.profilez_events
    rows = []

    def watched(url, sup, sec=smoke.FLEET_PROFILE_S):
        rep = next(r for r in sup._replicas if r.url == url)
        unwatch = watch(rep, fh_dir, args.dump_after,
                        f"chaos probe {len(rows)} {sec} s capture")
        try:
            return plain(url, sup, sec)
        finally:
            rows[-1]["dumped"] = unwatch()

    smoke.profilez_events = watched
    try:
        for i in range(args.chaos_probe):
            rows.append(dict(chaos_probe=i, dumped=False))
            t = time.monotonic()
            try:
                out = smoke.chaos_probe(model, model_dir)
                rows[-1].update(ok=True, requests_per_s=out[
                    "requests_per_s"], trace_records=out["trace_records"])
            except AssertionError as e:
                rows[-1].update(ok=False, error=str(e)[:600])
            rows[-1]["seconds"] = time.monotonic() - t
            smoke.log("  chaos probe: " + json.dumps(rows[-1]))
    finally:
        smoke.profilez_events = plain
    return rows


def profile_fleet(smoke, chaos, lg, model, make_feed, args, fleet, fh_dir):
    """One fleet under closed-loop traffic: each capture of --captures on
    replica 0 (on every replica with --each); the rows."""
    rows = []
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
            targets = range(len(urls)) if args.each else (0,)
            for sec in (float(s) for s in args.captures.split(",")):
                for idx in targets:
                    rows.append(capture(smoke, sup, urls[idx], idx, sec,
                                        args, fleet, fh_dir))
            stop.set()
            reps = join()
            smoke.log(f"  traffic: {sum(r['ok'] for r in reps)} ok, "
                      f"{sum(r['failed'] for r in reps)} failed")
        finally:
            if server is not None:
                server.close()
                router.close()
            sup.close(timeout_s=120)
    return rows


def last_seconds(lines, what, key):
    """The seconds after `key` on the last of `lines` that holds `what`
    and `key` (a replica log's capture or warm-up stage), or None."""
    for ln in reversed(lines):
        if what in ln and key in ln:
            return float(ln.split(key, 1)[1].split(" s", 1)[0])
    return None


def capture(smoke, sup, url, idx, sec, args, fleet, fh_dir):
    """One /profilez capture of replica `idx` at `url`: its row."""
    rep = sup._replicas[idx]
    gaps = smoke.HealthGaps([url], timeout=smoke.WATCHDOG_POLL_S)
    time.sleep(0.5)
    unwatch = watch(rep, fh_dir, args.dump_after,
                    f"fleet {fleet} {sec} s capture")
    t = time.monotonic()
    try:
        status, body = smoke.get(f"{url}/profilez?sec={sec}", timeout=300)
        doc = json.loads(body)
        with open(os.path.join(doc["dir"], "trace.json")) as f:
            events = len(json.load(f).get("traceEvents", []))
        error = None
    except OSError as e:
        status, doc, events = None, {}, None
        error = f"{type(e).__name__}: {e}"
    rt = time.monotonic() - t
    dumped = unwatch()
    time.sleep(1.0)
    gap = gaps.stop()
    row = dict(fleet=fleet, replica=idx, sec=sec, status=status,
               round_trip_s=rt, events=events, bytes=doc.get("bytes"),
               longest_healthz_gap_s=gap,
               replica_alive=rep.proc.poll() is None,
               hung_kills=rep.hung_kills, dumped=dumped, error=error)
    with open(rep.log_path, errors="replace") as f:
        stages = [ln.rstrip() for ln in f if any(
            k in ln for k in ("STAGE", "CUPTI", "kineto",
                              "profile capture", "profiler warm-up"))]
    row["capture_start_s"] = last_seconds(stages, "profile capture",
                                          "started after ")
    row["warmup_s"] = last_seconds(stages, "profiler warm-up",
                                   "stopped after ")
    os.makedirs(os.path.dirname(DUMPS), exist_ok=True)
    with open(DUMPS, "a") as out:
        out.write(f"==== profiler lines of replica {idx}'s log after "
                  f"fleet {fleet}'s {sec} s capture\n")
        out.write("\n".join(stages[-40:]) + "\n")
    smoke.log("  capture: " + json.dumps(row))
    if error is not None:
        sup.wait_ready(timeout_s=120)
    return row


if __name__ == "__main__":
    sys.exit(main())
