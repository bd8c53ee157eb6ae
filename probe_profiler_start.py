#!/usr/bin/env python3
"""How long does torch.profiler take to start, the first time and again,
in a fresh process on the card, before and after a model is served?

    python3 probe_profiler_start.py [--when fresh,served]

For each case of --when, a child process starts (this script with
--child CASE): "fresh" profiles right after CUDA initialises; "served"
first loads chip_smoke.py's chaos model (BERT-base at seq 128, fp32)
into a Predictor and answers 16 requests (eager, then captured CUDA
graphs), as a replica does before its first /profilez.  The child then
times three profiler sessions (CPU and CUDA activities, 0.1 s each):
start (``__enter__``), stop (``__exit__``) and the export of the trace
to /dev/shm.  The last line is one JSON object: the card's name and
power limit and each case's seconds.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def child(case):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    t0 = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    out = dict(case=case, cuda_init_s=time.perf_counter() - t0)
    if case == "served":
        import paddle_tpu_torch as tpt
        from paddle_tpu_torch.inference import Predictor

        t = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="probe_prof_") as wd:
            _model, model_dir = smoke.chaos_model(tpt, wd)
            pred = Predictor(model_dir)
            feeds = smoke.chaos_feeds(0)
            for i in range(16):
                pred.run(feeds[i % len(feeds)])
            torch.cuda.synchronize()
        out["served_s"] = time.perf_counter() - t
    sessions = []
    for _ in range(3):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        t = time.perf_counter()
        prof.__enter__()
        started = time.perf_counter() - t
        x = torch.randn(256, 256, device="cuda")
        for _ in range(10):
            x = x @ x
        time.sleep(0.1)
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        stopped = time.perf_counter() - t
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir="/dev/shm") as d:
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        sessions.append(dict(start_s=started, stop_s=stopped,
                             export_s=time.perf_counter() - t))
    out["sessions"] = sessions
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--when", default="fresh,served",
                    help="cases, in order: fresh, served")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_profiler_start: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as smoke

    smoke.use_bytecode_cache()
    from paddle_tpu_torch.ops.cuda import build

    build.build_all()
    cases = []
    for case in args.when.split(","):
        t = time.perf_counter()
        res = subprocess.run([sys.executable, __file__, "--child", case],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr[-3000:], file=sys.stderr)
            return 1
        doc = json.loads(res.stdout.strip().splitlines()[-1])
        doc["process_s"] = time.perf_counter() - t
        smoke.log("  " + json.dumps(doc))
        cases.append(doc)
    print(json.dumps(dict(card=smoke.card_line(), cases=cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
