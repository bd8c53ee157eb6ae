#!/usr/bin/env python3
"""Does a chaos replica bisect a poisoned request at a given rate and
batch window?

    python3 probe_chaos_window.py [--qps 64] [--windows 10,auto]
                                  [--duration 12] [--checkout DIR]

Builds the kernels, saves chip_smoke.py's chaos model (BERT-base at seq
128, fp32) and, for each batch window given (milliseconds, or "auto"
for chip_smoke.chaos_batch_window_ms at --qps), runs the chaos
harness's poison scenario alone on a fresh fleet of chip_smoke.py's
CHAOS_REPLICAS replicas at --qps for --duration seconds.  Logs, per
window, the poisoned requests, the bisections and the poisoned rows the
replicas isolated, collateral failures and p99.  --checkout runs another
tree's package and chip_smoke.py ("auto" needs a tree that has it).  The
last line is one JSON object: the card's name and power limit and every
window's numbers.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--qps", type=float, default=64.0,
                    help="the harness's paced rate through the router")
    ap.add_argument("--windows", default="10,auto",
                    help="batch windows in ms, or auto, in order")
    ap.add_argument("--duration", type=float, default=12.0,
                    help="seconds of the poison scenario a window")
    ap.add_argument("--checkout", default=HERE,
                    help="directory holding paddle_tpu_torch and "
                         "chip_smoke.py")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_chaos_window: no CUDA device", file=sys.stderr)
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

    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    smoke.log(f"probe_chaos_window of {checkout} on {card}")
    t0 = time.perf_counter()
    build.build_all()
    smoke.log(f"built in {time.perf_counter() - t0:.1f} s")

    rows = []
    with smoke.tempfile.TemporaryDirectory(prefix="probe_chaos_") as wd:
        model, _ = smoke.chaos_model(tpt, wd)
        for w in args.windows.split(","):
            window = smoke.chaos_batch_window_ms(args.qps) if w == "auto" \
                else float(w)
            with smoke.fleet_workdir("probe_chaos_fleet_", "probe") as fd:
                rep = chaos.run_chaos(
                    replicas=smoke.CHAOS_REPLICAS, qps=args.qps,
                    duration_s=args.duration, scenarios=("poison",),
                    liveness_timeout_ms=smoke.CHAOS_LIVENESS_MS,
                    forward_timeout_ms=1000.0, workdir=fd,
                    log=lambda m: smoke.log("  " + m), device="cuda",
                    model=smoke.chaos_windowed(model, window))
            sc = rep["scenarios"]["poison"]
            row = dict(window_ms=window, requests=sc["requests"],
                       poisoned=sc["injected_failures"],
                       bisections=sc["notes"].get("bisections"),
                       poison_rows=sc["notes"].get("poison_rows"),
                       collateral=sc["collateral_failures"],
                       p99_ms=sc["p99_ms"], ok=rep["ok"])
            rows.append(row)
            smoke.log("  window: " + json.dumps(row))
    print(json.dumps(dict(checkout=checkout, card=card, qps=args.qps,
                          duration_s=args.duration, windows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
