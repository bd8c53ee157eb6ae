#!/usr/bin/env python3
"""Times one checkout's training steps and serving request on one card.

    python3 time_step.py [--checkout DIR] [--paths NAME,...]

Imports ``paddle_tpu_torch`` from DIR (default: the directory of this
script) and drives it through its public entry points, with the
programs, batches and configurations of chip_smoke.py (from this
script's directory), so two checkouts run the same work on the same
weights.  The paths (all by default):

* ``serving_b4``: BERT-base serving (chip_smoke phase 4), one batch-4
  request at seq 128 through ``Predictor.run`` (numpy fetches);
* ``bert_fp32``: the fp32 BERT-base step at seq 512, batch 8 (phase 5's
  profiled step);
* ``bert_flagship``: bench.py's bf16 seq-512 step (phase 6);
* ``llama_flagship``: the 4-layer Llama-2-7B-width bf16 step (phase 9).

Each path runs WARM calls (a compiled step's first run is eager and its
second captures its CUDA graph), then one call under torch.profiler
(wall ms, device busy ms, idle share, host kernel and graph launches),
then a window of calls timed with the host clock, each ending in its
numpy fetch (ms a call).  Prints the card's name and power limit, then
one JSON line {"checkout": DIR, "paths": {name: numbers}}.

Two checkouts compare fairly only inside one machine session: run the
script for each in turns (parent, change, change, parent).  It needs a
CUDA device and exits non-zero without one.
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PATHS = ("serving_b4", "bert_fp32", "bert_flagship", "llama_flagship")
WARM = 3
WINDOW = {"serving_b4": 20, "bert_fp32": 5, "bert_flagship": 10,
          "llama_flagship": 10}


def profiled(smoke, key, call):
    """One profiled call of `call`: chip_smoke.report_profile's numbers."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        wall_us = (time.perf_counter() - t) * 1e6
    smoke.report_profile(prof, wall_us, key, key=key)
    return smoke.PROFILES[key]


def measure(smoke, key, call):
    """WARM calls, one profiled call, then WINDOW[key] timed calls."""
    for _ in range(WARM):
        call()
    row = dict(profiled(smoke, key, call))
    times = []
    for _ in range(WINDOW[key]):
        t = time.perf_counter()
        call()
        times.append((time.perf_counter() - t) * 1e3)
    row["window_ms"] = times
    row["median_ms"] = sorted(times)[len(times) // 2]
    smoke.log(f"  {key}: {row['median_ms']:.3f} ms a call (median of "
              f"{len(times)}), wall {row['wall_ms']:.3f} ms, busy "
              f"{row['busy_ms']:.3f} ms, launches "
              f"{row['kernel_launches']} kernel / {row['graph_launches']} "
              f"graph")
    return row


def close(obj):
    """Frees an executor's or predictor's graphs where it has any."""
    if hasattr(obj, "close"):
        obj.close()


def train(smoke, tpt, key, built, feed, loss):
    import torch

    main, startup, _ = built
    exe, scope = tpt.Executor(), tpt.Scope()
    exe.run(startup, scope=scope)
    row = measure(smoke, key, lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope))
    close(exe)
    del scope
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", default=HERE,
                    help="directory holding the paddle_tpu_torch to time")
    ap.add_argument("--paths", default=",".join(PATHS),
                    help="comma-separated subset of " + ", ".join(PATHS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_step: no CUDA device", file=sys.stderr)
        return 2
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    import paddle_tpu_torch as tpt

    if not os.path.abspath(tpt.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"paddle_tpu_torch imported from {tpt.__file__}, "
                           f"not from {checkout}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke.log(f"timing the steps of {checkout}")
    rows = {}
    for key in args.paths.split(","):
        if key == "serving_b4":
            from paddle_tpu_torch.models import build_bert_pretrain

            main, startup = tpt.Program(), tpt.Program()
            with tpt.program_guard(main, startup):
                feeds, outs = build_bert_pretrain(is_test=True, **smoke.BERT)
            logits = [op for op in main.global_block().ops
                      if op.type == "softmax_with_cross_entropy"][0].input(
                          "Logits")[0]
            with tempfile.TemporaryDirectory(prefix="time_step_") as d:
                exe, scope = tpt.Executor(), tpt.Scope()
                with tpt.scope_guard(scope):
                    exe.run(startup)
                    tpt.io.save_inference_model(d, feeds,
                                                [logits, outs["loss"]],
                                                exe, main_program=main)
                del scope
                pred = tpt.inference.Predictor(d)
            feed = smoke.bert_feed(4, seed=41)
            rows[key] = measure(smoke, key, lambda: pred.run(feed))
            close(pred)
            del pred
        elif key == "bert_fp32":
            built = smoke.build_train(tpt, smoke.FLAGSHIP, smoke.PARITY_LR,
                                      amp=False, dropout=0.0)
            rows[key] = train(smoke, tpt, key, built, smoke.train_batch(
                smoke.FLAGSHIP, seed=650, padding=True), built[2])
        elif key == "bert_flagship":
            built = smoke.build_train(tpt, smoke.FLAGSHIP, smoke.FLAGSHIP_LR,
                                      amp=True, dropout=0.1)
            rows[key] = train(smoke, tpt, key, built, smoke.train_batch(
                smoke.FLAGSHIP, seed=600, padding=False), built[2])
        elif key == "llama_flagship":
            built = smoke.build_llama(tpt, smoke.LLAMA_FLAGSHIP,
                                      smoke.LLAMA_FLAGSHIP_LR, amp=True)
            rows[key] = train(smoke, tpt, key, built, smoke.llama_batch(
                smoke.LLAMA_FLAGSHIP, seed=800), built[2])
        else:
            raise ValueError(f"unknown path {key!r}; known: {PATHS}")
        torch.cuda.empty_cache()
    print(smoke.card_line())
    print(json.dumps({"checkout": checkout, "paths": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
