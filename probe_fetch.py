#!/usr/bin/env python3
"""Which copy brings a serving request's fetches to ordinary host memory
faster, on one card.

    python3 probe_fetch.py [--turns N]

Builds chip_smoke's phase-4 BERT-base predictor (time_step.py's
``serving_predictor``; batch 4 at seq 128, so the logits fetch is
4 x 128 x 30522 float32, 62.5 MB) and times its requests with each of
two fetch copies, both of which hand the caller a fresh array in
pageable memory (``executor._host_array``: pages faulted in by one
mmap call) that no later request writes:

* ``pageable``: the port's own ``fetch_to_numpy``, one blocking
  device-to-host copy straight into that array;
* ``staged``: one pinned staging buffer a fetch shape and dtype, made at
  the first request and reused by every later one, copied into without
  blocking, one stream sync, then a host copy into that array.

The copies run in turns (pageable, staged, staged, pageable); each turn
is chip_smoke's ``kept_vs_dropped`` (N requests whose caller drops the
response, N kept, N kept, N dropped: the median ms of each, pinned host
allocations while keeping, kept responses unchanged).  Then each copy
alone, on the logits already on the card (median ms of N).  Prints the
card's name and power limit, then one JSON line.  Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def staged_fetch():
    """The staged copy: a pinned buffer a (shape, dtype), reused, then a
    host copy into a fresh ``_host_array``."""
    import torch
    from paddle_tpu_torch.framework import executor

    bufs = {}

    def fetch(tensors):
        out = []
        for t in tensors:
            if not t.is_cuda:
                out.append(executor.to_numpy(t))
                continue
            key = (tuple(t.shape), t.dtype)
            if key not in bufs:
                bufs[key] = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
            buf = bufs[key]
            buf.copy_(t.detach(), non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
            a = executor._host_array(tuple(t.shape),
                                     executor.to_numpy(buf[:0]).dtype)
            np.copyto(a, executor.to_numpy(buf))
            out.append(a)
        return out
    return fetch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=20,
                    help="requests a turn, and copies timed alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_fetch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import paddle_tpu_torch as tpt
    import time_step

    smoke = time_step.load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    pred = time_step.serving_predictor(tpt, smoke)
    feed = smoke.bert_feed(4, seed=42)
    copies = {"pageable": tpt.inference.fetch_to_numpy,
              "staged": staged_fetch()}
    rows = {}
    try:
        for i, name in enumerate(("pageable", "staged", "staged",
                                  "pageable")):
            tpt.inference.fetch_to_numpy = copies[name]
            medians, allocs, equal = smoke.kept_vs_dropped(pred, feed,
                                                           n=args.turns)
            rows[f"{name}#{i}"] = dict(medians, pinned_allocs_kept=allocs,
                                       kept_equal=equal)
            smoke.log(f"  {name} (turn {i}): kept {medians['kept']:.3f} ms, "
                      f"dropped {medians['dropped']:.3f} ms, pinned "
                      f"allocations while keeping {allocs}, kept "
                      f"responses unchanged {equal}")
    finally:
        tpt.inference.fetch_to_numpy = copies["pageable"]
    logits = torch.randn(4, smoke.BERT["seq_len"], smoke.BERT["vocab_size"],
                         device="cuda")
    for name, copy in copies.items():
        want = logits.cpu().numpy()
        times = []
        for _ in range(args.turns):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = copy([logits])[0]
            times.append((time.perf_counter() - t) * 1e3)
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: the copy changed the bits")
        rows[f"{name}_copy_alone_ms"] = float(np.median(times))
        smoke.log(f"  {name}: the 62.5 MB logits copy alone "
                  f"{np.median(times):.3f} ms (median of {args.turns})")
    pred.close()
    print(smoke.card_line())
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
