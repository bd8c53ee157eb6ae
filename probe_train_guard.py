#!/usr/bin/env python3
"""What a bit-exact resume of bench.py's training step rests on, on one
card.

    python3 probe_train_guard.py [--lives N] [--steps N]

Builds chip_smoke's phase-14 step (bench.py's flagship: BERT-base, seq
512, batch 8, 77 predictions, bf16 AMP, dropout 0.1, Adam with
global-norm clip and warmup) and runs:

* ``lives``: N uninterrupted guarded lives of the step from one startup
  scope, copied (each a fresh Executor and scope, run counts 1..steps),
  fetching the loss and the token-type, position and word embeddings'
  gradients: every fetch at every step and every persistable at the end
  held against the first life's, bit for bit.  Once with the embedding
  lookup as the port lowers it on the card (ids in chunks of
  ``ops/tensor_ops.py`` ``EMBEDDING_GRAD_CHUNK``) and once with the
  chunking off (one PyTorch lookup of all 4096 ids): the steps and
  fetches that differ, and by how much.
* ``pickle``: the flagship's persistable state (what a checkpoint
  writes), pickled with protocol 2 (the reference's) and 5 (the
  port's): bytes, dump and load seconds on this host.
* ``memory_allocated``: the host microseconds of one
  ``torch.cuda.memory_allocated()`` call, the median of 200.

Prints the card's name and power limit, then one JSON line.  Needs a
CUDA device; ``--device cpu --tiny`` runs the same code on the CPU at a
small BERT (no card number means anything there).
"""
import argparse
import io
import json
import os
import pickle
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = dict(vocab_size=97, hidden=128, num_layers=2, num_heads=2,
            intermediate=256, batch_size=2, seq_len=32, max_predictions=5)
FETCHED = ("embedding_2.w_0@GRAD", "embedding_1.w_0@GRAD",
           "embedding_0.w_0@GRAD")


def flagship_step(cs, tpt, device, cfg):
    """(program, loss, persistable names, startup state by name,
    batches) of phase 14's step."""
    main, startup, loss = cs.build_train(tpt, cfg, cs.FLAGSHIP_LR, amp=True,
                                         dropout=0.1)
    names = [v.name for v in main.list_vars() if v.persistable]
    scope = tpt.Scope()
    tpt.Executor(device).run(startup, scope=scope)
    start = {n: scope.find_var(n).clone() for n in names}
    return main, loss, names, start, cs.guard_batches()


def lives(cs, tpt, device, step, n_lives, steps):
    """`n_lives` uninterrupted guarded lives; returns the differences of
    each later life from the first: (life, run, fetch, elements, max)."""
    import torch

    main, loss, names, start, batches = step
    fetch = [loss] + [f for f in FETCHED
                      if main.global_block().has_var(f)]
    runs = []
    for _ in range(n_lives):
        exe = tpt.Executor(device)
        exe.set_nonfinite_guard(loss, program=main)
        scope = cs.guard_scope(tpt, start)
        outs = [exe.run(main, feed=batches[k % len(batches)],
                        fetch_list=fetch, scope=scope)
                for k in range(steps)]
        runs.append((outs, {n: scope.find_var(n).clone() for n in names}))
        exe.close()
    diffs = []
    ref_outs, ref_state = runs[0]
    for life, (outs, state) in enumerate(runs[1:], 1):
        for k in range(steps):
            for name, a, b in zip(fetch, ref_outs[k], outs[k]):
                a = np.ravel(a).astype(np.float64)
                b = np.ravel(b).astype(np.float64)
                d = np.abs(a - b)
                if not np.array_equal(a, b):
                    diffs.append(dict(life=life, run=k + 1, fetch=name,
                                      elements=int((d > 0).sum()),
                                      max=float(np.nanmax(d))))
        moved = [n for n in names if not torch.equal(ref_state[n], state[n])]
        if moved:
            diffs.append(dict(life=life, persistables=moved))
    return diffs


def pickled(start):
    """Bytes and host seconds of the state pickled with protocols 2 and
    5 (dump into memory, then load)."""
    from paddle_tpu_torch.framework.executor import fetch_to_numpy

    arrays = dict(zip(start, fetch_to_numpy(list(start.values()))))
    out = {"state_bytes": int(sum(a.nbytes for a in arrays.values()))}
    for proto in (2, 5):
        buf = io.BytesIO()
        t = time.perf_counter()
        pickle.dump(arrays, buf, protocol=proto)
        dump_s = time.perf_counter() - t
        t = time.perf_counter()
        buf.seek(0)
        pickle.load(buf)
        out[f"protocol_{proto}"] = dict(
            bytes=buf.getbuffer().nbytes, dump_s=dump_s,
            load_s=time.perf_counter() - t)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lives", type=int, default=5)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cpu: run the code on the CPU (with --tiny)")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops import tensor_ops

    if args.device != "cpu" and not torch.cuda.is_available():
        print("probe_train_guard: no CUDA device", file=sys.stderr)
        return 2
    device = tpt.CPUPlace() if args.device == "cpu" else None
    if args.device != "cpu":
        from paddle_tpu_torch.ops.cuda import build
        from paddle_tpu_torch.ops.cuda import flash_attention as fa

        build.build_all()
        fa._lib()
        fa._bwd_lib()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(cs.card_line())
    if args.tiny:
        cs.FLAGSHIP = dict(TINY)  # guard_batches reads it too
    step = flagship_step(cs, tpt, device, cs.FLAGSHIP)
    out = {"chunked": lives(cs, tpt, device, step, args.lives, args.steps)}
    chunk = tensor_ops.EMBEDDING_GRAD_CHUNK
    tensor_ops.EMBEDDING_GRAD_CHUNK = 1 << 62
    try:
        out["one_lookup"] = lives(cs, tpt, device, step, args.lives,
                                  args.steps)
    finally:
        tensor_ops.EMBEDDING_GRAD_CHUNK = chunk
    out["pickle"] = pickled(step[3])
    if args.device != "cpu":
        times = []
        for _ in range(200):
            t = time.perf_counter()
            torch.cuda.memory_allocated()
            times.append((time.perf_counter() - t) * 1e6)
        out["memory_allocated_us"] = float(np.median(times))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
