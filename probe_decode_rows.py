#!/usr/bin/env python3
"""Which op makes the cached decode's (or a prefill's) rows differ from
the uncached forward's rows on one device, or a speculative verify's rows
from the decode step's.

    python3 probe_decode_rows.py [--layers 2] [--products {as_is,f64}]
                                 [--program {decode,prefill,verify,serving}]
                                 [--attention {flash,xla,unfused}]
                                 [--device cuda|cpu] [--tiny]

Builds Llama at Llama-2-7B's widths (``--tiny``: a 2-layer toy) with
``attn_impl="xla"``: the uncached forward (``build_llama_forward``, batch
2 at max_seq_len 128) and the dense decode step (``build_llama_decode``,
2 slots), both over one scope with random weights from a seed.  Every op
of both programs is lowered in order with its outputs kept.  The decode
caches hold the forward's own post-RoPE K/V, and slot b decodes token
``ids[b, p_b]`` at position ``p_b``, so each decode intermediate has a
counterpart: the forward's same op (matched by type and occurrence;
``cached_attention`` against ``flash_attention``) at row ``p_b`` of
batch b.  Prints max |decode - forward| of each op's output over those
rows, and the first op whose rows differ.

``--program prefill`` compares a prefill instead (``build_llama_prefill``
at bucket 64 over the first PREFILL_LEN tokens of batch row 0, the K/V
fetched): each op's rows 0..PREFILL_LEN-1 against the forward's.

``--program verify`` holds the speculative verify program against the
paged decode step instead (``verify_rows``): both over one scope whose
pools hold random K/V from a seed (page 16, slot 0 mapped to pages
1..8), the verify's VERIFY_ROWS-row chunk (bucket VERIFY_BUCKET) at
position VERIFY_BASE first, then one decode step (2 slots, slot 1 idle)
for each of its rows in turn, each writing the pools the next run reads.
Row t of each verify op's output is compared with slot 0's row of the
same op in the decode step at position VERIFY_BASE + t (outputs without
a row axis, such as ``kv_pool_gather``'s view, whole; the pool writes
through that view).

``--program serving`` holds BERT's serving program (``build_bert_serving``
at BERT-base's widths, ``--tiny``: hidden 128, 2 heads; ``--layers``
encoder layers, seq SERVING_SEQ, fp32) at batch 1 against the same
request at row SERVING_ROW of a batch of SERVING_BATCH (``serving_rows``):
every op's output row of the batch-1 run against that row of the
batch-8 run (outputs without a batch axis, such as the position ids,
whole).  This is the serving engine's batched = single invariant, op by
op: a difference names the op whose rows depend on their batchmates.
``--attention`` picks BERT's attention branch: ``flash`` (the packed
kernel, the default), ``xla`` (the einsum formulation) or ``unfused``
(``matmul``, ``softmax``, ``matmul``).

``--products f64`` computes every torch.matmul in float64 and rounds it
to float32, so that no product's rows depend on how many rows it has
(the rounding hides the float64 sums' order almost always); the first op
that differs then is one that is not a product.  Prints one JSON line at
the end.  Needs the card unless ``--device cpu``.
"""
import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
LLAMA = dict(vocab_size=32000, hidden=4096, num_heads=32,
             intermediate=11008)
TINY = dict(vocab_size=97, hidden=64, num_heads=4, intermediate=96)
SEQ = 128
POSITIONS = (37, 101)
BUCKET, PREFILL_LEN = 64, 50
VERIFY_PAGE, VERIFY_BASE, VERIFY_ROWS, VERIFY_BUCKET = 16, 37, 5, 8
BERT_BASE = dict(vocab_size=30522, hidden=768, num_heads=12,
                 intermediate=3072)
BERT_TINY = dict(vocab_size=97, hidden=128, num_heads=2, intermediate=256)
SERVING_SEQ, SERVING_BATCH, SERVING_ROW = 128, 8, 3


def lower_all(block, env, device):
    """Lower every op of `block` into `env`, keeping every output;
    returns [(op, {output name: tensor})]."""
    import torch
    from paddle_tpu_torch.ops.registry import LowerContext, lower_op

    ctx = LowerContext(block, env, device, is_test=True)
    done = []
    with torch.no_grad():
        for i, op in enumerate(block.ops):
            if op.type in ("feed", "fetch"):
                continue
            lower_op(ctx, op, i)
            done.append((op, {n: env[n] for n in op.output_arg_names()
                              if n in env}))
    return done


def state_env(block, scope, feeds, device):
    from paddle_tpu_torch.framework.executor import analyze_block

    state_in, _ = analyze_block(block, list(feeds))
    env = {n: scope.find_var(n) for n in state_in}
    env.update(feeds)
    return env


def rows_of(fwd, dec, prefill):
    """(the decode's (prefill's) rows, the forward's rows at the same
    positions): along the axis where the decode has 1 (the prefill
    BUCKET) and the forward SEQ, the first such after the batch axis;
    None where the shapes do not pair so."""
    import torch

    if fwd.dim() != dec.dim() or dec.dim() < 2:
        return None
    width = BUCKET if prefill else 1
    for a in range(1, fwd.dim()):
        if dec.shape[a] == width and fwd.shape[a] == SEQ and \
                fwd.shape[1:a] == dec.shape[1:a] and \
                fwd.shape[a + 1:] == dec.shape[a + 1:]:
            if prefill:
                return (dec[:1].narrow(a, 0, PREFILL_LEN),
                        fwd[:1].narrow(a, 0, PREFILL_LEN))
            if fwd.shape[0] != dec.shape[0]:
                return None
            return dec, torch.cat([fwd[b:b + 1].narrow(a, p, 1)
                                   for b, p in enumerate(POSITIONS)])
    return None


def verify_pair(ver, dec, t):
    """(the verify's row t, the decode step's slot-0 row) of one op's
    outputs: along the first axis where the verify has VERIFY_BUCKET rows
    and the decode step 1 (or none, where the decode squeezed it); the
    whole of both where their shapes agree after taking slot 0; None
    where they do not pair so."""
    if dec.dim() < 1 or ver.dim() < 1:
        return None
    d0 = dec[:1]
    if ver.shape == d0.shape:
        return ver, d0
    for a in range(1, ver.dim()):
        if ver.shape[a] != VERIFY_BUCKET:
            continue
        rest = ver.shape[:a] + ver.shape[a + 1:]
        if d0.dim() == ver.dim() and d0.shape[a] == 1 and \
                d0.shape[:a] + d0.shape[a + 1:] == rest:
            return ver.narrow(a, t, 1), d0
        if d0.shape == rest:
            return ver.narrow(a, t, 1).squeeze(a), d0
    return None


def verify_rows(model, device, seed=13):
    """Every op's rows of the verify program (``build_llama_verify``)
    against the paged decode step's at the same positions, on `device`
    with `model`'s sizes and random weights: [{"op", "index", "out",
    "row", "max_abs_diff"}] in op order, one a row."""
    import torch
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models.llama import (build_llama_decode,
                                               build_llama_verify)

    np_slot = SEQ // VERIFY_PAGE
    num_pages = 2 * np_slot + 1
    place = tpt.CPUPlace() if device.type == "cpu" else None
    scope = tpt.Scope()
    dec_main, dec_start = tpt.Program(), tpt.Program()
    dec_start._is_startup = True
    dec_start.random_seed = dec_main.random_seed = 7
    with tpt.program_guard(dec_main, dec_start):
        _, _, cache_names = build_llama_decode(
            2, SEQ, name="llama", paged=True, num_pages=num_pages,
            page_tokens=VERIFY_PAGE, **model)
    exe = tpt.Executor(place)
    exe.run(dec_start, scope=scope)
    exe.close()
    ver_main = tpt.Program()
    with tpt.program_guard(ver_main, tpt.Program()):
        build_llama_verify(VERIFY_BUCKET, SEQ, num_pages, VERIFY_PAGE,
                           name="llama", **model)
    rng = np.random.RandomState(seed)
    heads = model["num_heads"]
    n_kv = model.get("num_kv_heads") or heads
    shape = (num_pages, n_kv, VERIFY_PAGE, model["hidden"] // heads)
    for n in cache_names:
        scope.set_var(n, torch.as_tensor(
            rng.standard_normal(shape).astype("float32"), device=device))
    ids = rng.randint(1, model["vocab_size"], size=VERIFY_ROWS)
    table = np.arange(1, np_slot + 1, dtype="int32")

    def run(main, feeds):
        block = main.global_block()
        feeds = {n: torch.as_tensor(v, device=device)
                 for n, v in feeds.items()}
        done = lower_all(block, state_env(block, scope, feeds, device),
                         device)
        for op, outs in done:  # the pool writes land in the scope
            for n, v in outs.items():
                if n in cache_names:
                    scope.set_var(n, v)
        return done

    chunk = np.zeros((1, VERIFY_BUCKET), "int64")
    chunk[0, :VERIFY_ROWS] = ids
    ver = run(ver_main, {"chunk_ids": chunk,
                         "base": np.asarray([VERIFY_BASE], "int32"),
                         "block_table": table[None],
                         "chunk_len": np.asarray([VERIFY_ROWS], "int32")})
    tables = np.zeros((2, np_slot), "int32")
    tables[0] = table
    report = []
    for t in range(VERIFY_ROWS):
        dec = run(dec_main, {
            "tokens": np.asarray([[ids[t]], [0]], "int64"),
            "positions": np.asarray([VERIFY_BASE + t, 0], "int32"),
            "block_tables": tables, "live": np.asarray([1, 0], "int32")})
        by_type = {}
        for op, outs in dec:
            by_type.setdefault(op.type, []).append(outs)
        seen = {}
        for op, outs in ver:
            n = seen.get(op.type, 0)
            seen[op.type] = n + 1
            pool = by_type.get(op.type, [])
            if n >= len(pool) or op.type == "kv_pool_write":
                continue
            for i, (name, got) in enumerate(outs.items()):
                want = list(pool[n].values())[i] \
                    if len(pool[n]) == len(outs) else None
                if not isinstance(got, torch.Tensor) or want is None or \
                        not got.is_floating_point() or not got.numel():
                    continue
                rows = verify_pair(got, want, t)
                if rows is None:
                    continue
                d = float((rows[0].double() - rows[1].double()).abs().max())
                report.append({"op": op.type, "index": n, "out": name,
                               "row": t, "max_abs_diff": d})
    return report


def serving_feed(batch, seq_len, vocab, seed):
    """BERT serving feeds: random ids and types, each row's attention
    mask padded at a length of its own (row 0 full)."""
    rng = np.random.RandomState(seed)
    mask = np.ones((batch, seq_len), "float32")
    for b in range(batch):
        mask[b, seq_len - (b * 13) % (seq_len // 2):] = 0.0
    return {"input_ids": rng.randint(0, vocab, (batch, seq_len)
                                     ).astype("int64"),
            "token_type_ids": (rng.rand(batch, seq_len) > 0.5
                               ).astype("int64"),
            "attn_mask": mask}


# --attention: BERT's use_flash for each attention branch
ATTENTION = {"flash": True, "xla": "xla", "unfused": False}


def serving_rows(model, device, seq_len=SERVING_SEQ, seed=5):
    """Every op's output of BERT's serving program run on one request
    alone against the same op's row SERVING_ROW of a SERVING_BATCH-row
    batch holding that request there, on `device` with `model`'s sizes
    (``num_layers`` and ``use_flash`` among them) and random weights:
    [{"op", "index",
    "out", "max_abs_diff"}] in op order."""
    import torch
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models import build_bert_serving

    place = tpt.CPUPlace() if device.type == "cpu" else None
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    startup.random_seed = main.random_seed = 9
    with tpt.program_guard(main, startup):
        build_bert_serving(seq_len=seq_len, **model)
    scope = tpt.Scope()
    exe = tpt.Executor(place)
    exe.run(startup, scope=scope)
    exe.close()
    feed = serving_feed(SERVING_BATCH, seq_len, model["vocab_size"], seed)
    block = main.global_block()

    def run(rows):
        feeds = {n: torch.as_tensor(v[rows], device=device)
                 for n, v in feed.items()}
        return lower_all(block, state_env(block, scope, feeds, device),
                         device)

    one = run(slice(SERVING_ROW, SERVING_ROW + 1))
    many = run(slice(0, SERVING_BATCH))
    seen, report = {}, []
    for (op, got), (_op, want) in zip(one, many):
        n = seen.get(op.type, 0)
        seen[op.type] = n + 1
        for name, a in got.items():
            b = want.get(name)
            if not isinstance(a, torch.Tensor) or b is None or \
                    not a.numel():
                continue
            if a.shape != b.shape:
                k = a.shape[0]  # rows of one request on the batch axis
                if a.dim() != b.dim() or b.shape[0] != SERVING_BATCH * k \
                        or a.shape[1:] != b.shape[1:]:
                    continue
                b = b[SERVING_ROW * k:(SERVING_ROW + 1) * k]
            d = float((a.double() - b.double()).abs().max())
            report.append({"op": op.type, "index": n, "out": name,
                           "max_abs_diff": d})
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--products", choices=("as_is", "f64"), default="as_is")
    ap.add_argument("--program",
                    choices=("decode", "prefill", "verify", "serving"),
                    default="decode")
    ap.add_argument("--attention", choices=tuple(ATTENTION),
                    default="flash")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()

    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models.llama import (build_llama_decode,
                                               build_llama_forward,
                                               build_llama_prefill)

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    if args.products == "f64":
        matmul = torch.matmul

        def matmul_f64(a, b, **kw):
            if a.dtype == torch.float32 and b.dtype == torch.float32:
                return matmul(a.double(), b.double()).float()
            return matmul(a, b, **kw)
        torch.matmul = matmul_f64

    if args.program == "serving":
        model = dict(BERT_TINY if args.tiny else BERT_BASE,
                     num_layers=args.layers,
                     use_flash=ATTENTION[args.attention])
        report = serving_rows(model, device)
        first = next((r for r in report if r["max_abs_diff"] > 0), None)
        for r in report:
            print(f"  {r['op']:>20} #{r['index']:<3} {r['out']:<40} "
                  f"max|d| {r['max_abs_diff']:.3e}")
        print(f"first op whose rows differ (batch 1 against row "
              f"{SERVING_ROW} of {SERVING_BATCH}, {args.products} "
              f"products): {first}")
        print(json.dumps({"products": args.products, "program": "serving",
                          "attention": args.attention,
                          "device": str(device),
                          "kind": torch.cuda.get_device_name(0)
                          if device.type == "cuda" else "cpu",
                          "rows": SERVING_BATCH, "compared": len(report),
                          "first": first,
                          "max_abs_diff": max(
                              (r["max_abs_diff"] for r in report),
                              default=0.0)}))
        return 0
    model = dict(TINY if args.tiny else LLAMA, num_layers=args.layers)
    if args.program == "verify":
        report = verify_rows(model, device)
        first = next((r for r in report if r["max_abs_diff"] > 0), None)
        worst = {}
        for r in report:
            key = (r["op"], r["index"], r["out"])
            worst[key] = max(worst.get(key, 0.0), r["max_abs_diff"])
        for (op, i, out), d in worst.items():
            print(f"  {op:>18} #{i:<3} {out:<40} max|d| over rows {d:.3e}")
        print(f"first op whose rows differ (verify against decode, "
              f"{args.products} products): {first}")
        print(json.dumps({"products": args.products, "program": "verify",
                          "device": str(device),
                          "kind": torch.cuda.get_device_name(0)
                          if device.type == "cuda" else "cpu",
                          "rows": VERIFY_ROWS, "compared": len(report),
                          "first": first,
                          "max_abs_diff": max(worst.values(), default=0.0)}))
        return 0
    place = tpt.CPUPlace() if device.type == "cpu" else None
    scope = tpt.Scope()
    dec_main, dec_start = tpt.Program(), tpt.Program()
    dec_start._is_startup = True
    dec_start.random_seed = dec_main.random_seed = 7
    with tpt.program_guard(dec_main, dec_start):
        _, dec_fetch, cache_names = build_llama_decode(
            len(POSITIONS), SEQ, name="llama", **model)
    exe = tpt.Executor(place)
    exe.run(dec_start, scope=scope)
    exe.close()
    fwd_main, fwd_start = tpt.Program(), tpt.Program()
    with tpt.program_guard(fwd_main, fwd_start):
        build_llama_forward(len(POSITIONS), SEQ, name="llama",
                            attn_impl="xla", **model)

    rng = np.random.RandomState(11)
    ids = rng.randint(1, model["vocab_size"], size=(len(POSITIONS), SEQ))
    fwd = lower_all(fwd_main.global_block(), state_env(
        fwd_main.global_block(), scope,
        {"input_ids": torch.as_tensor(ids, device=device)}, device), device)
    # the caches hold the forward's post-RoPE K / V (each flash_attention's
    # inputs), layer by layer
    attn = [op for op, _ in fwd if op.type == "flash_attention"]
    env = {}
    for op, outs in fwd:
        env.update(outs)
    for i, op in enumerate(attn):
        for kind, slot in (("k", "K"), ("v", "V")):
            scope.set_var(f"llama.cache_{kind}_{i}",
                          env[op.single_input(slot)].clone())
    feeds = {"tokens": torch.as_tensor(
                 [[ids[b, p]] for b, p in enumerate(POSITIONS)],
                 device=device),
             "positions": torch.as_tensor(POSITIONS, dtype=torch.int32,
                                          device=device)}
    prefill = args.program == "prefill"
    if prefill:
        dec_main = tpt.Program()
        with tpt.program_guard(dec_main, tpt.Program()):
            build_llama_prefill(1, BUCKET, name="llama", attn_impl="xla",
                                **model)
        padded = np.zeros((1, BUCKET), "int64")
        padded[0, :PREFILL_LEN] = ids[0, :PREFILL_LEN]
        feeds = {"input_ids": torch.as_tensor(padded, device=device),
                 "last_pos": torch.as_tensor([PREFILL_LEN - 1],
                                             device=device)}
    dec = lower_all(dec_main.global_block(), state_env(
        dec_main.global_block(), scope, feeds, device), device)

    by_type = {}
    for op, outs in fwd:
        by_type.setdefault(op.type, []).append(outs)
    seen, report, first = {}, [], None
    for op, outs in dec:
        kind = "flash_attention" if op.type == "cached_attention" \
            else op.type
        n = seen.get(kind, 0)
        seen[kind] = n + 1
        pool = by_type.get(kind, [])
        if n >= len(pool) or op.type in ("kv_cache_write",):
            continue
        for name, got in outs.items():
            want = list(pool[n].values())[list(outs).index(name)] \
                if len(pool[n]) == len(outs) else None
            if not isinstance(got, torch.Tensor) or want is None:
                continue
            rows = rows_of(want, got, prefill)
            if rows is None or not got.is_floating_point():
                continue
            d = float((rows[0].double() - rows[1].double()).abs().max())
            report.append({"op": op.type, "index": n, "out": name,
                           "max_abs_diff": d})
            if d > 0 and first is None:
                first = report[-1]
    for r in report:
        print(f"  {r['op']:>18} #{r['index']:<3} {r['out']:<40} "
              f"max|d| {r['max_abs_diff']:.3e}")
    print(f"first op whose rows differ ({args.program}, {args.products} "
          f"products): {first}")
    print(json.dumps({"products": args.products, "program": args.program,
                      "device": str(device),
                      "kind": torch.cuda.get_device_name(0)
                      if device.type == "cuda" else "cpu",
                      "first": first, "ops": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
