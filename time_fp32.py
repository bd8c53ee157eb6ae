#!/usr/bin/env python3
"""Times the fp32 kernels (and hashes the 16-bit attention kernels) of
one checkout on one card.

    python3 time_fp32.py [--what {forward,backward,gemm,rms_norm,
                                  gemm_plans,attention16}] [--checkout DIR]
                         [--sdpa-sass]

Imports ``paddle_tpu_torch`` from DIR (default: the directory of this
script), builds its kernels there, and runs chip_smoke.py's timing
functions (from this script's directory) on them.  ``forward`` (the
default): ``time_forward_f32``, BERT-base serving at batch 1, 4 and 8,
BERT's training shape and the Llama shape (causal).  ``backward``: the
fp32 dK/dV and dQ kernels at BERT's training shape (``time_backward``,
packed, bias and bias gradient) and at the Llama shape (the dK/dV and dQ
rows of ``time_unpacked``, causal).  Each row holds the kernel's event
time of back-to-back calls and its device time under torch.profiler,
beside scaled_dot_product_attention's and the bound, each result held to
the plain version.  ``gemm``: the product kernel (``time_gemm``) at
Llama-2-7B's and BERT's product shapes at M 4 and 512 and at decode
attention's Q K^T and P V; ``rms_norm``: the RMSNorm kernel
(``time_rms_norm``) at [4, 4096] and [512, 4096].  Their rows hold the
kernel's event and device time beside the library call's and the bound,
and the sha256 of its output on inputs from fixed seeds: equal hashes
across checkouts show equal bits.  ``gemm_plans`` (this checkout's
wrapper only): the device time of every tiled launch (K split) and
skinny launch (lane width x cluster) at the main path's shapes, each
output held bit-equal to the chosen launch's, beside the launch model's
time (``gemm.tiled_time``).  ``attention16``: the six tensor-core
attention kernels in bfloat16 and float16 (a checkout without float16
reports it not supported) at BERT's training shape (packed, padding
bias, bias gradient) and the Llama shape (unpacked views, causal), each
output's sha256 on inputs from fixed seeds and each kernel's device time:
equal hashes across checkouts show equal bits.  Prints the card's name
and power limit, then one
JSON line {"checkout": DIR, "what": ..., "rows": ...}.  With --sdpa-sass
(backward only) it also prints, for the longest kernel of
scaled_dot_product_attention's backward at each shape, the count of
fp32 FMA (FFMA) and tensor-core (HMMA) instructions in its sm_90 SASS,
from the toolkit's cuobjdump over torch's libtorch_cuda.so.

Two checkouts compare fairly only inside one machine session: run the
script for each in turns (parent, change, change, parent).  It needs a
CUDA device and exits non-zero without one.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def sass_ops(names, cuobjdump):
    """{kernel name: {opcode: count}} of FFMA, HMMA and the other opcodes
    named below in the sm_90 SASS of each kernel in torch's
    libtorch_cuda.so: its mangled names are the symbols (from nm) that
    hold the kernel's base name (the identifier before its template or
    parameter list), each disassembled alone (cuobjdump -fun)."""
    import torch

    lib = os.path.join(os.path.dirname(torch.__file__), "lib",
                       "libtorch_cuda.so")
    syms = set()
    for flags in (["--defined-only"], ["-D", "--defined-only"]):
        out = subprocess.run(["nm", *flags, lib], capture_output=True,
                             text=True, timeout=600).stdout
        syms |= {line.split()[-1] for line in out.splitlines()
                 if line.split()}
    ops = ("FFMA", "HMMA", "FMUL", "FADD", "LDS", "LDSM", "LDGSTS")
    counts = {}
    for name in names:
        head = re.split(r"[<(]", name.replace("void ", "", 1))[0]
        base = head.split("::")[-1].strip()
        found = sorted(m for m in syms if base and base in m)[:4]
        got = {"symbols": len(found)}
        for mangled in found:
            try:
                sass = subprocess.run(
                    [cuobjdump, "-sass", "-arch", "sm_90", "-fun", mangled,
                     lib], capture_output=True, text=True,
                    timeout=600).stdout
            except subprocess.TimeoutExpired:
                got["cuobjdump timed out"] = got.get(
                    "cuobjdump timed out", 0) + 1
                continue
            for line in sass.splitlines():
                m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?\w+\s+)?"
                             r"([A-Z0-9]+)", line)
                if m and m.group(1) in ops:
                    got[m.group(1)] = got.get(m.group(1), 0) + 1
        counts[name] = got
    return counts


# (name, batch, M, N, K) of the products whose launches gemm_plans
# compares: a 512-token prefill's and a 64-token one's Llama products, a
# 128-token chunk's, BERT serving's at batch 4 and 1 (M 512, 128), decode
# attention's over a 128-token chunk, and the decode step's
PLAN_SHAPES = (
    [(f"llama_M{M}_{k}", 1, M, n, kk) for M in (512, 64)
     for k, n, kk in (("qkv", 12288, 4096), ("attn_out", 4096, 4096),
                      ("gate_up", 22016, 4096), ("ffn_out", 4096, 11008))]
    + [("llama_M128_attn_out", 1, 128, 4096, 4096)]
    + [(f"bert_M{M}_{k}", 1, M, n, kk) for M in (512, 128)
       for k, n, kk in (("qkv", 2304, 768), ("attn_out", 768, 768),
                        ("ffn1", 3072, 768), ("ffn2", 768, 3072))]
    + [("chunk_pv", 32, 128, 128, 1024)]
    + [(f"decode_{k}", 1, 4, n, kk)
       for k, n, kk in (("qkv", 12288, 4096), ("attn_out", 4096, 4096),
                        ("gate_up", 22016, 4096), ("ffn_out", 4096, 11008),
                        ("head", 32000, 4096), ("bert_qkv", 2304, 768))]
    + [("decode_qk", 128, 1, 1024, 128), ("decode_pv", 128, 1, 128, 1024)])


def time_plans(gemm, smoke, device, only=""):
    """{shape: {launch: device ms}} of every launch of PLAN_SHAPES (those
    whose name matches the regular expression `only`), with the launch
    model's ms and the chosen launch; raises if any launch's output
    differs from the chosen one's in any bit."""
    import torch

    rows = {}
    for name, batch, M, N, K in PLAN_SHAPES:
        if not re.search(only, name):
            continue
        x = smoke.seeded((batch, M, K), 1, device)
        w = smoke.seeded((batch, K, N), 2, device)
        chosen = gemm.plan(batch, M, N, K)
        want = gemm.matmul(x, w)
        if chosen.kind == 0:
            launches = [gemm.Plan(0, cpt, cl) for cpt in (1, 4)
                        for cl in range(1, 9)
                        if (cpt == 1 or M <= 4) and cl <= gemm.chunks(K)]
        else:
            launches = [gemm.Plan(1, sp, 0) for sp in (1, 2, 3, 4, 8, 16)
                        if sp <= gemm.chunks(K)]
        launches += [chosen] * (chosen not in launches)
        got = {}
        for launch in launches:
            out = gemm.matmul(x, w, launch)
            if not torch.equal(out, want):
                raise AssertionError(f"{name}: launch {tuple(launch)} "
                                     f"differs from {tuple(chosen)}")
            ms = smoke.device_ms(lambda: gemm.matmul(x, w, launch), 3)
            model = (gemm.tiled_time(batch, M, N, K, launch.a) * 1e3
                     if launch.kind == 1 else None)
            got[str(tuple(launch))] = dict(device_ms=ms, model_ms=model)
        best = min(got, key=lambda k: got[k]["device_ms"])
        rows[name] = dict(chosen=str(tuple(chosen)), fastest=best,
                          launches=got)
        smoke.log(f"  {name} [{batch}, {M}, {N}, {K}]: chosen "
                  f"{tuple(chosen)} {got[str(tuple(chosen))]['device_ms']:.4f}"
                  f" ms, fastest {best} {got[best]['device_ms']:.4f} ms; "
                  + ", ".join(f"{k} {v['device_ms']:.4f}"
                              for k, v in got.items()))
        del x, w, want, out
    return rows


def attention16(fa, smoke, device):
    """{dtype: {kernel: {"sha256": [outputs' digests], "device_ms": ...}}}
    of the six kernels in bfloat16 and float16 at BERT's training shape
    (packed) and the Llama shape (unpacked, causal), on chip_smoke's
    seeded inputs; a dtype the checkout's wrappers refuse is "not
    supported"."""
    import math

    import torch

    rows = {}
    for dtype in ("bfloat16", "float16"):
        B, S, H, nh = 8, 512, 768, 12
        qkv, bias = smoke.make_inputs(B, S, H, "pad_dead_row", 17, device,
                                      dtype)
        try:
            fa.flash_attention_packed(qkv, bias, nh)
        except TypeError as e:
            rows[dtype] = f"not supported ({e})"
            continue
        out, lse, dout = smoke.backward_inputs(fa, qkv, bias, nh, False, 18)
        got, got_lse = fa.flash_attention_packed(qkv, bias, nh)
        scale = 1.0 / math.sqrt(H // nh)
        delta = fa.backward_delta(out, dout, nh)
        dqkv = torch.zeros_like(qkv)
        db = torch.zeros((B, nh, S), dtype=torch.float32, device=device)
        fa.flash_attention_packed_dkv(qkv, bias, dout, lse, delta, dqkv, db,
                                      nh, False, scale)
        dkv = (smoke.sha256(dqkv[..., H:]), smoke.sha256(db))
        fa.flash_attention_packed_dq(qkv, bias, dout, lse, delta, dqkv, nh,
                                     False, scale)
        r = {"packed_fwd": dict(sha256=[smoke.sha256(got), smoke.sha256(got_lse)],
                                device_ms=smoke.device_ms(
                                    lambda: fa.flash_attention_packed(
                                        qkv, bias, nh), 10)),
             "packed_dkv": dict(sha256=list(dkv), device_ms=smoke.device_ms(
                 lambda: fa.flash_attention_packed_dkv(
                     qkv, bias, dout, lse, delta, dqkv, db, nh, False,
                     scale), 10)),
             "packed_dq": dict(sha256=[smoke.sha256(dqkv[..., :H])],
                               device_ms=smoke.device_ms(
                                   lambda: fa.flash_attention_packed_dq(
                                       qkv, bias, dout, lse, delta, dqkv,
                                       nh, False, scale), 10))}
        q, k, v, _, dout = smoke.unpacked_inputs(1, 32, 2048, 2048, 128,
                                                 "none", True, 17, device,
                                                 dtype)
        out, lse = fa.flash_attention_unpacked(q, k, v, None, True)
        delta = (dout.float() * out.float()).sum(-1).contiguous()
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        scale = 1.0 / math.sqrt(128)
        fa.flash_attention_unpacked_dkv(q, k, v, None, dout, lse, delta, dk,
                                        dv, None, True, scale)
        fa.flash_attention_unpacked_dq(q, k, v, None, dout, lse, delta, dq,
                                       True, scale)
        r["unpacked_fwd"] = dict(sha256=[smoke.sha256(out), smoke.sha256(lse)],
                                 device_ms=smoke.device_ms(
                                     lambda: fa.flash_attention_unpacked(
                                         q, k, v, None, True), 5))
        r["unpacked_dkv"] = dict(sha256=[smoke.sha256(dk), smoke.sha256(dv)],
                                 device_ms=smoke.device_ms(
                                     lambda: fa.flash_attention_unpacked_dkv(
                                         q, k, v, None, dout, lse, delta, dk,
                                         dv, None, True, scale), 5))
        r["unpacked_dq"] = dict(sha256=[smoke.sha256(dq)],
                                device_ms=smoke.device_ms(
                                    lambda: fa.flash_attention_unpacked_dq(
                                        q, k, v, None, dout, lse, delta, dq,
                                        True, scale), 5))
        for name, row in r.items():
            smoke.log(f"  {dtype} {name}: {row['device_ms']:.5f} ms device, "
                      f"sha256 {[h[:16] for h in row['sha256']]}")
        rows[dtype] = r
        del qkv, bias, out, lse, dout, dqkv, q, k, v, dq, dk, dv
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", choices=("forward", "backward", "gemm",
                                       "rms_norm", "gemm_plans",
                                       "attention16"),
                    default="forward", help="which kernels to time")
    ap.add_argument("--checkout", default=HERE,
                    help="directory holding the paddle_tpu_torch to time")
    ap.add_argument("--only", default="",
                    help="gemm_plans: only the shapes matching this regex")
    ap.add_argument("--sdpa-sass", action="store_true",
                    help="count FFMA / HMMA in SDPA's backward kernels")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_fp32: no CUDA device", file=sys.stderr)
        return 2
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    if not os.path.abspath(fa.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"flash_attention imported from {fa.__file__}, "
                           f"not from {checkout}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smoke.log(f"timing the {args.what} kernels of {checkout}")
    if args.what == "attention16":
        rows = attention16(fa, smoke, device)
    elif args.what == "forward":
        rows = smoke.time_forward_f32(fa, device)
    elif args.what == "gemm":
        from paddle_tpu_torch.ops.cuda import gemm

        rows = smoke.time_gemm(gemm, device)
    elif args.what == "rms_norm":
        from paddle_tpu_torch.ops.cuda import rms_norm

        rows = smoke.time_rms_norm(rms_norm, device)
    elif args.what == "gemm_plans":
        from paddle_tpu_torch.ops.cuda import gemm

        rows = time_plans(gemm, smoke, device, args.only)
    else:
        lib = {"training": [], "llama": []}
        packed = smoke.time_backward(fa, device, "float32", lib["training"])
        unpacked = smoke.time_unpacked(fa, device, "float32", lib["llama"])
        rows = {"training_dkv": packed["dkv"], "training_dq": packed["dq"],
                "llama_dkv": unpacked["dkv"], "llama_dq": unpacked["dq"]}
        if args.sdpa_sass:
            from paddle_tpu_torch.ops.cuda import build

            cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()),
                                     "cuobjdump")
            names = sorted({k[0][0] for k in lib.values() if k})
            for name, ops in sass_ops(names, cuobjdump).items():
                smoke.log(f"  SASS (sm_90) of {name[:110]}: {ops}")
    print(smoke.card_line())
    print(json.dumps({"checkout": checkout, "what": args.what,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
