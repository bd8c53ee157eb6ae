#!/usr/bin/env python3
"""Times the fp32 attention kernels of one checkout on one card.

    python3 time_fp32.py [--what {forward,backward}] [--checkout DIR]
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
the plain version.  Prints the card's name and power limit, then one
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", choices=("forward", "backward"),
                    default="forward", help="which fp32 kernels to time")
    ap.add_argument("--checkout", default=HERE,
                    help="directory holding the paddle_tpu_torch to time")
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
    smoke.log(f"timing the fp32 {args.what} of {checkout}")
    if args.what == "forward":
        rows = smoke.time_forward_f32(fa, device)
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
