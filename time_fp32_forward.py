#!/usr/bin/env python3
"""Times the fp32 attention forward kernel of one checkout on one card.

    python3 time_fp32_forward.py [--checkout DIR]

Imports ``paddle_tpu_torch`` from DIR (default: the directory of this
script), builds its forward kernel there, and runs chip_smoke.py's
``time_forward_f32`` (from this script's directory) on it: BERT-base
serving at batch 1, 4 and 8, BERT's training shape and the Llama shape
(causal), each the kernel's event time of back-to-back calls and its
device time under torch.profiler, beside scaled_dot_product_attention's
and the bound, each result held to the plain version.  Prints the card's
name and power limit, then one JSON line {"checkout": DIR, "rows": ...}.

Two checkouts compare fairly only inside one machine session: run the
script for each in turns (parent, change, change, parent).  It needs a
CUDA device and exits non-zero without one.
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", default=HERE,
                    help="directory holding the paddle_tpu_torch to time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_fp32_forward: no CUDA device", file=sys.stderr)
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
    smoke.log(f"timing the fp32 forward of {checkout}")
    rows = smoke.time_forward_f32(fa, torch.device("cuda", 0))
    print(smoke.card_line())
    print(json.dumps({"checkout": checkout, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
