#!/usr/bin/env python3
"""Does a phase that runs before chip_smoke.py's phase 15 make its
profiles lose kernel records?

    python3 probe_profile_records.py [--checkout DIR] [--phases 9,16,15]

Imports ``paddle_tpu_torch`` and ``chip_smoke.py`` from DIR (default:
this script's directory), builds the kernels there, and runs the named
phases of that checkout's chip_smoke.py in the order given, in one
process: 9 (Llama-2-7B-width training in bf16), 16 (float16 AMP, where
the checkout has it; it needs 9 before it) and 15 (recompute).  A phase
that fails is logged and the next one runs.  Each profiled replay logs
its profiles' kernel records and launches as chip_smoke.py does; the
last line is one JSON object: the card's name and power limit, each
phase's seconds and error, every profile's device numbers and lost
records (PROFILES), and phase 16's numbers (FP16) where it ran.
"""
import argparse
import importlib.util
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkout", default=HERE,
                    help="directory holding paddle_tpu_torch and "
                         "chip_smoke.py")
    ap.add_argument("--phases", default="9,15",
                    help="chip_smoke.py phases to run, in order (9, 15, 16)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_profile_records: no CUDA device", file=sys.stderr)
        return 2
    checkout = os.path.abspath(args.checkout)
    sys.path.insert(0, checkout)
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.cuda import build, gemm, rms_norm
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    if not os.path.abspath(tpt.__file__).startswith(checkout + os.sep):
        raise RuntimeError(f"paddle_tpu_torch imported from {tpt.__file__},"
                           f" not from {checkout}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(checkout, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = smoke.card_line()
    smoke.log(f"probing {checkout}, phases {args.phases}, on {card}")
    t0 = time.perf_counter()
    build.build_all()
    fa._lib()
    fa._bwd_lib()
    gemm._lib()
    rms_norm._lib()
    smoke.log(f"built in {time.perf_counter() - t0:.1f} s")

    phases, llama = {}, None
    for phase in args.phases.split(","):
        t = time.perf_counter()
        smoke.log(f"[phase {phase}]")
        try:
            if phase == "9":
                seed = registry._OP_SEED[0]
                _, losses = smoke.llama_flagship(tpt, fa)
                llama = (seed, losses)
            elif phase == "16":
                smoke.fp16_flagship(tpt, fa, *llama)
            elif phase == "15":
                smoke.recompute_flagship(tpt, fa, device)
            else:
                raise ValueError(f"no phase {phase} here")
            error = None
        except Exception as e:  # logged, and the next phase runs
            traceback.print_exc()
            error = f"{type(e).__name__}: {e}"[:2000]
        phases[phase] = dict(seconds=time.perf_counter() - t, error=error)
        smoke.log(f"  phase {phase}: {phases[phase]}")
    print(json.dumps(dict(checkout=checkout, card=card, phases=phases,
                          profiles=smoke.PROFILES,
                          fp16=getattr(smoke, "FP16", None)),
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
