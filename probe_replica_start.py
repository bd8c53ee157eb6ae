#!/usr/bin/env python3
"""Where a BERT-base replica's start goes, and what two settings save.

    python3 probe_replica_start.py

Saves chip_smoke.py's BERT-base serving model (seq 128, fp32, 0.5 GB of
weights) twice, its ``__params__`` pickled with protocol 2 (the
reference's) and with protocol 5 (the port's), and starts one replica
(``python -m paddle_tpu_torch.serving.replica`` with phase 12's
arguments) on each, with and without a bytecode cache
(``PYTHONPYCACHEPREFIX``, ``PYTHONDONTWRITEBYTECODE`` unset, as
chip_smoke.py sets them), timing spawn to listening and spawn to the
first ready ``/healthz``.  Each setting starts two replicas one after
the other and reports the second (the first fills the cache where there
is one; the files it reads are then in the page cache in every
setting).  Then one replica of each extreme runs under ``cProfile``, and
the functions that take the most of its start are printed.  Also timed:
a bare ``import torch``, and ``import paddle_tpu_torch`` with the card's
context made, each with and without the cache.  The last line is one
JSON object with every time and the card's name and power limit.
Needs the card; builds the kernels first.
"""
import json
import os
import pickle
import pstats
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
READY_S = 300.0


def child_env(cache):
    """The environment as the machine gives it, or with bytecode written
    to and read from `cache` (chip_smoke.use_bytecode_cache's setting)."""
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("PYTHONPYCACHEPREFIX", None)
    if cache:
        env["PYTHONPYCACHEPREFIX"] = cache
        env.pop("PYTHONDONTWRITEBYTECODE", None)
    return env


def time_python(code, cache):
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], check=True, cwd=HERE,
                   env=child_env(cache))
    return time.perf_counter() - t0


def start(argv, workdir, tag, cache, profile=None):
    """Spawn one replica; (seconds to its endpoint file, seconds to its
    first ready /healthz).  SIGTERM and wait after."""
    endpoint = os.path.join(workdir, f"{tag}.json")
    cmd = [sys.executable, "-u"]
    if profile:
        cmd += ["-m", "cProfile", "-o", profile]
    cmd += ["-m", "paddle_tpu_torch.serving.replica",
            "--endpoint-file", endpoint, "--port", "0", *argv]
    env = dict(child_env(cache),
               FLAGS_metrics_dir=os.path.join(workdir, f"metrics_{tag}"))
    with open(os.path.join(workdir, f"{tag}.log"), "w") as logf:
        t0 = time.monotonic()
        proc = subprocess.Popen(cmd, env=env, stdout=logf, stderr=logf,
                                cwd=HERE)
    listening = ready = None
    try:
        while ready is None:
            if time.monotonic() - t0 > READY_S:
                raise RuntimeError(f"{tag}: not ready in {READY_S} s")
            if proc.poll() is not None:
                raise RuntimeError(f"{tag}: exited rc={proc.returncode} "
                                   f"(log {workdir}/{tag}.log)")
            if os.path.exists(endpoint):
                try:
                    with open(endpoint) as f:
                        url = json.load(f)["url"]
                except (OSError, ValueError, KeyError):
                    url = None
                if url is not None:
                    if listening is None:
                        listening = time.monotonic() - t0
                    try:
                        with urllib.request.urlopen(url + "/healthz",
                                                    timeout=5) as r:
                            if json.loads(r.read()).get("ready"):
                                ready = time.monotonic() - t0
                    except (OSError, ValueError):
                        pass
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        proc.wait(120)
    return listening, ready


def main():
    import torch

    if not torch.cuda.is_available():
        print("probe_replica_start: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.models import build_bert_serving
    from paddle_tpu_torch.ops.cuda import build

    res = {"card": smoke.card_line()}
    t0 = time.perf_counter()
    build.build_all()
    res["build_all_s"] = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="probe_replica_start_")
    try:
        main_p, startup = tpt.Program(), tpt.Program()
        startup._is_startup = True
        startup.random_seed = smoke.SERVE_SEEDS[0]
        with tpt.program_guard(main_p, startup):
            feed_names, outs = build_bert_serving(**smoke.SERVE_BERT)
        exe = tpt.Executor()
        model = os.path.join(work, "model_p5")
        with tpt.scope_guard(tpt.Scope()):
            exe.run(startup)
            tpt.io.save_inference_model(
                model, feed_names,
                [outs["encoder_out"], outs["mlm_argmax"]], exe,
                main_program=main_p)
        exe.close()
        models = {5: model, 2: os.path.join(work, "model_p2")}
        shutil.copytree(model, models[2])
        with open(os.path.join(model, "__params__"), "rb") as f:
            params = pickle.load(f)
        with open(os.path.join(models[2], "__params__"), "wb") as f:
            pickle.dump(params, f, protocol=2)
        res["params_bytes"] = {p: os.path.getsize(
            os.path.join(d, "__params__")) for p, d in models.items()}
        for p, d in models.items():
            t0 = time.perf_counter()
            with open(os.path.join(d, "__params__"), "rb") as f:
                pickle.load(f)
            res[f"unpickle_protocol_{p}_s"] = time.perf_counter() - t0
        del params

        cache = os.path.join(work, "pycache")
        for name, c in (("no_cache", None), ("cache", cache)):
            time_python("import torch", c)  # fills the cache
            res[f"import_torch_{name}_s"] = time_python("import torch", c)
            res[f"import_port_cuda_{name}_s"] = time_python(
                "import torch, paddle_tpu_torch; "
                "torch.zeros(1, device='cuda'); torch.cuda.synchronize()", c)

        def argv(protocol):
            out = ["--model-dir", models[protocol]]
            for n in feed_names:
                out += ["--shape", f"{n}={smoke.SERVE_BERT['seq_len']}"]
            return out + list(smoke.FLEET_SERVE_ARGV)

        res["replica"] = {}
        for protocol in (2, 5):
            for name, c in (("no_cache", None), ("cache", cache)):
                tag = f"protocol_{protocol}_{name}"
                start(argv(protocol), work, tag + "_first", c)
                listening, ready = start(argv(protocol), work, tag, c)
                res["replica"][tag] = dict(listening_s=listening,
                                           ready_s=ready)
                print(f"{tag}: listening {listening:.2f} s, ready "
                      f"{ready:.2f} s", flush=True)
        for protocol, name, c in ((2, "no_cache", None), (5, "cache", cache)):
            tag = f"protocol_{protocol}_{name}"
            prof = os.path.join(work, tag + ".prof")
            start(argv(protocol), work, tag + "_profiled", c, profile=prof)
            stats = pstats.Stats(prof, stream=sys.stdout)
            print(f"cProfile of one replica's start, {tag}:", flush=True)
            stats.sort_stats("cumulative").print_stats(40)
            stats.sort_stats("tottime").print_stats(25)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
