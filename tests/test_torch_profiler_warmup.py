"""A replica on the card starts and stops torch.profiler once before it
reports ready (``observatory.warm_profiler``), so that no ``/profilez``
capture under traffic is its process's first profiler start: the first
start is the slow one, and under traffic it took several times longer
than idle and once silenced a replica for minutes.

* ``replica.warm_up`` (what a replica runs once its listener is up)
  warms the profiler on the card before the engine's warmup flips
  ``ready``, and not on the CPU; a capture after a warm-up still
  answers with its trace, and a spawned CPU replica reports ready with
  no warm-up.
* ``warm_profiler`` is single-flight with the captures and leaves the
  capture mark (the fleet watchdog's waiver) only while it runs; with
  telemetry off it does nothing.
* The profiler starts and stops with every engine held at its boundary
  (``observatory.quiesced``): a serving engine between batches, a
  generation engine between grid steps.
"""
import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import observatory
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.serving import FleetSupervisor, replica
from torch_fleet_util import TINY_ARGV


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_a_replica_warms_its_profiler_before_it_reports_ready(tmp_path,
                                                             monkeypatch,
                                                             device):
    """replica.warm_up on a card device warms the profiler once, while
    the engine is not ready yet, then readies it; on the CPU it readies
    the engine alone.  (The device only picks the order's steps: the
    warm-up itself runs here on the CPU.)"""
    from torch_fleet_util import synthetic

    from paddle_tpu_torch.serving import ServingEngine

    predictor, shapes = synthetic()
    eng = ServingEngine(predictor, workers=1, max_batch=2, max_delay_ms=1.0,
                        deadline_ms=60000.0, ready_requires_warmup=True)
    ready_at_warm = []
    real = observatory.warm_profiler

    def warm():
        ready_at_warm.append(eng.ready())
        return real()

    monkeypatch.setattr(observatory, "warm_profiler", warm)
    set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    try:
        assert not eng.ready()
        replica.warm_up(eng, shapes, None, torch.device(device))
        assert eng.ready()
        assert ready_at_warm == ([False] if device == "cuda" else [])
        # a capture after the warm-up still answers with its trace
        out = observatory.capture_profile(0.05)
        assert "trace.json" in out["files"], out
    finally:
        set_flags({"FLAGS_metrics_dir": ""})
        eng.close()


def test_a_cpu_replica_reports_ready_without_a_warm_up(tmp_path):
    """A spawned replica on the CPU logs no warm-up, and its first
    capture still answers with its trace."""
    sup = FleetSupervisor(replicas=1, workdir=str(tmp_path),
                          replica_argv=list(TINY_ARGV))
    try:
        url = sup.wait_ready(240)[0]
        with open(sup._replicas[0].log_path, errors="replace") as f:
            lines = f.read().splitlines()
        assert any("ready (buckets primed)" in ln for ln in lines), \
            lines[-20:]
        assert not any(observatory.WARMUP_LOG + ":" in ln for ln in lines)
        with urllib.request.urlopen(url + "/profilez?sec=0.2",
                                    timeout=120) as r:
            doc = json.loads(r.read())
        assert r.status == 200 and "trace.json" in doc["files"], doc
    finally:
        sup.close()


def test_warm_profiler_is_single_flight_and_marked(tmp_path, monkeypatch):
    set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    seen = []
    real = observatory._mark_capture

    def mark(sec):
        path = real(sec)
        seen.append((path, os.path.exists(path)))
        return path

    monkeypatch.setattr(observatory, "_mark_capture", mark)
    try:
        took = observatory.warm_profiler()
        assert isinstance(took, float) and took >= 0
        (path, existed), = seen
        assert existed and not os.path.exists(path)
        observatory._capture_active[0] = True
        try:
            with pytest.raises(observatory.CaptureBusy):
                observatory.warm_profiler()
        finally:
            observatory._capture_active[0] = False
        set_flags({"FLAGS_telemetry": False})
        assert observatory.warm_profiler() is None
    finally:
        set_flags({"FLAGS_telemetry": True, "FLAGS_metrics_dir": ""})


def test_a_capture_starts_and_stops_with_every_engine_held(tmp_path,
                                                          monkeypatch):
    """capture_profile starts and stops the profiler inside
    ``observatory.quiesced``: every registered quiescer is entered twice
    a capture (start, stop) and once a warm-up."""
    import contextlib

    entered = []

    @contextlib.contextmanager
    def quiescer():
        entered.append(1)
        yield

    monkeypatch.setattr(observatory, "_quiescers", [quiescer])
    set_flags({"FLAGS_metrics_dir": str(tmp_path)})
    try:
        observatory.capture_profile(0.05)
        assert len(entered) == 2
        observatory.warm_profiler()
        assert len(entered) == 3
    finally:
        set_flags({"FLAGS_metrics_dir": ""})


def test_serving_engine_holds_dispatch_while_quiesced():
    """A request submitted while the engine is held waits for the hold's
    end; the engine registers its quiescer while it runs and drops it at
    close."""
    from torch_fleet_util import synthetic

    from paddle_tpu_torch.serving import ServingEngine

    predictor, shapes = synthetic()
    eng = ServingEngine(predictor, workers=1, max_batch=2,
                        max_delay_ms=1.0, deadline_ms=60000.0)
    eng.warmup(shapes)
    try:
        assert eng.quiesced in observatory._quiescers
        x = {"x": np.ones((1, 4), "float32")}
        eng.submit(x).result(timeout=60)
        with eng.quiesced():
            fut = eng.submit(x)
            time.sleep(0.3)
            assert not fut.done()
        fut.result(timeout=60)
    finally:
        eng.close()
    assert eng.quiesced not in observatory._quiescers


def test_generation_engine_parks_between_steps_while_quiesced():
    """The generation scheduler parks at a step boundary while held (a
    request in flight decodes on after it), and its quiescer comes and
    goes with the engine."""
    from paddle_tpu_torch.ops.registry import reset_op_seed
    from paddle_tpu_torch.serving import GenerationEngine

    reset_op_seed()
    gen = GenerationEngine(
        dict(vocab_size=61, hidden=32, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate=64), max_seq_len=48,
        max_new_tokens=6, attn_impl="xla", seed=0, device="cpu")
    try:
        fut = gen.submit([3, 5, 7], 6)
        assert gen.quiesced in observatory._quiescers
        with gen.quiesced():
            assert gen._parked
            steps = gen._n["decode_steps"]
            time.sleep(0.2)
            assert gen._n["decode_steps"] == steps
        assert len(fut.result(timeout=120)["tokens"]) == 6
    finally:
        gen.close()
    assert gen.quiesced not in observatory._quiescers
