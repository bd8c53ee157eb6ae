"""The port's profiler.py (on torch.profiler) and memory.py (on the CUDA
caching allocator's stats), on the CPU.

* Twins of tests/test_observability.py:32 and :58: a profiled training
  run's trace is saved, loads, and its table names the ``RecordEvent``
  region; a failed stop does not wedge the next start; a second start
  raises "profiler already running".
* Twins of tests/test_memory.py: the stats surface with the CPU named
  (``device="cpu"``: zeros, as the reference reports a backend without
  allocator stats; no device and no card raises, as every port entry
  point does), the peak window, the strategy knob's round trip and
  validation (it warns once the CUDA allocator is up; here a stand-in
  says it is), the flags.
* Card-only (``-m cuda``, skipped here): the stats equal torch.cuda's,
  and the peak drops after ``reset_peak``.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
from paddle_tpu_torch import memory
from paddle_tpu_torch import profiler as prof



def started(main, startup):
    scope = tpt.Scope()
    exe = tpt.Executor(tpt.CPUPlace())
    exe.run(startup, scope=scope)
    return exe, scope


# ---------------------------------------------------------------------------
# profiler.py
# ---------------------------------------------------------------------------

def test_profiler_trace_saved_and_loadable(tmp_path):
    tpt.reset_unique_name()
    main, startup = tpt.Program(), tpt.Program()
    startup._is_startup = True
    with tpt.program_guard(main, startup):
        x = tpt.layers.data("x", [4])
        h = tpt.layers.fc(x, 8, act="relu")
        loss = tpt.layers.mean(h)
        tpt.optimizer.SGDOptimizer(0.1).minimize(loss)
    exe, scope = started(main, startup)
    xv = np.random.rand(8, 4).astype("float32")
    exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)

    d = str(tmp_path / "trace")
    with prof.profiler(trace_dir=d):
        with prof.RecordEvent("bench_step"):
            for _ in range(3):
                exe.run(main, feed={"x": xv}, fetch_list=[loss],
                        scope=scope)

    trace = prof.load_trace(d)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "bench_step" in names  # our annotation is on the timeline
    table = prof.summarize_trace(d, "total")
    assert "bench_step" in table and "Total(ms)" in table
    for key in ("calls", "ave"):
        assert "bench_step" in prof.summarize_trace(d, key, top=1000)


def test_stop_profiler_failure_does_not_wedge(monkeypatch, tmp_path):
    """A failed stop must still clear the session: leaving it set would
    wedge start_profiler with 'profiler already running'."""
    started_dirs = []

    class Session:
        fail = True

        def __init__(self, activities):
            pass

        def start(self):
            started_dirs.append(True)

        def stop(self):
            if Session.fail:
                raise RuntimeError("trace flush failed")

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                f.write('{"traceEvents": []}')

    monkeypatch.setattr(torch.profiler, "profile", Session)
    prof.start_profiler(trace_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="already running"):
        prof.start_profiler(trace_dir=str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="trace flush failed"):
        prof.stop_profiler()
    # not wedged: the next session starts and stops cleanly
    Session.fail = False
    prof.start_profiler(trace_dir=str(tmp_path / "b"))
    assert prof.stop_profiler() == str(tmp_path / "b")
    assert len(started_dirs) == 2
    assert prof.load_trace(str(tmp_path / "b")) == {"traceEvents": []}
    assert prof.stop_profiler() is None  # nothing running


# ---------------------------------------------------------------------------
# memory.py
# ---------------------------------------------------------------------------

def test_stats_api_shape():
    stats = memory.memory_stats("cpu")
    assert stats == {}
    for fn in (memory.memory_allocated, memory.max_memory_allocated,
               memory.memory_reserved, memory.device_memory_capacity):
        v = fn("cpu")
        assert isinstance(v, int) and v == 0
    assert memory.memory_allocated(tpt.CPUPlace()) == 0


def test_no_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None names it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory.memory_allocated()


def test_reset_peak_monotone():
    memory.reset_peak("cpu")
    raw = memory.memory_stats("cpu").get("allocated_bytes.all.peak", 0)
    assert 0 <= memory.max_memory_allocated("cpu") <= max(raw, 0)


def test_strategy_roundtrip_and_validation(monkeypatch):
    old = memory.get_allocator_strategy()
    old_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    fractions = []
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f: fractions.append(f))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        # before the allocator is up: configured, no warning
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        memory.set_allocator_strategy("auto_growth")
        assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
            "expandable_segments:True"
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        with pytest.warns(UserWarning, match="next process"):
            memory.set_allocator_strategy("naive_best_fit",
                                          memory_fraction=0.5)
        assert memory.get_allocator_strategy() == "naive_best_fit"
        assert tpt.get_flags("FLAGS_fraction_of_gpu_memory_to_use") == {
            "FLAGS_fraction_of_gpu_memory_to_use": 0.5}
        assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
            "expandable_segments:False"
        assert fractions == [0.5]
        with pytest.raises(ValueError):
            memory.set_allocator_strategy("best_fit_with_coalescing")
    finally:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
        memory.set_allocator_strategy(old)
        tpt.set_flags({"FLAGS_fraction_of_gpu_memory_to_use": 0.92})
        if old_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old_conf


def test_flags_registered():
    got = tpt.get_flags(["FLAGS_allocator_strategy",
                         "FLAGS_fraction_of_gpu_memory_to_use",
                         "FLAGS_checkpoint_retries",
                         "FLAGS_checkpoint_retry_backoff_s"])
    assert got == {"FLAGS_allocator_strategy": "auto_growth",
                   "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
                   "FLAGS_checkpoint_retries": 2,
                   "FLAGS_checkpoint_retry_backoff_s": 0.05}


@pytest.mark.cuda
def test_stats_follow_the_caching_allocator():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    assert memory.memory_allocated() == torch.cuda.memory_allocated()
    assert memory.max_memory_allocated() == \
        torch.cuda.max_memory_allocated()
    assert memory.memory_reserved() >= memory.memory_allocated() > 0
    assert memory.device_memory_capacity() > 0
    peak = memory.max_memory_allocated()
    del x
    memory.reset_peak()
    assert memory.max_memory_allocated() < peak
