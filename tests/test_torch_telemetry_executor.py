"""The port executor's telemetry (framework/executor.py: the
``executor/step``, ``compile``, ``dispatch`` and ``fetch`` spans,
``note_step``, ``maybe_flush``) and the port's trace_export tool, on the
CPU.

* Twins of tests/test_telemetry.py:372-626: a 20-step TrainGuard run's
  four artifacts (trace.json with the executor's and the checkpoint's
  spans, dispatch spans parented by step spans; metrics.prom;
  events.jsonl's publishes at steps 10 and 20; heartbeat.json), the
  trace_export merges (one dir with its event markers and --filter /
  --no-events, two dirs as two track groups), resume telemetry,
  exporters under an injected metrics_write fault, FLAGS_telemetry=0
  doing no per-step work.  The heartbeat's device memory is None on the
  CPU: the port reads the cards' allocator, the reference jax's live
  arrays.
* Parity: ``python -m paddle_tpu_torch.tools.trace_export`` writes the
  same JSON (json.load-equal) as the reference script
  ``tools/trace_export.py`` from the same metrics dirs, for each of its
  modes.
* The executor's spans: one compile span for an entry's build, a step
  span a run parenting its dispatch, a fetch span for a numpy fetch and
  for a FetchHandle's first read; telemetry off then on through the
  executor.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch as tpt
from paddle_tpu_torch import fault, telemetry
from paddle_tpu_torch.monitor import stat_get
from paddle_tpu_torch.train_guard import TrainGuard

from torch_train_util import feed, net, started

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _telemetry_defaults():
    telemetry.clear_spans()  # earlier modules' executor runs leave spans
    yield
    tpt.set_flags({"FLAGS_telemetry": True, "FLAGS_metrics_dir": "",
                   "FLAGS_metrics_interval": 10.0,
                   "FLAGS_trace_buffer_size": 4096,
                   "FLAGS_histogram_buckets": "",
                   "FLAGS_fault_inject": ""})
    fault.reset()
    telemetry.clear_spans()


def _trainguard_run(tmp_path, steps=20):
    mdir = str(tmp_path / "metrics")
    tpt.set_flags({"FLAGS_metrics_dir": mdir,
                   "FLAGS_metrics_interval": 0.0})  # flush every step
    telemetry.clear_spans()
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main,
                   checkpoint_dir=str(tmp_path / "ckpts"),
                   interval_steps=10, handle_sigterm=False)
    for i in range(steps):
        g.step(feed(i), fetch_list=[loss], scope=scope)
    g.close()
    return mdir


def _export(tool, args, cwd=REPO):
    """Run a trace_export (the reference script's path, or the port's
    module) and return its completed process."""
    cmd = [sys.executable] + (
        [os.path.join(REPO, "tools", "trace_export.py")] if tool == "jax"
        else ["-m", "paddle_tpu_torch.tools.trace_export"]) + list(args)
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          cwd=cwd)


# ---------------------------------------------------------------------------
# the acceptance run: 20-step TrainGuard with telemetry on
# ---------------------------------------------------------------------------

def test_trainguard_run_produces_all_four_artifacts(tmp_path):
    mdir = _trainguard_run(tmp_path)

    # 1. Perfetto-loadable trace JSON
    with open(os.path.join(mdir, "trace.json")) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    assert isinstance(events, list) and events
    for e in events:
        assert {"ph", "name", "ts", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0
    names = {e["name"] for e in events}
    assert {"executor/step", "executor/dispatch", "executor/fetch",
            "executor/compile", "ckpt/write", "ckpt/publish",
            "train_guard/resume"} <= names
    # the step spans parent the dispatch spans
    steps = {e["args"]["span_id"] for e in events
             if e["name"] == "executor/step"}
    dparents = {e["args"]["parent_id"] for e in events
                if e["name"] == "executor/dispatch"}
    assert dparents <= steps

    # 2. Prometheus textfile
    with open(os.path.join(mdir, "metrics.prom")) as f:
        prom = f.read()
    assert "# TYPE paddle_tpu_executor_run_steps counter" in prom
    assert "paddle_tpu_executor_step_host_ms_count" in prom
    assert "# TYPE paddle_tpu_examples_per_sec gauge" in prom
    assert "paddle_tpu_checkpoint_bytes_written" in prom

    # 3. JSONL event log
    with open(os.path.join(mdir, "events.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    kinds = {r["event"] for r in recs}
    assert "ckpt_publish" in kinds
    publishes = [r for r in recs if r["event"] == "ckpt_publish"]
    assert all(r["bytes"] > 0 and "ts" in r and r["pid"] == os.getpid()
               and r["format"] == "pkl" for r in publishes)
    assert {r["step"] for r in publishes} == {10, 20}

    # 4. heartbeat
    with open(os.path.join(mdir, "heartbeat.json")) as f:
        hb = json.load(f)
    assert hb["pid"] == os.getpid()
    assert hb["step"] >= 20
    assert hb["last_step_ms"] is not None and hb["last_step_ms"] >= 0
    assert hb["examples_per_sec"] is not None \
        and hb["examples_per_sec"] > 0
    assert hb["device_memory"] is None  # no card: the CPU reports none
    assert hb["uptime_s"] >= 0

    # step-duration histogram saw every step
    s = telemetry.metrics.histogram("executor_step_host_ms").summary()
    assert s["count"] >= 20


def test_trace_export_tool_merges_spans_and_events(tmp_path):
    mdir = _trainguard_run(tmp_path)
    out = str(tmp_path / "perfetto.json")
    r = _export("port", [mdir, out])
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    assert "executor/step" in names
    assert "event/ckpt_publish" in names  # events.jsonl markers merged
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert ts == sorted(ts)
    # --filter narrows to one subsystem
    r = _export("port", [mdir, out, "--filter", "ckpt/", "--no-events"])
    assert r.returncode == 0, r.stdout + r.stderr
    with open(out) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    assert all(e["name"].startswith("ckpt/") or e.get("ph") == "C"
               for e in doc["traceEvents"])
    assert any(e["name"].startswith("ckpt/") for e in doc["traceEvents"])


def _serving_dir(tmp_path):
    """A second metrics dir shaped as a replica's: a request span tree,
    a sequence span and a slot-occupancy counter track."""
    serve_dir = str(tmp_path / "serving_metrics")
    telemetry.clear_spans()
    root = telemetry.span_begin("serving/request", detached=True)
    with telemetry.trace_span("serving/queue_wait", parent=root.context()):
        pass
    telemetry.span_end(root)
    seq = telemetry.span_begin("generation/sequence", detached=True,
                               slot=0, prompt_len=4)
    telemetry.span_end(seq)
    telemetry.counter_sample("generation_slots",
                             {"slot0": 1.0, "slot1": 0.0, "active": 1.0})
    os.makedirs(serve_dir, exist_ok=True)
    telemetry.export_chrome_trace(os.path.join(serve_dir, "trace.json"))
    return serve_dir


def test_trace_export_merges_multiple_metrics_dirs(tmp_path):
    """--metrics-dir twice (a trainer dir and a serving dir): one
    Perfetto file, one process track group per source, spans keeping
    their trace_id args."""
    train_dir = _trainguard_run(tmp_path)
    serve_dir = _serving_dir(tmp_path)
    out = str(tmp_path / "merged.json")
    r = _export("port", ["--metrics-dir", train_dir, "--metrics-dir",
                         serve_dir, out])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "2 source(s)" in r.stdout
    with open(out) as f:
        evs = json.load(f)["traceEvents"]
    meta = [e for e in evs if e.get("ph") == "M"
            and e["name"] == "process_name"]
    assert len(meta) == 2
    labels = {e["pid"]: e["args"]["name"] for e in meta}
    assert any("serving_metrics" in v for v in labels.values())
    pids_by_name = {}
    for e in evs:
        if e.get("ph") != "M":
            pids_by_name.setdefault(e["name"], set()).add(e["pid"])
    assert pids_by_name["executor/step"] == {1}
    assert pids_by_name["serving/request"] == {2}
    assert pids_by_name["generation/sequence"] == {2}
    assert pids_by_name["generation_slots"] == {2}
    slots = [e for e in evs if e["name"] == "generation_slots"]
    assert slots and all(e["ph"] == "C" for e in slots)
    assert slots[0]["args"] == {"slot0": 1.0, "slot1": 0.0,
                                "active": 1.0}
    sv = [e for e in evs
          if e["name"] in ("serving/request", "serving/queue_wait")]
    assert len({e["args"]["trace_id"] for e in sv}) == 1
    ts = [e["ts"] for e in evs if e.get("ph") != "M"]
    assert ts == sorted(ts)


@pytest.mark.parametrize("mode", ["one_dir", "filtered", "two_dirs"])
def test_trace_export_writes_the_reference_scripts_json(tmp_path, mode):
    """The port's tool and the reference script, on the same metrics
    dirs with the same arguments, write json.load-equal files (tolerance
    0) and print the same summary."""
    train_dir = _trainguard_run(tmp_path)
    args = {"one_dir": [train_dir],
            "filtered": [train_dir, "--filter", "executor/",
                         "--no-events"],
            "two_dirs": ["--metrics-dir", train_dir, "--metrics-dir",
                         _serving_dir(tmp_path)]}[mode]
    docs, said = [], []
    for tool in ("jax", "port"):
        out = str(tmp_path / f"{tool}.json")
        a = list(args)
        a.insert(1 if mode != "two_dirs" else len(a), out)
        r = _export(tool, a)
        assert r.returncode == 0, r.stdout + r.stderr
        said.append(r.stdout.replace(out, "OUT"))
        with open(out) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    assert said[0] == said[1]
    assert docs[0]["traceEvents"]


def test_resume_telemetry(tmp_path):
    mdir = _trainguard_run(tmp_path)
    # a second guard (fresh programs) over the same dir resumes + reports
    main2, startup2, loss, _ = net()
    exe, _scope = started(main2, startup2, scope=tpt.global_scope())
    g = TrainGuard(exe, loss, program=main2,
                   checkpoint_dir=str(tmp_path / "ckpts"),
                   interval_steps=10, handle_sigterm=False)
    assert g.resumed_step == 20
    g.close()
    assert telemetry.metrics.gauge("train_guard_resume_ms").get() > 0
    with open(os.path.join(mdir, "events.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    resumes = [r for r in recs if r["event"] == "resume"]
    assert resumes and resumes[-1]["step"] == 20
    assert any(r["event"] == "ckpt_resume" for r in recs)
    names = {s.name for s in telemetry.get_spans()}
    assert {"train_guard/resume", "ckpt/restore"} <= names


# ---------------------------------------------------------------------------
# fault tolerance: exporters must never raise into the training loop
# ---------------------------------------------------------------------------

def test_exporters_survive_injected_io_fault(tmp_path):
    mdir = str(tmp_path / "m")
    tpt.set_flags({"FLAGS_metrics_dir": mdir})
    fault.configure("metrics_write:raise@1+")
    w0 = stat_get("telemetry_write_failures")
    d0 = stat_get("telemetry_events_dropped")
    telemetry.flush()                      # prometheus + heartbeat + trace
    telemetry.log_event("probe", x=1)
    assert stat_get("telemetry_write_failures") >= w0 + 3
    assert stat_get("telemetry_events_dropped") == d0 + 1
    assert not os.path.exists(os.path.join(mdir, "metrics.prom"))
    assert not os.path.exists(os.path.join(mdir, "events.jsonl"))

    # the training loop itself is unaffected: a full run still completes
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    out = exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()
    fault.configure("")
    telemetry.flush()
    assert os.path.isfile(os.path.join(mdir, "metrics.prom"))


# ---------------------------------------------------------------------------
# FLAGS_telemetry=0: no spans, no metrics, no files, no per-step work
# ---------------------------------------------------------------------------

def test_telemetry_off_emits_nothing(tmp_path):
    mdir = str(tmp_path / "m")
    telemetry.clear_spans()
    tpt.set_flags({"FLAGS_telemetry": 0, "FLAGS_metrics_dir": mdir,
                   "FLAGS_metrics_interval": 0.0})
    h0 = telemetry.metrics.histogram("executor_step_host_ms").summary()
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    g = TrainGuard(exe, loss, program=main,
                   checkpoint_dir=str(tmp_path / "ckpts"),
                   interval_steps=10, handle_sigterm=False)
    for i in range(20):
        g.step(feed(i), fetch_list=[loss], scope=scope)
    g.close()
    assert telemetry.get_spans() == []
    h1 = telemetry.metrics.histogram("executor_step_host_ms").summary()
    assert h1["count"] == h0["count"]
    assert not os.path.exists(mdir)
    assert telemetry.log_event("x") is None
    assert telemetry.write_prometheus() is None \
        and not os.path.exists(mdir)
    # spans collapse to one shared no-op singleton: no allocation
    assert telemetry.trace_span("a") is telemetry.trace_span("b")
    assert telemetry.span_begin("a") is None


def test_telemetry_off_then_on_through_the_executor():
    """Runs with telemetry off leave no span; the first run after it is
    turned on opens its step, dispatch and fetch spans."""
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    tpt.set_flags({"FLAGS_telemetry": 0})
    telemetry.clear_spans()
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    assert telemetry.get_spans() == []
    tpt.set_flags({"FLAGS_telemetry": 1})
    exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    names = [s.name for s in telemetry.get_spans()]
    assert names.count("executor/step") == 1
    assert {"executor/dispatch", "executor/fetch"} <= set(names)


# ---------------------------------------------------------------------------
# the executor's spans
# ---------------------------------------------------------------------------

def test_executor_spans_per_run():
    main, startup, loss, _ = net()
    exe, scope = started(main, startup)
    telemetry.clear_spans()
    for _ in range(3):
        exe.run(main, feed=feed(), fetch_list=[loss], scope=scope)
    h = exe.run_async(main, feed=feed(), fetch_list=[loss], scope=scope)
    spans = telemetry.get_spans()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert len(by["executor/compile"]) == 1  # one entry built
    assert len(by["executor/step"]) == len(by["executor/dispatch"]) == 4
    steps = {s.span_id: s for s in by["executor/step"]}
    for d in by["executor/dispatch"]:
        assert d.parent_id in steps
        assert d.attrs["step"] == steps[d.parent_id].attrs["step"]
        assert d.attrs["guarded"] is False
    assert [s.attrs["step"] for s in by["executor/step"]] == [2, 3, 4, 5]
    assert len(by["executor/fetch"]) == 3  # the numpy fetches
    float(h[0])                             # a handle's first read
    fetches = [s for s in telemetry.get_spans()
               if s.name == "executor/fetch"]
    assert len(fetches) == 4 and fetches[-1].attrs["step"] == 5
    float(h[0])                             # the second read is free
    assert len([s for s in telemetry.get_spans()
                if s.name == "executor/fetch"]) == 4
