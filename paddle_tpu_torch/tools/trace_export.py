#!/usr/bin/env python
"""Export paddle_tpu_torch telemetry as one Perfetto-loadable trace.

The port's copy of ``tools/trace_export.py``, run as ``python -m
paddle_tpu_torch.tools.trace_export``: the same merge, options and output,
byte for byte the JSON the reference script writes from the same metrics
dirs, over the port's ``FLAGS_metrics_dir`` artifacts.

Merges one or more ``FLAGS_metrics_dir``s' artifacts into a single
chrome://tracing / Perfetto JSON file:

* ``trace.json`` — the span ring (``executor/step``, ``ckpt/write``,
  ``serving/request``, ...) exported by paddle_tpu_torch/telemetry.py,
  passed through after validation;
* ``events.jsonl`` — the structured event log, converted to instant
  ('i'-phase) events so checkpoint publishes, guard skips, resumes, and
  SIGTERMs show as markers on the same timeline.

With repeated ``--metrics-dir`` arguments (e.g. a trainer dir and a
serving dir), each source gets its own Perfetto process track group: a
synthetic pid per source plus a ``process_name`` metadata event naming
it, so two runs' (or the same process's two subsystems') spans stay
visually separate but share one wall-clock timeline.  Spans keep their
``trace_id`` args — a serving request found in ``/tracez`` or the
access log is findable by id in the merged view.

Usage::

    python -m paddle_tpu_torch.tools.trace_export <metrics_dir | trace.json> [out.json]
    python -m paddle_tpu_torch.tools.trace_export --metrics-dir A --metrics-dir B [out.json]
        [--metrics-dir DIR]   source dir (repeatable; when given, a
                              lone positional arg is the OUTPUT path)
        [--filter SUBSTR]     keep only spans whose name contains SUBSTR
                              (counter tracks and metadata always pass:
                              a filtered view keeps its occupancy/HBM
                              context)
        [--no-events]         skip the events.jsonl markers

Counter tracks ride along: the span ring's 'C'-phase samples — the
HBM timeline, the generation engine's per-slot occupancy track
(``generation_slots``) — merge with the spans, re-pidded per source
like everything else.

Postmortems ride along too: a source dir's ``postmortem/*.json``
flight-recorder dumps (paddle_tpu_torch/blackbox.py) each carry the dead
process's final span ring under ``trace_events``.  Every dead pid
becomes one more process track group — labelled with the pid and the
death reason.  A crash/exception dump supersedes the cadence
``rolling`` dump from the same life; a ring whose pid is already on the
source's own trace.json timeline is skipped; torn dumps are skipped with
a warning, never fatal.

Load the output in https://ui.perfetto.dev (or chrome://tracing).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def load_span_events(trace_path: str) -> list:
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise SystemExit(f"{trace_path}: not a chrome trace "
                         f"(no traceEvents list)")
    bad = [e for e in events
           if not isinstance(e, dict) or "name" not in e or "ph" not in e]
    if bad:
        raise SystemExit(f"{trace_path}: {len(bad)} malformed trace "
                         f"event(s), e.g. {bad[0]!r}")
    return events


def load_event_markers(jsonl_path: str) -> list:
    """events.jsonl lines -> instant events on the merged timeline.

    Malformed lines are skipped with a warning, not fatal: a crashed
    run leaves a torn final append, and the post-mortem tool must keep
    working exactly then."""
    markers = []
    with open(jsonl_path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                print(f"warning: {jsonl_path}:{lineno}: skipping bad "
                      f"JSON line (torn write?): {e}", file=sys.stderr)
                continue
            markers.append({
                "ph": "i", "s": "p",
                "name": f"event/{rec.get('event', 'unknown')}",
                "cat": "paddle_tpu.events",
                "pid": rec.get("pid", 0), "tid": 0,
                "ts": float(rec.get("ts", 0.0)) * 1e6,
                "args": rec,
            })
    return markers


def _filter_spans(events: list, name_filter: str) -> list:
    # the name filter narrows SPANS; counter tracks ('C': per-slot
    # occupancy, the HBM timeline) and metadata ('M') survive any
    # filter — a filtered view without its counter context is how
    # "the grid looked idle" misreadings happen
    if not name_filter:
        return events
    return [e for e in events
            if e.get("ph") in ("C", "M")
            or name_filter in e.get("name", "")]


def load_postmortems(pm_dir: str, name_filter: str = "",
                     exclude_pids=()) -> list:
    """``postmortem/*.json`` flight-recorder dumps -> one extra track
    group per dead pid.  Each dump carries the dead process's final
    span ring under ``trace_events``; a crash/exception dump
    supersedes the cadence ``rolling`` dump from the same life, so
    each dead pid contributes exactly one ring.  ``exclude_pids``
    drops rings whose pid is already on the source's own timeline (a
    live run's rolling dump mirrors its trace.json — merging it would
    duplicate every span).  Unreadable (torn) dumps are skipped with
    a warning — the export must keep working exactly when processes
    died mid-write."""
    by_pid = {}
    exclude = set(exclude_pids)
    for path in sorted(glob.glob(os.path.join(pm_dir, "*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"warning: {path}: skipping unreadable postmortem "
                  f"(torn write?): {e}", file=sys.stderr)
            continue
        events = doc.get("trace_events")
        if not isinstance(events, list):
            continue
        pid = doc.get("pid") or 0
        if pid in exclude:
            continue
        reason = doc.get("reason", "unknown")
        prev = by_pid.get(pid)
        if prev is not None and reason == "rolling" \
                and prev["reason"] != "rolling":
            continue
        spans = _filter_spans(
            [e for e in events if isinstance(e, dict)], name_filter)
        by_pid[pid] = {"src": path, "reason": reason,
                       "label": f"postmortem pid {pid} ({reason})",
                       "spans": spans, "markers": []}
    return [by_pid[k] for k in sorted(by_pid)]


def _load_source(src: str, name_filter: str,
                 include_events: bool) -> dict:
    """One metrics dir (or trace.json) -> its span events + markers
    (+ the dir's postmortem dumps as extra track-group parts)."""
    if os.path.isdir(src):
        trace_path = os.path.join(src, "trace.json")
        events_path = os.path.join(src, "events.jsonl")
        pm_dir = os.path.join(src, "postmortem")
    else:
        trace_path = src
        events_path = os.path.join(os.path.dirname(src) or ".",
                                   "events.jsonl")
        pm_dir = None
    raw = load_span_events(trace_path)
    events = _filter_spans(raw, name_filter)
    markers = []
    if include_events and os.path.isfile(events_path):
        markers = load_event_markers(events_path)
    postmortems = []
    if pm_dir is not None and os.path.isdir(pm_dir):
        # pids already on this source's timeline are alive (or the
        # latest life): their rolling dump would duplicate trace.json
        live_pids = {e.get("pid") for e in raw}
        postmortems = load_postmortems(pm_dir, name_filter,
                                       exclude_pids=live_pids)
    return {"src": src, "spans": events, "markers": markers,
            "postmortems": postmortems}


def export(src, out: str, name_filter: str = "",
           include_events: bool = True) -> dict:
    """``src`` is one metrics dir / trace.json, or a list of them.
    Multiple sources merge onto one wall-clock timeline with one
    Perfetto process track group per source: events are re-pidded
    (synthetic pid = 1-based source index) and a ``process_name``
    metadata event labels the group — two dirs written by the same
    real pid (one process's trainer dir and serving dir) must not
    interleave into one track.  Spans keep their ``trace_id`` args, so
    a request surfaced by ``/tracez`` or the access log is findable by
    id in the merged view."""
    srcs = [src] if isinstance(src, str) else list(src)
    if not srcs:
        raise SystemExit("no source dir given")
    loaded = [_load_source(s, name_filter, include_events) for s in srcs]
    # flatten: each source, then its dead replicas' postmortem rings as
    # extra track groups of their own
    parts, n_postmortems = [], 0
    for src_part in loaded:
        pm = src_part.pop("postmortems", [])
        parts.append(src_part)
        parts.extend(pm)
        n_postmortems += len(pm)
    events = []
    n_spans = n_markers = 0
    for i, part in enumerate(parts):
        n_spans += len(part["spans"])
        n_markers += len(part["markers"])
        if len(parts) == 1:
            events += part["spans"] + part["markers"]
            continue
        pid = i + 1
        label = part.get("label") \
            or os.path.basename(os.path.normpath(part["src"])) \
            or part["src"]
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "ts": 0.0,
                       "args": {"name": f"{label} ({part['src']})"}})
        events += [dict(e, pid=pid)
                   for e in part["spans"] + part["markers"]]
    # metadata first, then time order (Perfetto wants names early)
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(out, "w") as f:
        json.dump(doc, f)
    return {"out": out, "spans": n_spans, "markers": n_markers,
            "sources": len(loaded), "postmortems": n_postmortems}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="?",
                    help="FLAGS_metrics_dir or a trace.json")
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--metrics-dir", action="append", default=[],
                    metavar="DIR", dest="metrics_dirs",
                    help="additional metrics dir to merge (repeatable; "
                         "each source gets its own process track group)")
    ap.add_argument("--filter", default="",
                    help="keep only spans whose name contains this")
    ap.add_argument("--no-events", action="store_true",
                    help="skip events.jsonl markers")
    args = ap.parse_args(argv)
    srcs, out = list(args.metrics_dirs), args.out
    if args.src:
        if srcs and out is None:
            # `trace_export.py --metrics-dir a --metrics-dir b out.json`:
            # the lone positional fills `src`, but with --metrics-dir
            # sources present it is the OUTPUT (deterministic — never
            # keyed on whether the path happens to exist, so re-running
            # the same command cannot re-ingest its own output)
            out = args.src
        else:
            srcs.insert(0, args.src)
    if not srcs:
        ap.error("give a positional src and/or --metrics-dir DIR")
    info = export(srcs if len(srcs) > 1 else srcs[0],
                  out or "perfetto_trace.json",
                  args.filter, include_events=not args.no_events)
    pm = info.get("postmortems", 0)
    pm_note = f" (+{pm} postmortem ring(s))" if pm else ""
    print(f"wrote {info['out']}: {info['spans']} span(s), "
          f"{info['markers']} event marker(s) from {info['sources']} "
          f"source(s){pm_note} — load in https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
