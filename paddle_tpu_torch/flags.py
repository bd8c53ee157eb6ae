"""Global flag registry: ``set_flags`` / ``get_flags``.

The port's copy of ``paddle_tpu/flags.py``'s registry (importing the JAX
package's module would import jax), holding only the flags the port
reads, with the reference's defaults and help strings: the executor's
``FLAGS_check_nan_inf``, ``FLAGS_benchmark`` and
``FLAGS_guard_resolve_interval``; fault.py's ``FLAGS_fault_inject`` and
``FLAGS_fault_seed``; and the generation engine's ``FLAGS_serving_*``
(serving/generation.py registers its paged-cache and draft-size flags
itself, serving/disagg.py ``FLAGS_disagg_transport``); the serving
engine's and the HTTP front end's (``FLAGS_serving_max_batch``,
``_max_delay_ms``, ``_workers``, ``_bisect``, ``_worker_stuck_ms``,
``_access_log``, ``FLAGS_swap_timeout_s``); and those of telemetry.py, tsdb.py,
observatory.py, blackbox.py, costmodel.py and serving/usage.py
(``FLAGS_router_slo_p99_ms`` among them: ``FLAGS_slo_p99_ms`` = 0
inherits it), locksan.py's ``FLAGS_debug_lock_order`` and the serving
engine's ``FLAGS_serving_check_outputs``; serving/router.py and
serving/fleet.py register the router's, the canary's and the
supervisor's flags themselves, checkpoint.py ``FLAGS_checkpoint_retries``
and ``_retry_backoff_s``, memory.py ``FLAGS_allocator_strategy`` and
``FLAGS_fraction_of_gpu_memory_to_use``.
``set_flags`` raises on any other name, so a flag the port would ignore
is an error, not a silent no-op; a later slice registers a flag with the
module that reads it.  ``all_flags`` is ``/statusz``'s view.

Reference: platform/flags.cc:44 (gflags-backed registry) +
fluid/framework.py set_flags/get_flags.  Flags are initialized from
``FLAGS_*`` environment variables at import, like gflags does.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Union

__all__ = ["set_flags", "get_flags", "register_flag", "all_flags"]

_FLAGS: Dict[str, object] = {}
_DEFS: Dict[str, tuple] = {}  # name -> (type, default, help)


def register_flag(name: str, default, help_str: str = ""):
    typ = type(default)
    _DEFS[name] = (typ, default, help_str)
    env = os.environ.get(name)
    if env is not None:
        if typ is bool:
            _FLAGS[name] = env.lower() in ("1", "true", "yes", "on")
        else:
            _FLAGS[name] = typ(env)
    else:
        _FLAGS[name] = default


def _coerce(typ, value):
    if typ is bool and isinstance(value, str):
        # bool('0') is True; parse strings like the env path does
        return value.lower() in ("1", "true", "yes", "on")
    return typ(value)


def set_flags(flags: Dict[str, object]):
    """reference fluid.set_flags({'FLAGS_check_nan_inf': 1})."""
    for name, value in flags.items():
        if name not in _DEFS:
            raise ValueError(f"unknown flag {name!r}; known: "
                             f"{sorted(_DEFS)}")
        _FLAGS[name] = _coerce(_DEFS[name][0], value)


def get_flags(flags: Union[str, Iterable[str]]):
    """reference fluid.get_flags: str -> value, list -> dict."""
    if isinstance(flags, str):
        if flags not in _FLAGS:
            raise ValueError(f"unknown flag {flags!r}")
        return {flags: _FLAGS[flags]}
    return {f: get_flags(f)[f] for f in flags}


def all_flags() -> Dict[str, object]:
    """Every registered flag's current value (the ``/statusz`` payload:
    an operator needs the flags a live server runs with)."""
    return {name: _FLAGS.get(name, _DEFS[name][1]) for name in _DEFS}


def flag_value(name: str):
    """Internal fast-path accessor."""
    return _FLAGS.get(name, _DEFS.get(name, (None, None))[1])


# -- the flag set (reference platform/flags.cc + nan_inf_utils) -------------
register_flag("FLAGS_check_nan_inf", False,
              "run ops eagerly and raise, naming the op, on the first "
              "non-finite output (framework/details/nan_inf_utils)")
register_flag("FLAGS_benchmark", False,
              "sync and print per-run wall time in Executor.run")
register_flag("FLAGS_guard_resolve_interval", 64,
              "deferred non-finite guard: resolve the pending on-device "
              "ok-verdict ring at most every N guarded steps when nothing "
              "else (a fetch read, a checkpoint, close) forces it; "
              "1 restores the synchronous per-step host check, 0 defers "
              "indefinitely (fetch/checkpoint/close only)")
register_flag("FLAGS_debug_lock_order", False,
              "runtime lock-order sanitizer (paddle_tpu_torch/locksan.py): "
              "wrap every threading.Lock/RLock constructed after "
              "import in an order-recording shim, assert the observed "
              "per-thread acquisition graph stays acyclic, and record "
              "inversions in locksan.violations().  Debug/test only: "
              "costs a thread-local append per acquire plus a graph "
              "check on nested acquires; 0 (default) patches nothing "
              "and costs nothing")
register_flag("FLAGS_serving_check_outputs", False,
              "serving engine: reject batches whose outputs contain "
              "non-finite values (RequestFailed for the batch's rows) "
              "— the bad-checkpoint tripwire the canary burn-rate "
              "judge feeds on.  Off by default: costs one isfinite "
              "scan per batch on the serve path")
register_flag("FLAGS_fault_inject", "",
              "deterministic fault-injection spec: comma-separated "
              "site:kind@N / site:kind@N+ / site:kind~p entries "
              "(fault.py; e.g. 'prefill:fail@2,decode_step:fail@5')")
register_flag("FLAGS_fault_seed", 0,
              "seed for probabilistic (~p) fault-injection triggers")
register_flag("FLAGS_serving_queue_cap", 256,
              "serving engine: bounded admission queue; submit() on a "
              "full queue sheds with an explicit OverloadedError instead "
              "of queuing unbounded latency")
register_flag("FLAGS_serving_deadline_ms", 1000.0,
              "serving engine: requests that waited longer than this in "
              "the queue are shed (OverloadedError) when a worker picks "
              "them up — bounds admission-latency p99 under overload")
register_flag("FLAGS_serving_decode_slots", 8,
              "generation engine: decode-slot grid size — the whole "
              "grid runs every decode iteration, finished sequences "
              "free their slot to the next queued request immediately "
              "(serving/generation.py)")
register_flag("FLAGS_serving_max_seq_len", 256,
              "generation engine: per-slot KV-cache sequence capacity "
              "(prompt + generated tokens); the cache footprint is "
              "slots * layers * 2 * n_kv_heads * max_seq_len * head_dim "
              "* 4 bytes")
register_flag("FLAGS_serving_prefill_buckets", "",
              "comma-separated prefill sequence-length buckets "
              "(prompts pad up to the smallest fitting bucket, one "
              "compiled step per bucket); empty = powers of two "
              "from 8 up to FLAGS_serving_max_seq_len")
register_flag("FLAGS_serving_max_new_tokens", 64,
              "generation engine: default per-request cap on generated "
              "tokens (a request's own max_new_tokens wins; a budget "
              "beyond the cache capacity left after the prompt decodes "
              "until the slot cache fills and finishes 'cache_full')")
register_flag("FLAGS_serving_paged", False,
              "generation engine: block-paged KV cache (a shared page "
              "pool + per-slot block tables) instead of the dense "
              "per-slot [slots, n_kv, max_seq_len, D] reservation; 0 "
              "keeps the dense cache")
register_flag("FLAGS_serving_prefill_chunk", 0,
              "paged generation: feed long prompts in slices of this "
              "many tokens, one slice per scheduler iteration "
              "interleaved with decode steps; 0 = whole-prompt prefill")
register_flag("FLAGS_serving_speculate", False,
              "paged generation: speculative decoding — a prompt-lookup "
              "n-gram drafter proposes up to FLAGS_serving_spec_tokens "
              "tokens per slot per scheduler iteration from the "
              "sequence's OWN prompt+generated history (no second "
              "model), a single chunk-shaped verify program scores the "
              "draft against the paged cache, and the longest "
              "argmax-agreeing prefix (plus the one bonus token) is "
              "accepted — bit-exact vs plain greedy decode, token-for-"
              "token and logit-for-logit.  Rejected draft tokens roll "
              "their provisionally-written KV pages back through the "
              "refcounted pool.  Requires FLAGS_serving_paged=1")
register_flag("FLAGS_serving_role", "both",
              "disaggregated serving role of this GenerationEngine / "
              "replica: 'both' (colocated prefill+decode, the default), "
              "'prefill' (runs paged prefill and exports each prompt's "
              "populated pages as a KVSegment, never occupies a decode "
              "slot), 'decode' (accepts segments via adopt()/POST "
              "/adopt and runs only the decode grid).  Non-'both' "
              "roles require FLAGS_serving_paged=1")
register_flag("FLAGS_serving_poison_value", "",
              "chaos/testing hook: a float sentinel; a generation prompt "
              "containing a token exactly equal to it raises "
              "PoisonedInput at prefill — a deterministic stand-in for an "
              "input that crashes the model; empty disables (the serve "
              "path pays nothing)")
# -- serving engine, HTTP front end, telemetry, tsdb, flight recorder,
# cost model and usage ledger (the reference's names and defaults) ---------
register_flag("FLAGS_serving_max_batch", 8,
              "serving engine: largest micro-batch (= largest padding "
              "bucket) the dynamic batcher forms; buckets are the powers "
              "of two up to this value (paddle_tpu_torch/serving)")
register_flag("FLAGS_serving_max_delay_ms", 5.0,
              "serving engine: longest a worker holds a partial batch "
              "open waiting for more requests before dispatching it "
              "padded (the latency half of the batching policy)")
register_flag("FLAGS_serving_workers", 2,
              "serving engine: predictor-pool size (clone()d predictors "
              "sharing device weights, one dispatch thread each)")
register_flag("FLAGS_serving_bisect", True,
              "serving engine: when a multi-request batch fails, "
              "recursively split-and-retry it to isolate the poisoned "
              "request(s) — exactly the offending requests error, every "
              "other rider is served bit-exact (cost bounded at "
              "(log2(batch)+1) re-dispatches of the original rows); "
              "0 restores fail-the-whole-batch")
register_flag("FLAGS_serving_worker_stuck_ms", 10000.0,
              "serving engine: a dispatch worker whose current batch has "
              "been executing longer than this reports status 'stuck' "
              "(with stuck_ms) in worker_health()/ /healthz — the "
              "engine-level status degrades so the router stops "
              "preferring the replica; 0 disables the watchdog")
register_flag("FLAGS_serving_access_log", "",
              "path of the serving JSONL access log (one line per HTTP "
              "request: trace_id, status, per-phase latency breakdown); "
              "empty defaults to <FLAGS_metrics_dir>/access.jsonl when a "
              "metrics dir is set, else disabled")
register_flag("FLAGS_telemetry", True,
              "master switch for paddle_tpu_torch/telemetry.py: 0 turns spans, "
              "typed metrics, and every file exporter into constant-time "
              "no-ops (one dict lookup on the hot path)")
register_flag("FLAGS_metrics_dir", "",
              "directory for the telemetry file exporters (metrics.prom "
              "Prometheus textfile, events.jsonl event log, heartbeat.json "
              "health file, trace.json Perfetto trace); empty disables "
              "all file output")
register_flag("FLAGS_metrics_interval", 10.0,
              "seconds between periodic telemetry flushes (Prometheus "
              "textfile + heartbeat + trace), checked on the hot path "
              "with one monotonic read")
register_flag("FLAGS_trace_buffer_size", 4096,
              "capacity of the completed-span ring buffer "
              "(paddle_tpu_torch/telemetry.py); oldest spans drop first")
register_flag("FLAGS_trace_sample", 1.0,
              "head-sampling rate for serving request traces: fraction "
              "of requests (0..1, deterministic every-Nth spacing) that "
              "record full serving/admit..respond span trees; unsampled "
              "requests keep phase timings only.  Independent of the "
              "always-keep-slowest-N tail capture (FLAGS_trace_tail_keep)")
register_flag("FLAGS_trace_tail_keep", 8,
              "tail capture: always keep the N slowest request traces "
              "regardless of head sampling (the /tracez 'slowest' list "
              "— the requests worth asking 'why was this slow' about)")
register_flag("FLAGS_tracez_recent", 32,
              "how many recent head-sampled request traces /tracez "
              "retains (bounded ring; oldest drop first)")
register_flag("FLAGS_histogram_buckets", "",
              "comma-separated upper bounds (ms) overriding the default "
              "telemetry histogram buckets for histograms created "
              "without explicit buckets; empty keeps DEFAULT_BUCKETS_MS")
register_flag("FLAGS_device_peak_flops", 0.0,
              "per-chip peak TFLOP/s override for the costmodel peak "
              "table (paddle_tpu_torch/costmodel.py); 0 = auto from "
              "device_kind.  The bench's PEAK_TFLOPS env var, when "
              "set, wins over both (historical contract)")
register_flag("FLAGS_device_peak_bw", 0.0,
              "per-chip peak HBM GB/s override for the costmodel peak "
              "table; 0 = auto from device_kind")
register_flag("FLAGS_hbm_sample_interval", 0.25,
              "seconds between HBM live-buffer samples taken by the "
              "observatory sampling thread (hbm_live_bytes / "
              "hbm_peak_bytes gauges + the Perfetto counter track); "
              "0 disables the sampler")
register_flag("FLAGS_profilez_sec", 2.0,
              "default duration (seconds) of an on-demand profiler "
              "capture (GET /profilez, TrainGuard SIGUSR2); capped at "
              "60s per capture")
register_flag("FLAGS_tsdb", True,
              "in-process time-series store (paddle_tpu_torch/tsdb.py): the "
              "telemetry flush cadence records every counter/gauge and "
              "each histogram's count/p50/p99 as (ts, value) rings for "
              "windowed rate/delta/quantile queries — the layer the "
              "fleet observatory, burn-rate alerts, and the autoscale "
              "signal read.  0 disables recording (and the monitors go "
              "evidence-blind); FLAGS_telemetry=0 disables it too")
register_flag("FLAGS_tsdb_points", 512,
              "tsdb ring capacity per series: memory is hard-bounded "
              "at max_series x points x ~60 bytes per store.  At the "
              "default 10s FLAGS_metrics_interval cadence, 512 points "
              "is ~85 minutes of history")
register_flag("FLAGS_slo_availability_pct", 99.0,
              "availability objective the burn-rate monitor alerts "
              "against: the error budget is (100 - this)% of requests "
              "over the alerting windows (SRE-workbook multi-window "
              "burn rate; paddle_tpu_torch/tsdb.py BurnRateMonitor)")
register_flag("FLAGS_router_slo_p99_ms", 250.0,
              "fleet router: the served-latency SLO the autoscaling "
              "signal is derived from — fleet_wanted_replicas scales "
              "live replicas by max(p99/SLO, queue-depth pressure) "
              "(paddle_tpu_torch/serving/router.py)")
register_flag("FLAGS_slo_p99_ms", 0.0,
              "latency SLO threshold for the burn-rate monitor's p99 "
              "spec: the budget is 1% of requests above this many ms. "
              "0 inherits FLAGS_router_slo_p99_ms (one knob for the "
              "autoscale signal and the alert by default)")
register_flag("FLAGS_slo_fast_window_s", 60.0,
              "burn-rate FAST window: an alert needs this window's "
              "burn over threshold too (proves the problem is still "
              "happening), and clearing is judged on it alone (a "
              "recovered fleet clears in about one fast window)")
register_flag("FLAGS_slo_slow_window_s", 300.0,
              "burn-rate SLOW window: an alert needs this window's "
              "burn over threshold (proves the problem is real, not "
              "one bad scrape).  Must be longer than the fast window")
register_flag("FLAGS_slo_burn_threshold", 2.0,
              "burn-rate alert threshold: fire when BOTH windows burn "
              "error budget at >= this multiple of the sustainable "
              "rate (1.0 = exactly consuming the budget); clear with "
              "hysteresis when the fast window drops below half of it")
register_flag("FLAGS_swap_timeout_s", 30.0,
              "in-place weight swap: max seconds to quiesce at a "
              "drained-batch / decode-grid-step boundary before the "
              "swap gives up (serving keeps running on the old "
              "weights; paddle_tpu_torch/serving/engine.py swap_weights)")
register_flag("FLAGS_blackbox", True,
              "black-box flight recorder (paddle_tpu_torch/blackbox.py): "
              "bounded in-memory rings of recent log events, metric "
              "snapshots, and per-request last words, dumped to "
              "<FLAGS_metrics_dir>/postmortem/<pid>-<reason>.json on "
              "fatal signals, uncaught scheduler exceptions, and "
              "explicit request.  0 = zero per-request work (one dict "
              "lookup, nothing recorded, no dumps); FLAGS_telemetry=0 "
              "disables it too")
register_flag("FLAGS_blackbox_events", 256,
              "flight recorder: capacity of the last-K event ring "
              "(mirrored telemetry log_event records); oldest drop "
              "first")
register_flag("FLAGS_blackbox_requests", 64,
              "flight recorder: max in-flight request last-words "
              "entries held at once; admissions past the cap are "
              "not recorded (counted in the ring's dropped field)")
register_flag("FLAGS_usage", True,
              "per-tenant usage ledger (paddle_tpu_torch/serving/usage.py): "
              "attribute every request's cost vector (requests, "
              "tokens, steps, flops, KV page-seconds, cache hits, "
              "sheds, failures) to its X-PaddleTPU-Tenant, exposed on "
              "/usagez and federated into /fleetz.  0 = zero "
              "per-request work (one dict lookup, no ledger, no "
              "per-tenant series); FLAGS_telemetry=0 disables the "
              "per-tenant latency/SLO series but the ledger still "
              "books counters")
register_flag("FLAGS_usage_top_k", 32,
              "usage ledger: space-saving heavy-hitter sketch width — "
              "at most this many tenants tracked exactly at once; the "
              "rest aggregate into the ~other bucket (memory is "
              "hard-capped at top_k + 1 cost vectors per replica "
              "regardless of tenant cardinality)")
register_flag("FLAGS_usage_default_tenant", "~default",
              "usage ledger: tenant every unattributed request books "
              "under when no X-PaddleTPU-Tenant header / submit("
              "tenant=) is given (kept distinct from ~other, the "
              "sketch's demoted-tenant aggregate)")
