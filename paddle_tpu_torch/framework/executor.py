"""Executor: a block built once per feed signature, replayed on the card as
one CUDA graph.

Counterpart of ``paddle_tpu/framework/executor.py``.  The JAX executor
jit-compiles each ``(program uid, mod count, feed signature, fetch
names, guard loss)`` into one XLA program and donates the state it
rebinds.  Here each such key gets a ``CompiledStep``:

1. Its first run analyses the block once (state in / out, the fetch
   checks, the grad ops' kept forwards and dead outputs, the order in
   which intermediates can be freed) and then runs eagerly, op by op:
   a real step, which also builds the kernels, sets their shared-memory
   limits and sets up cuBLAS and the allocator on the entry's stream.
2. On the card its second run captures the step with
   ``torch.cuda.graph`` into a private memory pool, reading static feed
   buffers and the scope's own state tensors, and replays it.
3. Every later run copies its feeds into the static buffers and replays:
   one ``cudaGraphLaunch``, no per-op host work.

On the CPU every run takes path 1.  Persistable state is updated in
place: an op that rebinds a persistable writes into its input's storage
(``LowerContext.set_state``) or the step copies into it, so a parameter
keeps its tensor and ``data_ptr()`` from run to run.  A failure to
capture raises, naming the op where one failed; nothing falls back to
eager.  The only eager path on the card besides the first run is
``FLAGS_check_nan_inf``'s debug run.

Fetches come back as numpy arrays (one host fence a run) or as lazy
``FetchHandle``s (``return_numpy=False``, ``run_async``).  The deferred
non-finite guard (``set_nonfinite_guard``) computes ``isfinite(loss)``
inside the step, keeps the old state where it is not, and resolves its
verdicts on the host lazily.

Randomness is keyed by the run count, as the reference folds the step
into its key: before every run or replay each op's generator is seeded
from (random seed, run count, op seed) alone (``ops/registry.py``
``run_seed``), so an executor that resumes at run r draws the masks of
run r.

Telemetry (``telemetry.py``; off with ``FLAGS_telemetry=0``, which
leaves one ``enabled()`` test a run): every run opens an
``executor/step`` span with ``executor/compile`` (an entry's build),
``executor/dispatch`` (the eager run or the replay, with the capture's
own ``executor/compile`` inside it on the run that captures) and
``executor/fetch`` (blocking host reads) children, then feeds
``telemetry.note_step`` (the ``executor_step_host_ms`` histogram, the
``examples_per_sec`` gauge, the heartbeat) and ``maybe_flush``.
``enable_auto_checkpoint`` restores the newest valid checkpoint
(``checkpoint.py``) and writes one every N runs of the bound program.
Dataset training and pipelines wait for later slices.
"""
from __future__ import annotations

import contextlib
import mmap
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..device import resolve_device
from ..flags import flag_value
from ..monitor import monitor as _monitor
from ..ops.registry import LowerContext, lower_op, plan_grads, run_seed
from .core import (Block, Program, Variable, default_main_program,
                   dtype_to_np, dtype_to_torch)
from .selected_rows import densify, is_selected_rows

__all__ = ["Executor", "FetchHandle", "AsyncRunResult", "CompiledStep",
           "Scope", "global_scope", "scope_guard", "analyze_block"]

_STEP_STAT = _monitor.get("executor_run_steps")
_JIT_STAT = _monitor.get("executor_jit_builds")
_SKIP_STAT = _monitor.get("skipped_nonfinite_steps")
_HOST_SYNC_STAT = _monitor.get("host_syncs")
_GUARD_RES_STAT = _monitor.get("guard_resolutions")
_CKPT_FAIL_STAT = _monitor.get("checkpoint_write_failures")

# Eager runs and captures on the card, one at a time in the process: a
# capture must not meet another thread's kernels or allocations, nor
# another capture.  Replays of captured entries run beside them.
_BUILD_LOCK = threading.RLock()
# A capture reads the kernel counts and puts them back, and a replay adds
# its capture's deltas: the two do not interleave.
_COUNTS_LOCK = threading.Lock()
# Compiled steps an Executor or Predictor keeps: on the card each holds
# its CUDA graph's private memory pool for as long as it is cached.
MAX_CACHED_STEPS = 4


# ---------------------------------------------------------------------------
# Lazy fetches
# ---------------------------------------------------------------------------
class FetchHandle:
    """A fetch that stays on the device until its first host read.

    ``Executor.run(..., return_numpy=False)`` and ``run_async`` return
    these.  The tensor is the step's own copy (a later run or replay does
    not overwrite it).  ``value``, ``shape``, ``dtype`` (a torch dtype)
    and ``ndim`` never fence; the first ``numpy()`` / ``np.asarray`` /
    ``float()`` / ``block()`` counts one ``host_syncs`` and resolves
    every pending non-finite-guard verdict up to the handle's step, and a
    second read is free.
    """

    __slots__ = ("_value", "_exe", "_step", "_np")

    def __init__(self, value: torch.Tensor, exe: Optional["Executor"] = None,
                 step: int = 0):
        self._value = value
        self._exe = exe
        self._step = step
        self._np = None

    # -- device-side (never syncs) ------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def ndim(self):
        return self._value.dim()

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        return self._value[idx]

    def __repr__(self):
        state = "read" if self._np is not None else "pending"
        return (f"FetchHandle(step={self._step}, shape={self.shape}, "
                f"dtype={self.dtype}, {state})")

    # -- host-side (first call fences) --------------------------------------
    def numpy(self) -> np.ndarray:
        if self._np is None:
            _HOST_SYNC_STAT.increase()
            with _telemetry.trace_span("executor/fetch", n=1,
                                       step=self._step):
                self._np = to_numpy(self._value)
            if self._exe is not None:
                self._exe._resolve_guard(upto=self._step)
        return self._np

    def block(self) -> "FetchHandle":
        """Fence without copying to the host."""
        if self._np is None:
            _HOST_SYNC_STAT.increase()
            if self._value.is_cuda:
                torch.cuda.synchronize(self._value.device)
            if self._exe is not None:
                self._exe._resolve_guard(upto=self._step)
        return self

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def __float__(self):
        return float(self.numpy())

    def __int__(self):
        return int(self.numpy())

    def __bool__(self):
        return bool(self.numpy())


class AsyncRunResult:
    """What ``Executor.run_async`` hands back: the step's lazy fetches plus
    a ``sync()`` fence.  Indexes and iterates like the list
    ``Executor.run`` returns."""

    __slots__ = ("fetches", "_exe", "_step")

    def __init__(self, fetches: List[FetchHandle], exe: "Executor",
                 step: int):
        self.fetches = fetches
        self._exe = exe
        self._step = step

    def __len__(self):
        return len(self.fetches)

    def __iter__(self):
        return iter(self.fetches)

    def __getitem__(self, i):
        return self.fetches[i]

    def sync(self) -> List[np.ndarray]:
        """Block until this step (and its guard verdict) has landed;
        returns the fetches as numpy."""
        self._exe.sync(upto=self._step)
        return [h.numpy() for h in self.fetches]


# ---------------------------------------------------------------------------
# Scope: name -> tensor holder
# ---------------------------------------------------------------------------
class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def var(self, name: str):
        """Create-or-get."""
        return self._vars.setdefault(name, None)

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def set_var(self, name: str, value):
        self._vars[name] = value

    def local_var_names(self) -> List[str]:
        return list(self._vars)


_global_scope = Scope()
_scope_stack: List[Scope] = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope: Scope):
        self.scope = scope

    def __enter__(self):
        _scope_stack.append(self.scope)
        return self.scope

    def __exit__(self, *exc):
        _scope_stack.pop()
        return False


# ---------------------------------------------------------------------------
# Block analysis: classify vars into feed / state-in / state-out
# ---------------------------------------------------------------------------

def _op_io(op, block):
    """Effective (reads, writes) of an op, descending into control-flow
    sub-blocks so state read only inside a branch or loop counts."""
    reads = list(op.input_arg_names())
    writes = list(op.output_arg_names())
    prog = block.program
    for key in ("sub_block", "true_block", "false_block"):
        idx = op.attr(key, None)
        if idx is None:
            continue
        sub = prog.block(idx)
        sub_written: set = set()
        for o in sub.ops:
            r, w = _op_io(o, sub)
            reads.extend(n for n in r if n not in sub_written)
            sub_written.update(w)
    return reads, writes


def analyze_block(block: Block, feed_names: Sequence[str]):
    """Returns (state_in, state_out): vars the run must read from / write
    back into the scope."""
    written: set = set()
    state_in: List[str] = []
    state_out: List[str] = []
    seen_in: set = set(feed_names)
    seen_out: set = set()
    for op in block.ops:
        op_reads, _ = _op_io(op, block)
        for name in op_reads:
            if name in seen_in or name in written or not name:
                continue
            if block._find_var_recursive(name) is not None:
                # persistable state, or a temp read before it is written
                # here (a var a previous partial run left in the scope)
                state_in.append(name)
                seen_in.add(name)
        for name in op.output_arg_names():
            if not name:
                continue
            written.add(name)
            v = block._find_var_recursive(name)
            if v is not None and v.persistable and name not in seen_out:
                state_out.append(name)
                seen_out.add(name)
    return state_in, state_out


def to_tensor(value, device: torch.device, dtype=None) -> torch.Tensor:
    """numpy array / Python scalar / tensor -> tensor on `device` (and
    `dtype`, a canonical string, when given).  A numpy value is copied,
    never aliased: the executor updates state tensors in place, which
    must not write into the caller's array.  A tensor already on `device`
    in `dtype` is returned as it is."""
    tdt = dtype_to_torch(dtype) if dtype is not None else None
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=tdt)
    arr = np.array(value)
    if arr.dtype.name == "bfloat16":  # ml_dtypes, as to_numpy returns it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device=device, dtype=tdt)
    return torch.as_tensor(arr, device=device, dtype=tdt)


def to_numpy(t) -> np.ndarray:
    """A fetch as numpy.  A bfloat16 tensor becomes an ml_dtypes.bfloat16
    array with the same bits, as the JAX package's np.asarray gives it."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError as e:
            raise ImportError("a bfloat16 fetch as numpy needs the "
                              "ml_dtypes package; fetch with "
                              "return_numpy=False instead") from e
        return t.detach().view(torch.int16).cpu().numpy().view(
            ml_dtypes.bfloat16)
    return t.detach().cpu().numpy()


# A fetch this large gets pages faulted in by one mmap call, not one
# fault a page as the device-to-host copy first writes each page.
_POPULATE_BYTES = 1 << 20


def _host_array(shape, dtype) -> np.ndarray:
    """A fresh numpy array in ordinary (pageable) host memory; a large
    one's pages faulted in at once by an anonymous mmap(MAP_POPULATE)."""
    n = int(np.prod(shape))
    nbytes = n * np.dtype(dtype).itemsize
    if nbytes < _POPULATE_BYTES:
        return np.empty(shape, dtype)
    mm = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                   | getattr(mmap, "MAP_POPULATE", 0))
    return np.frombuffer(mm, dtype=dtype, count=n).reshape(shape)


def fetch_to_numpy(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Fetched tensors as numpy arrays in ordinary host memory, as the JAX
    package's np.asarray gives them: each CUDA tensor is copied by a
    blocking device-to-host copy (the first one waits for the step) into
    a fresh array (``_host_array``).  Nothing is pinned, so a caller that
    keeps its arrays holds no pinned memory, the next fetch allocates
    none, and no later fetch writes into an array handed out before."""
    out = []
    for t in tensors:
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            out.append(to_numpy(t))
            continue
        a = _host_array(tuple(t.shape),
                        to_numpy(torch.empty(0, dtype=t.dtype)).dtype)
        src = t.detach()
        if t.dtype == torch.bfloat16:  # numpy's view is ml_dtypes'
            torch.from_numpy(a.view(np.int16)).copy_(src.view(torch.int16))
        else:
            torch.from_numpy(a).copy_(src)
        out.append(a)
    return out


def _counters():
    """(owner, attribute) of every kernel count: the attention wrappers',
    the product kernel's, the RMSNorm kernel's and the SelectedRows merge
    kernel's ``.launches``, the attention wrappers' ``.realigned`` and the
    plain versions' ``.calls``."""
    from ..ops.cuda import flash_attention, gemm, rms_norm, selected_rows

    return flash_attention.counters() + gemm.counters() + \
        rms_norm.counters() + selected_rows.counters()


@contextlib.contextmanager
def _on_stream(stream: Optional[torch.cuda.Stream], device: torch.device):
    """Eager work on the card runs on the entry's stream (the one its graph
    is captured on, so cuBLAS and the allocator are set up for it),
    ordered after and before the caller's stream; on the CPU, as is."""
    if stream is None:
        yield
        return
    caller = torch.cuda.current_stream(device)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        caller.wait_stream(stream)


def _check_outputs(op, env, block):
    """FLAGS_check_nan_inf: the op's outputs must have the shapes shape
    inference declared and, if float, be finite (a SelectedRows output:
    its values slab)."""
    for name in op.output_arg_names():
        val = env.get(name)
        if is_selected_rows(val):
            val = val.values
        if not isinstance(val, torch.Tensor):
            continue
        v = block._find_var_recursive(name)
        decl = getattr(v, "shape", None) if v is not None else None
        run_shape = tuple(val.shape)
        if (decl is not None and len(decl) == len(run_shape)
                and all(int(d) >= 0 for d in decl)
                and tuple(int(d) for d in decl) != run_shape):
            raise RuntimeError(
                f"shape-inference drift: op {op.type!r} output {name!r} "
                f"declared {tuple(decl)} but lowered to {run_shape} (op "
                f"index {op.idx})")
        if val.is_floating_point() and not bool(torch.isfinite(val).all()):
            raise FloatingPointError(
                f"FLAGS_check_nan_inf: non-finite value in output {name!r} "
                f"of op {op.type!r} (op index {op.idx})")


# ---------------------------------------------------------------------------
# The compiled step
# ---------------------------------------------------------------------------
class CompiledStep:
    """One cache entry: a block analysed once for a feed signature, run
    eagerly the first time and, on the card, captured as a CUDA graph the
    second time and replayed after that.

    Each run's `step` (the executor's run count; by default `seed_step`,
    the count at the entry's first run, plus the entry's runs) seeds the
    entry's generators with the program's random seed and each op's
    ``__op_seed__`` before the run: ``LowerContext.rng`` in an eager run,
    ``_seed`` before a replay (the generators are registered with the
    graph, which reads their seed at each replay).  With `guard_loss`, the step
    computes ``ok = isfinite(loss).all()`` on the device and writes each
    rebound state as ``where(ok, new, old)``.  `is_test` lowers for
    inference (Predictor).

    On the card the entry has a stream of its own for its eager runs and
    its capture, and these run under a process-wide lock, so threads that
    serve different entries never capture into one another's graphs.
    The kernel counts are exact while the runs that launch kernels
    eagerly do not overlap replays in other threads.
    """

    def __init__(self, program: Program, feed_names: Sequence[str],
                 fetch_names: Sequence[str], device: torch.device, *,
                 guard_loss: Optional[str] = None, is_test: bool = False,
                 seed_step: int = 0, sig=None):
        block = program.global_block()
        state_in, state_out = analyze_block(block, feed_names)
        for n in fetch_names:
            block.var(n)  # raises if unknown
        self.block = block
        self.device = device
        self.stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self.sig = sig
        self.fetch_names = list(fetch_names)
        self.state_in = state_in
        self.mut_in = [n for n in state_in if n in state_out]
        self.new_out = [n for n in state_out if n not in state_in]
        self.state_names = set(state_in) | set(state_out)
        self.guard_loss = guard_loss
        self.is_test = is_test
        self.random_seed = program.random_seed or 0
        self.seed_step = seed_step
        self.amp = getattr(program, "_amp_lowering", None)
        ops = [(i, op) for i, op in enumerate(block.ops)
               if op.type not in ("feed", "fetch")]
        reads, last = set(), {}
        for i, op in ops:
            r, w = _op_io(op, block)
            reads.update(r)
            for n in r + w:
                last[n] = i
        kept = set(self.fetch_names) | self.state_names | \
            {v.name for v in program.list_vars() if v.persistable}
        if guard_loss is not None:
            kept.add(guard_loss)
        self.keep, self.grad_source, self.dead, self.differentiated = \
            plan_grads(ops, reads | kept)
        free_after: Dict[int, List[str]] = {}
        for n, i in last.items():
            if n not in kept:
                free_after.setdefault(i, []).append(n)
        self.ops = [(i, op, tuple(free_after.get(i, ()))) for i, op in ops]
        self.generators: Dict[tuple, torch.Generator] = {}
        self.counters = _counters()
        self.runs = 0
        # the most forward graphs kept alive at once in the last eager
        # run (LowerContext.peak_saved)
        self.peak_kept = 0
        # the captured graph and what it reads and writes in place
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.bound: Dict[str, torch.Tensor] = {}
        self.static_feeds: Dict[str, torch.Tensor] = {}
        self.outputs: Tuple = ()
        self.deltas: List[int] = []
        self.pool_bytes: Optional[int] = None
        self.captures = 0  # CUDA graphs captured for this entry
        self._ring: Dict[str, list] = {}

    @property
    def ready(self) -> bool:
        """Whether the next run takes the entry's steady path: a replay on
        the card, any run after the first on the CPU."""
        return self.graph is not None if self.stream is not None \
            else self.runs > 0

    # -- the step ------------------------------------------------------------
    def _lower(self, env: Dict[str, Any], state: Dict[str, torch.Tensor],
               step: int, check: bool = False, capture: bool = False):
        """Lower every op into `env` at run `step`, write the rebound state
        into `state`'s tensors; returns (fetches, new state outputs,
        ok)."""
        guarded = self.guard_loss is not None
        ctx = LowerContext(self.block, env, self.device,
                           random_seed=self.random_seed,
                           is_test=self.is_test, step=step,
                           amp=self.amp, keep=self.keep,
                           grad_source=self.grad_source, dead=self.dead,
                           generators=self.generators,
                           in_place=() if guarded else self.mut_in,
                           seeding=not capture,
                           differentiated=self.differentiated)
        with torch.no_grad():
            for i, op, free in self.ops:
                lower_op(ctx, op, i)
                if check:
                    _check_outputs(op, env, self.block)
                for n in free:
                    ctx.free(n)
            self.peak_kept = ctx.peak_saved
            ok = None
            if guarded:
                loss = env.get(self.guard_loss)
                ok = torch.isfinite(loss).all() if loss is not None else \
                    torch.ones((), dtype=torch.bool, device=self.device)
            for n in self.mut_in:
                old, new = state[n], densify(env[n])
                if ok is not None:
                    # a non-finite step leaves the old state bit-unchanged
                    old.copy_(torch.where(ok, new, old))
                elif new is not old:
                    old.copy_(new)
            # a SelectedRows fetch or state output leaves the step dense
            fetches = tuple(densify(env[n]).detach()
                            for n in self.fetch_names)
            new = tuple(densify(env[n]) for n in self.new_out)
        return fetches, new, ok

    def _state(self, scope: "Scope") -> Dict[str, torch.Tensor]:
        """The scope's state tensors this step reads, by name; a value that
        is not yet a tensor is converted once and put back."""
        state = {}
        for n in self.state_in:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"variable {n!r} has no value in scope; did you run "
                    f"the startup program first?")
            if not isinstance(v, torch.Tensor):
                v = to_tensor(v, self.device)
                scope.set_var(n, v)
            elif v.device != self.device:
                raise RuntimeError(
                    f"variable {n!r} lives on {v.device}, but this run is "
                    f"on {self.device}")
            state[n] = v
        return state

    def _finish(self, scope, fetches, new, ok, aliased):
        """Put the new state into the scope; copy every fetch that the next
        run overwrites (`aliased`: all of them, or the state ones)."""
        for n, v in zip(self.new_out, new):
            scope.set_var(n, v)
        fetches = [f.clone() if aliased or n in self.state_names else f
                   for n, f in zip(self.fetch_names, fetches)]
        if ok is not None and aliased:
            ok = ok.clone()
        return fetches, ok

    def run(self, feeds: Dict[str, torch.Tensor], scope: "Scope",
            check: bool = False, step: Optional[int] = None):
        """One step on `feeds` (name -> tensor, in this entry's signature)
        at run count `step`; returns (fetch tensors the next run does not
        overwrite, the guard's on-device ok or None)."""
        if step is None:
            step = self.seed_step + self.runs
        if self.stream is None:
            return self._run_eager(feeds, scope, check, step)
        if check or self.runs == 0:
            with _BUILD_LOCK:
                return self._run_eager(feeds, scope, check, step)
        if self.graph is None or any(scope.find_var(n) is not t
                                     for n, t in self.bound.items()):
            # the first capture, or the scope's state moved
            with _BUILD_LOCK, _telemetry.trace_span("executor/compile",
                                                    capture=True):
                self._capture(feeds, self._state(scope))
        else:
            self._copy_feeds(feeds)
        self._seed(step)
        self.graph.replay()
        with _COUNTS_LOCK:
            for (owner, attr), d in zip(self.counters, self.deltas):
                setattr(owner, attr, getattr(owner, attr) + d)
        self.runs += 1
        fetches, new, ok = self.outputs
        return self._finish(scope, fetches, new, ok, aliased=True)

    def _run_eager(self, feeds, scope, check, step):
        state = self._state(scope)
        with _on_stream(self.stream, self.device):
            env = {n: t.to(self.device) for n, t in feeds.items()}
            env.update(state)
            fetches, new, ok = self._lower(env, state, step, check)
        self.runs += 1
        return self._finish(scope, fetches, new, ok, aliased=False)

    # -- capture and replay --------------------------------------------------
    def _seed(self, step: int):
        """Seed every generator for a replay at run `step`, as an eager run
        at `step` seeds it (a replay reads each registered generator's
        seed and offset when it starts)."""
        for (op_seed, _), g in self.generators.items():
            g.manual_seed(run_seed(self.random_seed, step, op_seed))

    def _capture(self, feeds, state):
        """Capture the step into a new graph over static feed buffers and
        the scope's state tensors; nothing runs until the replay."""
        torch.cuda.synchronize(self.device)
        if self.graph is not None:
            self.graph.reset()
        self.static_feeds = {n: torch.empty(t.shape, dtype=t.dtype,
                                            device=self.device)
                             for n, t in feeds.items()}
        self._copy_feeds(feeds)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators.values():
            graph.register_generator_state(g)
        counters = self.counters
        torch.cuda.empty_cache()  # so the pool's growth shows in reserved
        reserved = torch.cuda.memory_reserved(self.device)
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        failure = None
        _COUNTS_LOCK.acquire()
        before = [getattr(o, a) for o, a in counters]
        try:
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                try:
                    env = dict(self.static_feeds)
                    env.update(state)
                    self.outputs = self._lower(env, state,
                                               self.seed_step + self.runs,
                                               capture=True)
                except Exception as e:
                    failure = e
                    raise
        except Exception as e:
            raise RuntimeError(
                f"capturing the step as a CUDA graph failed (a host sync, "
                f"such as .item() or .tolist(), cannot be captured): "
                f"{failure or e}") from (failure or e)
        finally:
            # the capture launched nothing: each replay adds what it counted
            after = [getattr(o, a) for o, a in counters]
            for (o, a), v in zip(counters, before):
                setattr(o, a, v)
            _COUNTS_LOCK.release()
        self.deltas = [x - y for x, y in zip(after, before)]
        self.graph = graph
        self.captures += 1
        self.bound = state
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def _copy_feeds(self, feeds):
        """Copy this run's feeds into the static buffers.  A host feed goes
        through a ring of two pinned buffers, so the copy does not block
        and the buffer a copy still reads is not overwritten."""
        for n, t in feeds.items():
            dst = self.static_feeds[n]
            if t.is_cuda:
                dst.copy_(t)
                continue
            ring = self._ring.get(n)
            if ring is None:
                ring = self._ring[n] = [
                    [torch.empty(t.shape, dtype=t.dtype, pin_memory=True),
                     torch.cuda.Event()] for _ in range(2)]
            buf, done = ring[self.runs % 2]
            done.synchronize()  # the copy two runs ago has read it
            buf.copy_(t)
            dst.copy_(buf, non_blocking=True)
            done.record()

    def close(self):
        """Free the graph and its pool once its work is done; a later run
        starts over with an eager run."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph.reset()
        self.graph = None
        self.bound, self.static_feeds, self.outputs = {}, {}, ()
        self._ring.clear()
        self.runs = 0


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------
class Executor:
    """``Executor(place)``: ``place`` None means the card (``cuda:0``);
    ``CPUPlace()`` the CPU.  API mirrors the JAX package's
    run(program, feed, fetch_list, scope, return_numpy,
    use_program_cache), plus run_async / sync, the deferred non-finite
    guard, cache_info and close.

    It keeps up to MAX_CACHED_STEPS compiled steps (least recently used
    first out, closed, which frees a graph's memory pool); a key run
    again after that is built anew.
    """

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache: "OrderedDict[Tuple, CompiledStep]" = OrderedDict()
        self._step = 0  # runs so far
        # deferred non-finite guard: (step, on-device ok) verdicts awaiting
        # host resolution (see _resolve_guard)
        self._pending_guard: List[Tuple[int, torch.Tensor]] = []
        self._guard_loss: Optional[str] = None
        self._guard_cb = None
        self._guard_program = None
        self._dispatched = False
        self._auto_ckpt: Optional[dict] = None

    # -- public API ---------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            use_program_cache: bool = True):
        program = program or default_main_program()
        fetch_names = _fetch_names(fetch_list)
        scope = scope or global_scope()
        if flag_value("FLAGS_check_nan_inf"):
            return self._run_debug(program, dict(feed or {}), fetch_names,
                                   scope, return_numpy)
        if not _telemetry.enabled():
            return self._run_compiled(program, dict(feed or {}),
                                      fetch_names, scope, return_numpy,
                                      use_program_cache, traced=False)[0]
        t0 = time.perf_counter()
        span = _telemetry.span_begin("executor/step", step=self._step + 1)
        try:
            out, examples = self._run_compiled(
                program, dict(feed or {}), fetch_names, scope, return_numpy,
                use_program_cache, traced=True)
        finally:
            _telemetry.span_end(span)
        _telemetry.note_step(self._step,
                             (time.perf_counter() - t0) * 1e3, examples)
        _telemetry.maybe_flush()
        return out

    def _run_compiled(self, program, feed, fetch_names, scope,
                      return_numpy, use_program_cache, traced):
        """The body of :meth:`run`; returns (fetch result, examples in this
        step's feed) for the telemetry wrapper's throughput gauge.
        `traced` opens the dispatch and fetch spans (telemetry on)."""
        block = program.global_block()
        feeds = _prepare_feed(block, feed)
        sig = tuple((n, tuple(t.shape), str(t.dtype))
                    for n, t in feeds.items())
        # guard every run of the bound training program that produces the
        # loss; other programs (startup, an eval clone) run unguarded
        guard_loss = self._guard_loss
        if guard_loss is not None and (
                (self._guard_program is not None
                 and program is not self._guard_program)
                or not block.has_var(guard_loss)):
            guard_loss = None
        key = (program._uid, program._mod_count, sig, tuple(fetch_names),
               guard_loss)
        entry = self._cache.get(key) if use_program_cache else None
        if entry is not None:
            self._cache.move_to_end(key)
        else:
            _JIT_STAT.increase()
            with _telemetry.trace_span("executor/compile",
                                       program=program._uid,
                                       fetches=len(fetch_names)):
                entry = CompiledStep(program, list(feeds), fetch_names,
                                     self.device, guard_loss=guard_loss,
                                     seed_step=self._step + 1, sig=sig)
            if use_program_cache:
                self._cache[key] = entry
                while len(self._cache) > MAX_CACHED_STEPS:
                    self._cache.popitem(last=False)[1].close()
        self._step += 1
        _STEP_STAT.increase()
        bench = flag_value("FLAGS_benchmark")
        if bench:
            self._fence()
            t0 = time.perf_counter()
        dspan = None
        if traced:
            dattrs = {"step": self._step, "guarded": guard_loss is not None}
            if entry.pool_bytes is not None:
                # the captured graph's memory pool: the executable's HBM
                # footprint, as the reference's manifest carries it
                # (torch.cuda.memory_allocated builds the allocator's
                # whole stats dict at every call)
                dattrs["peak_hbm_bytes"] = entry.pool_bytes
            dspan = _telemetry.span_begin("executor/dispatch", **dattrs)
        try:
            fetches, ok = entry.run(feeds, scope, step=self._step)
        finally:
            _telemetry.span_end(dspan)
        self._dispatched = True
        if bench:
            t_dispatch = time.perf_counter() - t0
            self._fence()
            print(f"[FLAGS_benchmark] step {self._step}: "
                  f"{(time.perf_counter() - t0) * 1e3:.3f} ms "
                  f"(host dispatch {t_dispatch * 1e3:.3f} ms)")
        if ok is not None:
            # deferred verdict: the host learns about a skipped step on a
            # fetch read, at the resolve interval, at a checkpoint, or at
            # sync / close
            self._pending_guard.append((self._step, ok))
            interval = int(flag_value("FLAGS_guard_resolve_interval") or 0)
            if interval > 0 and len(self._pending_guard) >= interval:
                self._resolve_guard()
        self._maybe_auto_checkpoint(program, scope)
        first = next(iter(feeds.values()), None)
        examples = int(first.shape[0]) \
            if first is not None and first.dim() else 0
        return self._finish_fetches(fetches, return_numpy,
                                    resolve_guard=True, traced=traced), \
            examples

    def run_async(self, program: Optional[Program] = None,
                  feed: Optional[Dict[str, Any]] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None,
                  use_program_cache: bool = True) -> AsyncRunResult:
        """Dispatch the step and return at once, with no device->host
        fence on the path: lazy FetchHandles plus a ``sync()`` fence."""
        handles = self.run(program, feed, fetch_list, scope,
                           return_numpy=False,
                           use_program_cache=use_program_cache)
        return AsyncRunResult(list(handles), self, self._step)

    def sync(self, upto: Optional[int] = None):
        """Host fence: block until dispatched work has completed and
        resolve pending non-finite-guard verdicts (all of them, or those
        up to step `upto`)."""
        if self._dispatched:
            self._fence()
            self._dispatched = False
        self._resolve_guard(upto=upto)
        return self

    def cache_info(self) -> dict:
        """Compiled-step inventory: one record per entry with its feed
        signature, whether its CUDA graph is captured (``aot``) and the
        device memory its capture reserved (``manifest``, bytes; None
        before a capture; the XLA cost manifest has no counterpart)."""
        entries = [{"signature": None if e.sig is None else str(e.sig),
                    "aot": e.graph is not None,
                    "manifest": e.pool_bytes}
                   for e in self._cache.values()]
        return {"compiled": len(entries), "entries": entries}

    def captures(self) -> List[int]:
        """How many times each cached entry was captured as a CUDA graph,
        oldest entry first: 1 once warm, more where the scope's state
        moved and the entry captured again."""
        return [e.captures for e in self._cache.values()]

    def close(self):
        """Resolve pending guard verdicts and free every entry's graph and
        memory pool."""
        self._resolve_guard()
        for e in self._cache.values():
            e.close()
        self._cache.clear()
        self._dispatched = False

    # -- auto checkpoint ----------------------------------------------------
    def enable_auto_checkpoint(self, directory: str,
                               interval_steps: int = 100,
                               program=None, max_keep: int = 3):
        """Periodic checkpoint and resume (the reference's
        auto_checkpoint): every `interval_steps` runs of `program` its
        persistable state is checkpointed (``checkpoint.py``); on enable
        the newest *valid* checkpoint, if any, is restored (corrupt or
        torn ones skipped) and the run count set to its step, so a
        restarted process continues where it died and draws that run's
        randomness.  Returns the restored step or None."""
        from .. import checkpoint as ckpt

        program = program or default_main_program()
        self._auto_ckpt = {"dir": directory,
                           "interval": max(1, int(interval_steps)),
                           "program": program, "max_keep": max_keep}
        step, _extra = ckpt.restore_latest(directory, program=program)
        if step is not None:
            self._step = int(step)
        return step

    def disable_auto_checkpoint(self):
        self._auto_ckpt = None

    def _maybe_auto_checkpoint(self, program, scope):
        ac = self._auto_ckpt
        if not ac or self._step % ac["interval"]:
            return
        # a checkpoint is a guard-resolution point: the skip bookkeeping
        # must be final before the state is read
        self._resolve_guard()
        # only runs of the bound training program: an eval program's run
        # must not write a state without the optimizer's moments
        if program is not ac["program"]:
            return
        from .. import checkpoint as ckpt

        try:
            ckpt.save_checkpoint(ac["dir"], self._step,
                                 program=ac["program"], scope=scope,
                                 keep_last_n=ac["max_keep"])
        except OSError as e:
            # best effort: a flaky store must not kill the training job
            # (the write already retried with backoff inside)
            _CKPT_FAIL_STAT.increase()
            import logging
            logging.getLogger("paddle_tpu_torch.checkpoint").error(
                "auto-checkpoint at step %d failed: %s", self._step, e)

    # -- non-finite guard ---------------------------------------------------
    def set_nonfinite_guard(self, loss, callback=None, program=None):
        """Always-on skip-step: whenever `loss` comes out non-finite the
        step keeps the old state (selected on the device, no host round
        trip before the optimizer).  `callback(step)` fires, with that
        step's id, when the verdict is resolved.  With `program` given,
        only runs of that program are guarded."""
        self._guard_loss = loss if isinstance(loss, str) else loss.name
        self._guard_cb = callback
        self._guard_program = program

    def clear_nonfinite_guard(self):
        # resolve BEFORE dropping the callback: verdicts still in flight
        # must fire their skip bookkeeping, not vanish
        self._resolve_guard()
        self._guard_loss = None
        self._guard_cb = None
        self._guard_program = None

    def resolve_nonfinite_guard(self):
        """Public fence for the deferred guard only."""
        self._resolve_guard()

    def _resolve_guard(self, upto: Optional[int] = None):
        """Pull pending on-device verdicts to the host (oldest first, one
        fence for the batch) and fire the skip bookkeeping —
        ``skipped_nonfinite_steps`` and the callback with the ORIGINAL
        step id — as if each had been checked at its own step."""
        pending = self._pending_guard
        if not pending:
            return
        if upto is None:
            take, rest = pending, []
        else:
            take = [p for p in pending if p[0] <= upto]
            if not take:
                return
            rest = [p for p in pending if p[0] > upto]
        self._pending_guard = rest
        _GUARD_RES_STAT.increase()
        _HOST_SYNC_STAT.increase()
        oks = torch.stack([ok for _, ok in take]).cpu().tolist()
        for (step_id, _), okv in zip(take, oks):
            if not okv:
                _SKIP_STAT.increase()
                if self._guard_cb is not None:
                    self._guard_cb(step_id)

    # -- helpers ------------------------------------------------------------
    def _fence(self):
        _HOST_SYNC_STAT.increase()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _finish_fetches(self, fetches, return_numpy: bool,
                        resolve_guard: bool = False, traced: bool = False):
        """Blocking numpy fetches (one fence a run) or lazy FetchHandles.
        `resolve_guard` marks the paths where a blocking read doubles as
        a guard-resolution point; `traced` opens the fetch span."""
        if not return_numpy:
            return [FetchHandle(f, self, self._step) for f in fetches]
        if not fetches:
            return []
        _HOST_SYNC_STAT.increase()
        if traced:
            with _telemetry.trace_span("executor/fetch", n=len(fetches),
                                       step=self._step):
                out = fetch_to_numpy(fetches)
        else:
            out = fetch_to_numpy(fetches)
        if resolve_guard:
            self._resolve_guard(upto=self._step)
        return out

    def _run_debug(self, program, feed, fetch_names, scope, return_numpy):
        """FLAGS_check_nan_inf: run the block eagerly, op by op (an entry
        of its own, never cached or captured) and raise, naming the op, on
        the first non-finite float output or on an output whose shape
        differs from the one shape inference declared."""
        block = program.global_block()
        feeds = _prepare_feed(block, feed)
        entry = CompiledStep(program, list(feeds), fetch_names, self.device,
                             seed_step=self._step + 1)
        self._step += 1
        _STEP_STAT.increase()
        fetches, _ = entry.run(feeds, scope, check=True, step=self._step)
        self._dispatched = True
        return self._finish_fetches(fetches, return_numpy)


def _fetch_names(fetch_list) -> List[str]:
    names = []
    for f in fetch_list or []:
        if isinstance(f, Variable):
            names.append(f.name)
        elif isinstance(f, str):
            names.append(f)
        else:
            raise TypeError(f"bad fetch entry: {f!r}")
    return names


def _prepare_feed(block: Block, feed: Dict[str, Any]
                  ) -> Dict[str, torch.Tensor]:
    """Feeds as tensors in the var's dtype, where they are (a host feed on
    the CPU, aliasing a numpy array where it can), in sorted-name order
    (the JAX executor's canonical feed order, which the cache key and
    the static buffers follow)."""
    out = {}
    for name, value in sorted(feed.items()):
        dtype = shape = None
        if block.has_var(name):
            v = block.var(name)
            dtype, shape = v.dtype, v.shape
        if isinstance(value, torch.Tensor):
            t = value
        else:
            arr = np.asarray(value)
            if dtype is not None and dtype != "bfloat16" \
                    and arr.dtype != dtype_to_np(dtype):
                arr = arr.astype(dtype_to_np(dtype))
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if arr.dtype.name == "bfloat16" else torch.as_tensor(arr))
        if dtype is not None:
            t = t.to(dtype_to_torch(dtype))
        if shape is not None and len(shape) == t.dim() + 1 and \
                shape[-1] == 1:
            # labels fed as (N,) for (N,1) vars, as the reference allows
            t = t.reshape(tuple(t.shape) + (1,))
        out[name] = t
    return out
