"""Crash-safe checkpoints of a program's persistable state.

The port's copy of ``paddle_tpu/checkpoint.py``: the same write
protocol, manifest, validation, resume, retention, fault site, stats,
spans and events, and the reference's ``"pkl"`` format, so each package
restores the other's checkpoints.  The payload is ``state.pkl``, a dict
of numpy arrays: a bfloat16 tensor goes out as an ``ml_dtypes.bfloat16``
array, as a fetch does.  The port pickles with protocol 5 where the
reference uses 2 (``_PICKLE_PROTOCOL``); ``pickle.load`` reads either.
The reference's ``"orbax"`` format needs jax: loading one raises
:class:`UnsupportedCheckpointFormat`, naming it, and is never skipped as
corrupt (resuming an older state in its place would be worse).

Write protocol (crash-safe)::

    <dir>/.tmp-<step>-<pid>-<attempt>/   serialize payload here
        state.pkl
        MANIFEST.json                    per-file size + sha256, written last
    os.replace(tmp, <dir>/<step>)        atomic publish

A crash at any point leaves either an orphaned ``.tmp-*`` (reaped by
:func:`gc_checkpoints`) or a fully published checkpoint.  Readers verify
the manifest (existence + size + checksum) and fall back to the newest
*valid* checkpoint instead of dying on, or half-restoring from, a torn
one.  Transient write errors retry with exponential backoff
(``FLAGS_checkpoint_retries`` / ``FLAGS_checkpoint_retry_backoff_s``).

Saving reads every persistable to the host once (one blocking copy a
tensor, after the device's queued work); loading checks every value's
shape and dtype against the scope before it writes any, then copies each
into the scope tensor's own storage, so a captured CUDA graph that reads
it keeps its ``data_ptr`` and reads the loaded state.

Observability (monitor stats): ``checkpoint_writes``,
``checkpoint_retries``, ``checkpoint_corrupt_skipped``,
``checkpoint_resumes``, ``checkpoints_gc``, ``checkpoint_tmp_cleaned``,
``checkpoint_bytes_written`` (payload bytes per published checkpoint,
cumulative).  Telemetry (telemetry.py): ``ckpt/write`` / ``ckpt/publish``
/ ``ckpt/gc`` / ``ckpt/restore`` spans, a ``checkpoint_write_ms``
duration histogram, and ``ckpt_publish`` / ``ckpt_resume`` JSONL events.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import fault
from . import telemetry
from .flags import flag_value, register_flag
from .monitor import stat_add

__all__ = ["CheckpointCorrupt", "UnsupportedCheckpointFormat", "MANIFEST",
           "save_checkpoint", "verify_checkpoint", "validate_checkpoint",
           "valid_steps", "latest_step", "restore_latest", "load_checkpoint",
           "gc_checkpoints"]

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

register_flag("FLAGS_checkpoint_retries", 2,
              "retry a failed checkpoint write up to N more times "
              "(exponential backoff) before giving up")
register_flag("FLAGS_checkpoint_retry_backoff_s", 0.05,
              "base backoff (seconds) between checkpoint write retries")

MANIFEST = "MANIFEST.json"
_TMP_PREFIX = ".tmp-"
# The reference pickles with protocol 2, which has no opcode for binary
# bytes: Python 3 writes an array's buffer as a latin-1 string in UTF-8
# (a byte >= 0x80 takes two) through a per-character codec, both ways
# (probe_train_guard.py times it).  Protocol 5 writes the buffer as it
# is, and the reference's pickle.load reads it unchanged.
_PICKLE_PROTOCOL = 5


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed manifest/checksum validation or deserialization."""


class UnsupportedCheckpointFormat(RuntimeError):
    """A valid checkpoint in a format the port cannot read (the reference's
    ``orbax``, which needs jax).  Not a :class:`CheckpointCorrupt`: a
    resume must stop here, not fall back to an older checkpoint."""


def _persistable_state(program, scope) -> Dict[str, np.ndarray]:
    """Every persistable the scope holds, on the host: a tensor by one
    blocking copy (bfloat16 as ``ml_dtypes.bfloat16``), anything else as
    ``np.asarray`` gives it."""
    from .framework.executor import fetch_to_numpy

    names, tensors, state = [], [], {}
    for v in program.list_vars():
        if not v.persistable:
            continue
        val = scope.find_var(v.name)
        if isinstance(val, torch.Tensor):
            names.append(v.name)
            tensors.append(val)
        elif val is not None:
            state[v.name] = np.asarray(val)
    state.update(zip(names, fetch_to_numpy(tensors)))
    return state


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_manifest(ckpt_dir: str, step: int, fmt: str) -> dict:
    files = {}
    for root, _dirs, names in os.walk(ckpt_dir):
        for name in names:
            if name == MANIFEST:
                continue
            p = os.path.join(root, name)
            files[os.path.relpath(p, ckpt_dir)] = {
                "bytes": os.path.getsize(p), "sha256": _sha256(p)}
    manifest = {"step": int(step), "format": fmt, "files": files,
                "time": time.time()}
    mpath = os.path.join(ckpt_dir, MANIFEST)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    return manifest


def verify_checkpoint(directory: str, step: int, deep: bool = True) -> dict:
    """Validate one checkpoint; returns its manifest ({} for legacy
    layouts without one, which are only verifiable by loading).
    deep=False skips the sha256 re-hash (manifest + existence + sizes
    only) — enough for retention/discovery without re-reading gigabytes.
    Raises CheckpointCorrupt / FileNotFoundError."""
    path, kind = _checkpoint_path(directory, step)
    if kind in ("pkl-legacy", "orbax-legacy"):
        return {}
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise CheckpointCorrupt(f"{path}: missing {MANIFEST}")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{mpath}: unreadable manifest: {e}") from e
    for rel, meta in manifest.get("files", {}).items():
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            raise CheckpointCorrupt(f"{path}: missing payload file {rel}")
        if os.path.getsize(fp) != meta["bytes"]:
            raise CheckpointCorrupt(
                f"{path}: torn write in {rel} "
                f"({os.path.getsize(fp)} != {meta['bytes']} bytes)")
        if deep and _sha256(fp) != meta["sha256"]:
            raise CheckpointCorrupt(f"{path}: checksum mismatch in {rel}")
    return manifest


def validate_checkpoint(directory: str, step: int,
                        deep: bool = True) -> bool:
    try:
        verify_checkpoint(directory, step, deep=deep)
        return True
    except (CheckpointCorrupt, FileNotFoundError):
        return False


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, step: int, program=None, scope=None,
                    extra_state: Optional[dict] = None,
                    keep_last_n: Optional[int] = None) -> str:
    """Save all persistable vars (+ extra_state) under directory/step,
    atomically, with retry-with-backoff on I/O errors; optionally GC down
    to the newest `keep_last_n` valid checkpoints afterwards."""
    from .framework.core import default_main_program
    from .framework.executor import global_scope

    program = program or default_main_program()
    scope = scope or global_scope()
    arrays = _persistable_state(program, scope)
    if extra_state:
        arrays.update({f"__extra__{k}": np.asarray(v)
                       for k, v in extra_state.items()})

    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    retries = int(flag_value("FLAGS_checkpoint_retries") or 0)
    backoff = float(flag_value("FLAGS_checkpoint_retry_backoff_s") or 0)
    last_err: Optional[OSError] = None
    with telemetry.trace_span("ckpt/write", step=int(step)), \
            telemetry.timer("checkpoint_write_ms"):
        for attempt in range(retries + 1):
            if attempt:
                stat_add("checkpoint_retries")
                time.sleep(backoff * (2 ** (attempt - 1)))
            tmp = os.path.join(
                directory, f"{_TMP_PREFIX}{step}-{os.getpid()}-{attempt}")
            try:
                manifest = _write_once(tmp, final, arrays, step)
                stat_add("checkpoint_writes")
                break
            except OSError as e:
                last_err = e
                logger.warning("checkpoint write for step %s failed "
                               "(attempt %d/%d): %s",
                               step, attempt + 1, retries + 1, e)
                shutil.rmtree(tmp, ignore_errors=True)
        else:
            raise last_err
    nbytes = sum(f["bytes"] for f in manifest.get("files", {}).values())
    stat_add("checkpoint_bytes_written", nbytes)
    telemetry.log_event("ckpt_publish", step=int(step), bytes=nbytes,
                        format=manifest.get("format"), attempts=attempt + 1)
    if keep_last_n:
        gc_checkpoints(directory, keep_last_n)
    return final


def _write_once(tmp: str, final: str, arrays: Dict[str, np.ndarray],
                step: int) -> dict:
    kind = fault.fire("ckpt_write")
    if kind == "raise":
        raise fault.InjectedFault(
            f"injected checkpoint write failure (step {step})")
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "state.pkl"), "wb") as f:
        pickle.dump(arrays, f, protocol=_PICKLE_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    manifest = _write_manifest(tmp, step, "pkl")
    with telemetry.trace_span("ckpt/publish", step=int(step)):
        if os.path.isdir(final):
            shutil.rmtree(final)
        elif os.path.exists(final):
            os.remove(final)
        os.replace(tmp, final)
    if kind in ("torn", "partial"):
        # simulate storage failure after publish: data never hit the disk
        _inject_corruption(final, kind)
    return manifest


def _inject_corruption(path: str, kind: str):
    if kind == "partial":
        os.remove(os.path.join(path, MANIFEST))
        return
    target, size = None, -1  # torn: truncate the largest payload file
    for root, _dirs, names in os.walk(path):
        for n in names:
            if n == MANIFEST:
                continue
            p = os.path.join(root, n)
            s = os.path.getsize(p)
            if s > size:
                target, size = p, s
    if target is not None:
        with open(target, "r+b") as f:
            f.truncate(max(1, size // 2))


# ---------------------------------------------------------------------------
# discovery / load
# ---------------------------------------------------------------------------

def _entries(directory: str) -> Dict[int, List[str]]:
    """step -> directory-entry names (a step can have both a legacy .pkl
    and a checkpoint dir; the dir wins at load)."""
    out: Dict[int, List[str]] = {}
    for name in os.listdir(directory):
        if name.startswith(_TMP_PREFIX):
            continue
        base = name[:-4] if name.endswith(".pkl") else name
        if base.isdigit():
            out.setdefault(int(base), []).append(name)
    return out


def _checkpoint_path(directory: str, step: int) -> Tuple[str, str]:
    d = os.path.join(directory, str(step))
    if os.path.isdir(d):
        if os.path.isfile(os.path.join(d, MANIFEST)) or \
                os.path.isdir(os.path.join(d, "orbax")) or \
                os.path.isfile(os.path.join(d, "state.pkl")):
            # new layout (a new-layout dir WITHOUT its manifest is torn:
            # the atomic publish always includes it)
            return d, "dir"
        # pre-manifest layout: orbax payload directly under <dir>/<step>
        return d, "orbax-legacy"
    if os.path.isfile(d + ".pkl"):
        return d + ".pkl", "pkl-legacy"
    raise FileNotFoundError(f"no checkpoint for step {step} in {directory}")


def valid_steps(directory: str) -> List[int]:
    """Ascending steps whose checkpoints pass structural (shallow)
    manifest validation; the deep sha256 check runs at load time, before
    any scope mutation, where a same-size bit-flip actually matters."""
    if not os.path.isdir(directory):
        return []
    return [s for s in sorted(_entries(directory))
            if validate_checkpoint(directory, s, deep=False)]


def latest_step(directory: str, validate: bool = True) -> Optional[int]:
    """Newest step — by default the newest that passes validation, so a
    torn/manifest-less write can never be offered for resume."""
    if not os.path.isdir(directory):
        return None
    steps = valid_steps(directory) if validate \
        else sorted(_entries(directory))
    return steps[-1] if steps else None


def _load_state(directory: str, step: int) -> dict:
    """Verify + fully deserialize one checkpoint (no scope mutation)."""
    manifest = verify_checkpoint(directory, step)
    path, kind = _checkpoint_path(directory, step)
    if kind == "orbax-legacy" or manifest.get("format") == "orbax":
        raise UnsupportedCheckpointFormat(
            f"checkpoint {path} is in the 'orbax' format, which the "
            f"PyTorch port cannot read (it needs jax); write checkpoints "
            f"for both packages in the 'pkl' format "
            f"(paddle_tpu.checkpoint.save_checkpoint(use_orbax=False))")
    try:
        if kind == "pkl-legacy":
            with open(path, "rb") as f:
                return pickle.load(f)
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            return pickle.load(f)
    except Exception as e:
        raise CheckpointCorrupt(
            f"checkpoint {path}: failed to deserialize: {e}") from e


def _apply_state(state: dict, program, scope) -> dict:
    """Write a loaded state into the scope: every value is checked
    against the scope's tensor first (shape, and dtype up to an integer's
    width: the JAX package keeps int64 state as int32), and only then is
    each copied into that tensor's own storage (a value the scope holds
    as no tensor is set as a numpy array).  Returns the extra state."""
    from .framework.executor import to_numpy, to_tensor

    extra, plan = {}, []
    persistable = {v.name for v in program.list_vars() if v.persistable}
    for k, v in state.items():
        if k.startswith("__extra__"):
            extra[k[len("__extra__"):]] = v
            continue
        if k not in persistable:
            continue
        arr = np.asarray(v)
        cur = scope.find_var(k)
        if isinstance(cur, torch.Tensor):
            want = to_numpy(torch.empty(0, dtype=cur.dtype)).dtype
            if tuple(cur.shape) != arr.shape or not (
                    arr.dtype == want or arr.dtype.kind == want.kind == "i"):
                raise ValueError(
                    f"checkpoint value {k!r} is {arr.dtype}{list(arr.shape)}"
                    f" but the scope holds {want}{list(cur.shape)}; no "
                    f"variable was restored")
        plan.append((k, arr, cur))
    for k, arr, cur in plan:
        if isinstance(cur, torch.Tensor):
            cur.copy_(to_tensor(arr, cur.device, None).to(cur.dtype))
        else:
            scope.set_var(k, arr)
    return extra


def restore_latest(directory: str, program=None,
                   scope=None) -> Tuple[Optional[int], dict]:
    """Restore the newest checkpoint that fully validates AND loads;
    corrupt/incomplete ones are skipped (logged + counted), newest-first.
    Returns (step, extra_state) or (None, {})."""
    from .framework.core import default_main_program
    from .framework.executor import global_scope

    program = program or default_main_program()
    scope = scope or global_scope()
    if not os.path.isdir(directory):
        return None, {}
    with telemetry.trace_span("ckpt/restore", dir=directory):
        for step in sorted(_entries(directory), reverse=True):
            try:
                state = _load_state(directory, step)
            except (CheckpointCorrupt, FileNotFoundError) as e:
                stat_add("checkpoint_corrupt_skipped")
                logger.warning("skipping corrupt checkpoint step %s: %s",
                               step, e)
                continue
            # only mutate the scope once a checkpoint fully deserialized:
            # a torn read must not leave a half-restored state behind
            extra = _apply_state(state, program, scope)
            stat_add("checkpoint_resumes")
            telemetry.log_event("ckpt_resume", step=int(step),
                                dir=directory)
            return step, extra
    return None, {}


def load_checkpoint(directory: str, step: Optional[int] = None,
                    program=None, scope=None) -> dict:
    """Restore persistable vars into the scope; returns extra_state.

    With step=None the newest *valid* checkpoint is used, falling back
    past corrupt ones; an explicit step is validated up front and raises
    CheckpointCorrupt before touching the scope."""
    from .framework.core import default_main_program
    from .framework.executor import global_scope

    program = program or default_main_program()
    scope = scope or global_scope()
    if step is None:
        found, extra = restore_latest(directory, program=program,
                                      scope=scope)
        if found is None:
            raise FileNotFoundError(f"no valid checkpoints in {directory}")
        return extra
    return _apply_state(_load_state(directory, step), program, scope)


# ---------------------------------------------------------------------------
# retention
# ---------------------------------------------------------------------------

def gc_checkpoints(directory: str, keep_last_n: int) -> int:
    """Keep the newest `keep_last_n` *valid* checkpoints (corrupt entries
    newer than the boundary are left for forensics — loads skip them);
    delete everything older, plus orphaned .tmp-* write dirs."""
    if not os.path.isdir(directory):
        return 0
    removed = 0
    with telemetry.trace_span("ckpt/gc", keep=keep_last_n):
        for name in os.listdir(directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
                stat_add("checkpoint_tmp_cleaned")
        entries = _entries(directory)
        kept_valid = 0
        for step in sorted(entries, reverse=True):
            if kept_valid < keep_last_n:
                # shallow check: retention ordering must not re-hash
                # every retained checkpoint on every save (load still
                # deep-checks)
                if validate_checkpoint(directory, step, deep=False):
                    kept_valid += 1
                continue
            for name in entries[step]:
                path = os.path.join(directory, name)
                shutil.rmtree(path) if os.path.isdir(path) \
                    else os.remove(path)
                removed += 1
                stat_add("checkpoints_gc")
    return removed
