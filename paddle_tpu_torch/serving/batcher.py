"""Batch and prompt shaping for serving: shape buckets, padding, bit-exact
split.

The port's copy of ``paddle_tpu/serving/batcher.py`` (importing the JAX
package's module would import jax).  Every distinct feed shape is a
distinct compiled step (one CUDA graph on the card), so batches pad up to
a small fixed set of bucket sizes and prompts up to a fixed set of
lengths.  This module is the pure, lock-free half: the policy
(`bucket_sizes`, `bucket_for`, `prompt_buckets`, `prompt_bucket_for`),
batch assembly (`signature_of`, `pad_stack`, `pad_prompt`) and the
bit-exact inverse (`split_rows`).

Padding contract: pad rows replicate row 0 of the real payload (never
zeros — a zero row can be out-of-domain for the model and produce
NaN/Inf that trips non-finite machinery; a replicated real row is by
construction in-domain).  Because a served program is row-independent,
pad rows cannot perturb real rows, and `split_rows` slicing the first
`rows` entries returns results `np.array_equal` to running each request
alone.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["bucket_sizes", "fanin_bucket_sizes", "bucket_for",
           "signature_of", "describe_signature", "pad_stack",
           "split_rows", "fill_pct", "prompt_buckets",
           "prompt_bucket_for", "pad_prompt", "chunk_spans"]


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """The padding buckets for a given max batch: powers of two up to
    ``max_batch``, with ``max_batch`` itself always included (so a full
    batch never pads).  max_batch=8 -> (1, 2, 4, 8); 6 -> (1, 2, 4, 6)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = {max_batch}
    b = 1
    while b < max_batch:
        sizes.add(b)
        b *= 2
    return tuple(sorted(sizes))


def fanin_bucket_sizes(max_batch: int,
                       dense_to: int = 8) -> Tuple[int, ...]:
    """Bucket ladder for the many-small-requests (recsys fan-in)
    regime: dense powers of two up to ``dense_to`` (singleton probes
    and tiny feeds still find a snug bucket), then strides of 4x
    (large fan-in batches tolerate more padding, and each bucket is a
    compiled executable — a pow2 ladder to 256 is 9 executables, this
    one is 7 with better top-end spacing).  max_batch=256, dense_to=8
    -> (1, 2, 4, 8, 32, 128, 256); ``max_batch`` always included so a
    full fan-in batch never pads."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if dense_to < 1:
        raise ValueError(f"dense_to must be >= 1, got {dense_to}")
    sizes = {max_batch}
    b = 1
    while b < max_batch:
        sizes.add(b)
        b *= 2 if b < dense_to else 4
    return tuple(sorted(sizes))


def bucket_for(rows: int, buckets: Sequence[int]):
    """Smallest bucket that fits ``rows``; None when rows exceed every
    bucket (the engine then chunks the request across batches)."""
    for b in buckets:
        if rows <= b:
            return b
    return None


def signature_of(arrays: Sequence[np.ndarray]) -> tuple:
    """Per-ROW feed signature: batchable requests are exactly those whose
    feeds agree on everything but the leading (batch) dim."""
    return tuple((a.shape[1:], str(a.dtype)) for a in arrays)


def describe_signature(sig: tuple) -> str:
    """Human-readable form of a :func:`signature_of` tuple for span
    attributes and the ``/statusz`` bucket state — ``"(6,)f32|(2,)i64"``
    instead of a nested tuple repr."""
    short = {"float32": "f32", "float64": "f64", "float16": "f16",
             "bfloat16": "bf16", "int32": "i32", "int64": "i64",
             "int8": "i8", "uint8": "u8", "bool": "b1"}
    parts = []
    for shape, dtype in sig:
        parts.append(f"{tuple(shape)}{short.get(dtype, dtype)}")
    return "|".join(parts)


def pad_stack(feeds: List[Sequence[np.ndarray]],
              bucket: int) -> Tuple[List[np.ndarray], int]:
    """Concatenate each feed position across requests along axis 0 and
    pad up to ``bucket`` rows by replicating row 0.

    ``feeds`` is a list of per-request feed tuples (same order/signature,
    each array with its request's leading batch dim).  Returns
    ``(padded_arrays, real_rows)``."""
    real_rows = sum(int(f[0].shape[0]) for f in feeds)
    if real_rows > bucket:
        raise ValueError(f"{real_rows} rows do not fit bucket {bucket}")
    out = []
    for pos in range(len(feeds[0])):
        cat = feeds[0][pos] if len(feeds) == 1 else \
            np.concatenate([f[pos] for f in feeds], axis=0)
        pad = bucket - real_rows
        if pad:
            fill = np.broadcast_to(cat[:1], (pad,) + cat.shape[1:])
            cat = np.concatenate([cat, fill], axis=0)
        out.append(np.ascontiguousarray(cat))
    return out, real_rows


def split_rows(outputs: Sequence[np.ndarray],
               row_counts: Sequence[int]) -> List[List[np.ndarray]]:
    """Bit-exact inverse of :func:`pad_stack` on the model outputs:
    slice each output back into per-request row ranges (pad rows beyond
    ``sum(row_counts)`` are dropped).  Returns one output list per
    request, aligned with the request order given to pad_stack."""
    per_request: List[List[np.ndarray]] = [[] for _ in row_counts]
    offsets = np.cumsum([0] + list(row_counts))
    for out in outputs:
        arr = np.asarray(out)
        for i, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
            per_request[i].append(arr[lo:hi])
    return per_request


def fill_pct(rows: int, bucket: int) -> float:
    """Batch fill ratio in percent (real rows / padded rows)."""
    return 100.0 * rows / max(bucket, 1)


# ---------------------------------------------------------------------------
# prompt-length bucketing (the generation prefill analog of the batch
# buckets above: every distinct padded prompt length is a distinct compiled
# step, so prompts pad up to a small fixed set of lengths)
# ---------------------------------------------------------------------------

def prompt_buckets(max_len: int, floor: int = 8,
                   buckets=None) -> Tuple[int, ...]:
    """Prefill sequence-length buckets: powers of two from ``floor`` up
    to ``max_len`` (``max_len`` itself always included).  An explicit
    ``buckets`` list overrides (validated ascending, capped at
    max_len)."""
    if max_len < 2:
        raise ValueError(f"max_len must be >= 2, got {max_len}")
    if buckets is not None:
        out = sorted({int(b) for b in buckets})
        if not out or out[0] < 1 or out[-1] > max_len:
            raise ValueError(f"bad prefill buckets {buckets!r} for "
                             f"max_len {max_len}")
        return tuple(out)
    sizes = {max_len}
    b = max(1, floor)
    while b < max_len:
        sizes.add(b)
        b *= 2
    return tuple(sorted(sizes))


def prompt_bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest prefill bucket holding ``length`` prompt tokens;
    raises when the prompt exceeds every bucket (the engine validates
    at submit, so a scheduler-side miss is a bug, not an overload)."""
    b = bucket_for(length, buckets)
    if b is None:
        raise ValueError(f"prompt of {length} tokens exceeds the "
                         f"largest prefill bucket {buckets[-1]}")
    return b


def chunk_spans(start: int, end: int, chunk: int
                ) -> List[Tuple[int, int]]:
    """Split the un-prefilled prompt span ``[start, end)`` into
    consecutive ``(lo, hi)`` chunked-prefill slices of at most
    ``chunk`` tokens (``chunk <= 0`` -> the whole span in one slice).
    The pure scheduling half of chunked prefill: the engine runs one
    span per scheduler iteration, interleaved with decode steps."""
    if end <= start:
        return []
    if chunk <= 0:
        return [(start, end)]
    return [(lo, min(lo + chunk, end))
            for lo in range(start, end, chunk)]


def pad_prompt(ids: np.ndarray, bucket: int, pad_id: int = 0
               ) -> np.ndarray:
    """Right-pad a 1-D token-id prompt to ``bucket``.  Causal attention
    means pad-tail tokens can never influence positions before them, so
    the pad id's value is irrelevant to the real rows (the cached rows
    beyond the true length are masked by per-slot positions)."""
    ids = np.asarray(ids).reshape(-1).astype("int64")
    if ids.size > bucket:
        raise ValueError(f"prompt of {ids.size} tokens does not fit "
                         f"bucket {bucket}")
    out = np.full((bucket,), pad_id, "int64")
    out[:ids.size] = ids
    return out
