"""Device cost model: compiled-step manifests, the peak table, MFU / BW.

The port's counterpart of ``paddle_tpu/costmodel.py``:

* **Peak table** — :func:`device_peaks` maps a card's name (as
  ``torch.cuda.get_device_name`` gives it) to its dense fp32 and bf16
  FLOP/s and its memory bytes/s.  The table holds the cards the port is
  built for and nothing else; an unknown name gives ``None`` peaks, not
  a guess.  ``FLAGS_device_peak_flops`` / ``FLAGS_device_peak_bw``
  override it (TFLOP/s, GB/s).
* **Manifests** — :func:`step_manifest` prices one compiled step (the
  executor's ``CompiledStep``) at its feed signature: the flops of its
  ``mul`` / ``matmul`` / attention ops at the signature's shapes, the
  bytes of the weights it reads, its feeds and its fetches, and its CUDA
  graph's memory pool as the peak.  XLA's cost analysis, which the
  reference reads, has no counterpart here.
* **Achieved efficiency** — :func:`mfu` / :func:`bw_util` /
  :func:`publish_achieved` as in the reference.

Everything degrades to ``None`` instead of raising: observability must
not break execution.
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Any, Dict, Optional

from .flags import flag_value

__all__ = ["PEAK_TABLE", "device_peaks", "peak_flops", "peak_bw",
           "program_flops", "step_manifest", "mfu", "bw_util",
           "publish_achieved", "manifest_summary"]

logger = logging.getLogger("paddle_tpu_torch.costmodel")

# name substring -> (dense fp32 TFLOP/s outside the tensor cores, dense
# bf16 TFLOP/s on the tensor cores, memory GB/s), from NVIDIA's H100 SXM
# data sheet (at its 700 W limit).  First match wins.
PEAK_TABLE = (
    ("h100", 67.0, 989.0, 3350.0),
)


def _kind() -> str:
    import torch

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(0)


def device_peaks(device_kind: Optional[str] = None) -> Dict[str, Any]:
    """Peak rates for the card named ``device_kind`` (None: card 0, or
    "" with no card).  Returns ``{"device_kind", "peak_flops" (bf16
    FLOP/s), "peak_flops_fp32", "peak_bw" (bytes/s), "source"}``; the
    rates are None for a name the table does not hold, and ``source``
    says whether a flag, the table or nothing gave them."""
    kind = _kind() if device_kind is None else str(device_kind)
    fp32 = bf16 = bw = None
    source = "unknown"
    for key, f32, b16, gbps in PEAK_TABLE:
        if key in kind.lower():
            fp32, bf16, bw = f32 * 1e12, b16 * 1e12, gbps * 1e9
            source = "table"
            break
    f = flag_value("FLAGS_device_peak_flops")
    if f:
        bf16, source = float(f) * 1e12, "FLAGS_device_peak_flops"
    b = flag_value("FLAGS_device_peak_bw")
    if b:
        bw = float(b) * 1e9
    return {"device_kind": kind, "peak_flops": bf16,
            "peak_flops_fp32": fp32, "peak_bw": bw, "source": source}


def peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """The card's peak bf16 FLOP/s (None when unknown)."""
    return device_peaks(device_kind)["peak_flops"]


def peak_bw(device_kind: Optional[str] = None) -> Optional[float]:
    """The card's peak memory bytes/s (None when unknown)."""
    return device_peaks(device_kind)["peak_bw"]


def mfu(flops_per_sec: float, device_kind: Optional[str] = None,
        peak: Optional[float] = None) -> Optional[float]:
    """Achieved FLOP/s over the card's peak (None when the peak is
    unknown)."""
    peak = peak if peak is not None else peak_flops(device_kind)
    return flops_per_sec / peak if peak else None


def bw_util(bytes_per_sec: float, device_kind: Optional[str] = None,
            peak: Optional[float] = None) -> Optional[float]:
    """Achieved bytes/s over the card's peak (None when unknown)."""
    peak = peak if peak is not None else peak_bw(device_kind)
    return bytes_per_sec / peak if peak else None


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

def _shape(block, name: str, batch: Optional[int]):
    """The declared shape of `name` with its -1 (the batch) replaced by
    `batch`; None when undeclared or still dynamic."""
    v = block._find_var_recursive(name)
    shape = getattr(v, "shape", None) if v is not None else None
    if shape is None:
        return None
    out = []
    for d in shape:
        d = int(d)
        if d < 0:
            if batch is None:
                return None
            d = batch
        out.append(d)
    return out


def _nbytes(block, name: str, batch: Optional[int]) -> int:
    from .framework.core import dtype_to_torch

    shape = _shape(block, name, batch)
    v = block._find_var_recursive(name)
    if shape is None or v is None:
        return 0
    try:
        itemsize = dtype_to_torch(v.dtype).itemsize
    except (KeyError, TypeError, ValueError):
        itemsize = 4
    return math.prod(shape) * itemsize


def _op_flops(op, block, batch: Optional[int]) -> int:
    """Multiply-add flops (2 a multiply-add) of one product or attention
    op at the run's shapes; 0 for any other op."""
    t = op.type

    def shp(slot):
        names = op.input(slot)
        return _shape(block, names[0], batch) if names else None

    if t == "mul":
        x, y = shp("X"), shp("Y")
        if x is None or y is None:
            return 0
        xd, yd = op.attr("x_num_col_dims", 1), op.attr("y_num_col_dims", 1)
        return 2 * math.prod(x[:xd]) * math.prod(x[xd:]) * \
            math.prod(y[yd:])
    if t in ("matmul", "matmul_v2"):
        x, y = shp("X"), shp("Y")
        if x is None or y is None or len(x) < 2 or len(y) < 2:
            return 0
        tx = op.attr("transpose_X", op.attr("trans_x", False))
        ty = op.attr("transpose_Y", op.attr("trans_y", False))
        m, k = (x[-1], x[-2]) if tx else (x[-2], x[-1])
        n = y[-2] if ty else y[-1]
        lead = max(math.prod(x[:-2]), math.prod(y[:-2]))
        return 2 * lead * m * k * n
    if t == "flash_attention_qkv":
        qkv = shp("QKV")
        if qkv is None:
            return 0
        B, S, H3 = qkv
        # Q K^T and P V over every (query, key) pair
        return 4 * B * S * S * (H3 // 3)
    if t in ("flash_attention", "cached_attention"):
        q, k = shp("Q"), shp("K")
        if q is None or k is None or len(q) != 4 or len(k) != 4:
            return 0
        B, H, Sq, D = q
        pairs = Sq * k[2]
        if op.attr("causal", False):
            pairs = Sq * (Sq + 1) // 2 + Sq * max(k[2] - Sq, 0)
        return 4 * B * H * pairs * D
    return 0


def program_flops(block, batch: Optional[int] = None) -> int:
    """Flops of one run of `block`'s product and attention ops, the batch
    dimension (every declared -1) taken as `batch`."""
    return sum(_op_flops(op, block, batch) for op in block.ops)


def step_manifest(step, signature=None) -> Optional[dict]:
    """The manifest of one compiled step (``CompiledStep``) at its feed
    signature::

        {"signature": str|None,
         "flops": int,              # products and attention, per run
         "weight_bytes": int,       # state the step reads
         "feed_bytes": int, "fetch_bytes": int,
         "bytes_accessed": int,     # weights + feeds + fetches
         "peak_bytes": int|None}    # the CUDA graph's pool (None before
                                    # a capture, and on the CPU)

    None when the step cannot be priced.  Never raises."""
    try:
        block = step.block
        sig = step.sig if signature is None else signature
        batch = None
        feed_bytes = 0
        if sig:
            import torch

            # a Predictor's signature holds ((dims...), "torch.<dtype>")
            # a feed, an Executor's (name, (dims...), "torch.<dtype>");
            # the leading dim of the first feed is the batch
            feeds = [f[-2:] for f in sig]
            batch = int(feeds[0][0][0]) if feeds[0][0] else None
            for shape, dtype in feeds:
                itemsize = getattr(torch, str(dtype).split(".")[-1]).itemsize
                feed_bytes += math.prod(shape) * itemsize
        weight_bytes = sum(_nbytes(block, n, batch) for n in step.state_in)
        fetch_bytes = sum(_nbytes(block, n, batch)
                          for n in step.fetch_names)
        return {"signature": None if sig is None else str(sig),
                "flops": int(program_flops(block, batch)),
                "weight_bytes": int(weight_bytes),
                "feed_bytes": int(feed_bytes),
                "fetch_bytes": int(fetch_bytes),
                "bytes_accessed": int(weight_bytes + feed_bytes
                                      + fetch_bytes),
                "peak_bytes": step.pool_bytes}
    except Exception as e:  # noqa: BLE001 — pricing never breaks a run
        logger.debug("step manifest unavailable: %s", e)
        return None


def manifest_summary(manifest: Optional[dict]) -> Optional[dict]:
    """The compact (``/statusz`` / ``cache_info``) view of a manifest:
    flops, bytes accessed, peak bytes only."""
    if not manifest:
        return None
    return {k: manifest[k] for k in ("flops", "bytes_accessed",
                                     "peak_bytes") if k in manifest}


# ---------------------------------------------------------------------------
# achieved efficiency gauges
# ---------------------------------------------------------------------------

_peaks_cache: Dict[str, Any] = {}
_peaks_lock = threading.Lock()


def _cached_peaks() -> Dict[str, Any]:
    """device_peaks() for the hot path: resolved once per process unless
    an override flag changes."""
    key = (flag_value("FLAGS_device_peak_flops"),
           flag_value("FLAGS_device_peak_bw"))
    with _peaks_lock:
        if _peaks_cache.get("key") != key:
            _peaks_cache["key"] = key
            _peaks_cache["peaks"] = device_peaks()
        return _peaks_cache["peaks"]


def publish_achieved(manifest: Optional[dict], execs_per_sec: float,
                     n_devices: int = 1) -> Optional[dict]:
    """Feed the live efficiency gauges from one step's manifest and its
    measured execution rate: ``device_mfu`` and ``device_bw_util``, per
    card.  Returns the computed dict, or None when there is nothing to
    compute (no manifest, no rate, an unknown card, telemetry off)."""
    from . import telemetry

    if not manifest or execs_per_sec <= 0 or not telemetry.enabled():
        return None
    peaks = _cached_peaks()
    out = {}
    flops = manifest.get("flops")
    if flops and peaks["peak_flops"]:
        out["mfu"] = mfu(flops * execs_per_sec / max(n_devices, 1),
                         peak=peaks["peak_flops"])
        telemetry.gauge_set("device_mfu", out["mfu"])
    ba = manifest.get("bytes_accessed")
    if ba and peaks["peak_bw"]:
        out["bw_util"] = bw_util(ba * execs_per_sec / max(n_devices, 1),
                                 peak=peaks["peak_bw"])
        telemetry.gauge_set("device_bw_util", out["bw_util"])
    return out or None
