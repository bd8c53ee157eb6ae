"""Device-memory introspection and allocator configuration.

The port's copy of ``paddle_tpu/memory.py``, on the CUDA caching
allocator's stats (``torch.cuda.memory_stats``) where the reference
reads PJRT's: live and peak bytes, the pool's reservation, the card's
capacity and a peak window that can be reset between phases; and the
strategy knob (reference memory/allocation/allocator_strategy.h:21,
``FLAGS_allocator_strategy`` / ``FLAGS_fraction_of_gpu_memory_to_use``).

Devices as everywhere in the port: ``device=None`` is the card
(``cuda:0``) and raises where there is none; ``device="cpu"`` (or
``CPUPlace()``) has no allocator stats and reports zeros, as the
reference reports them on its CPU backend.

The strategies map onto ``PYTORCH_CUDA_ALLOC_CONF``, which the caching
allocator reads once, at the first CUDA allocation: ``auto_growth`` and
``thread_local`` grow segments on demand (``expandable_segments:True``),
``naive_best_fit`` keeps the allocator's fixed-size segments.  The
memory fraction caps the process's share of the card
(``torch.cuda.set_per_process_memory_fraction``, where there is one).
Set after the allocator is up, the strategy applies to the next process,
and the call warns, as the reference's does.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional

from .flags import get_flags, register_flag, set_flags

__all__ = [
    "memory_stats",
    "memory_allocated",
    "max_memory_allocated",
    "memory_reserved",
    "device_memory_capacity",
    "reset_peak",
    "set_allocator_strategy",
    "get_allocator_strategy",
]

register_flag("FLAGS_fraction_of_gpu_memory_to_use", 0.92,
              "fraction of HBM the allocator may reserve")
register_flag("FLAGS_allocator_strategy", "auto_growth",
              "naive_best_fit | auto_growth | thread_local "
              "(memory/allocation/allocator_strategy.h)")

# reference memory/allocation/allocator_strategy.h:21
_STRATEGIES = ("naive_best_fit", "auto_growth", "thread_local")
_ALLOC_CONF = {"naive_best_fit": "expandable_segments:False",
               "auto_growth": "expandable_segments:True",
               "thread_local": "expandable_segments:True"}


def _device(device):
    """The torch device `device` names (None: the card); None for the CPU,
    which has no allocator stats."""
    from .device import resolve_device

    dev = resolve_device(device)
    return dev if dev.type == "cuda" else None


def set_allocator_strategy(strategy: str,
                           memory_fraction: Optional[float] = None):
    """Configure the card's allocator.  Must run before the first CUDA
    allocation; afterwards it warns that the strategy applies to the
    next process.  The fraction, a cap, applies at once where there is a
    card."""
    import torch

    if strategy not in _STRATEGIES:
        raise ValueError(
            f"unknown allocator strategy {strategy!r}; expected one of "
            f"{_STRATEGIES}")
    set_flags({"FLAGS_allocator_strategy": strategy})
    if memory_fraction is not None:
        set_flags(
            {"FLAGS_fraction_of_gpu_memory_to_use": float(memory_fraction)})
    if torch.cuda.is_initialized():
        warnings.warn(
            "set_allocator_strategy called after device initialization; "
            "the strategy applies to the next process, not this one")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = _ALLOC_CONF[strategy]
    if memory_fraction is not None and torch.cuda.is_available():
        # starts the allocator (with the strategy just set, if it was not
        # up yet)
        torch.cuda.set_per_process_memory_fraction(float(memory_fraction))


def get_allocator_strategy() -> str:
    return get_flags(["FLAGS_allocator_strategy"])[
        "FLAGS_allocator_strategy"]


def memory_stats(device=None) -> Dict[str, int]:
    """The caching allocator's stats for one card
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
    ``reserved_bytes.all.peak``, ``num_alloc_retries``, ...); empty for
    the CPU."""
    import torch

    dev = _device(device)
    return {} if dev is None else dict(torch.cuda.memory_stats(dev))


def memory_allocated(device=None) -> int:
    """Live bytes the allocator has handed out (reference STAT gpu_mem
    counter, platform/monitor.h:130)."""
    import torch

    dev = _device(device)
    return 0 if dev is None else int(torch.cuda.memory_allocated(dev))


def max_memory_allocated(device=None) -> int:
    """Peak allocated bytes since process start or the last
    ``reset_peak``."""
    import torch

    dev = _device(device)
    return 0 if dev is None else int(torch.cuda.max_memory_allocated(dev))


def memory_reserved(device=None) -> int:
    """Bytes the allocator holds from the card (>= allocated)."""
    import torch

    dev = _device(device)
    return 0 if dev is None else int(torch.cuda.memory_reserved(dev))


def device_memory_capacity(device=None) -> int:
    """The card's memory (bytes)."""
    import torch

    dev = _device(device)
    return 0 if dev is None else int(
        torch.cuda.get_device_properties(dev).total_memory)


def reset_peak(device=None):
    """Start a new peak window (reference resets its monitor STAT between
    profiling phases): the peak becomes the live bytes."""
    import torch

    dev = _device(device)
    if dev is not None:
        torch.cuda.reset_peak_memory_stats(dev)
