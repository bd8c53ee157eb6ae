"""Rotary position embedding op ``rope``.

Counterpart of ``paddle_tpu/ops/rope_ops.py``: X [B, H, S, D] (D even)
rotates the pairs (x[..., :D/2], x[..., D/2:]) by position-dependent
angles, the 'rotate_half' convention.  Positions are the static
``position_offset`` attr + 0..S-1, or, with the optional ``Offset`` input
[B] (int), ``offset[b]`` + 0..S-1 per row (cached decode).  Both branches
compute the angle ``pos * inv_freq`` in float32 with one rounding, as the
JAX package does, so a token rotated at decode position p equals the same
token rotated at position p of a full forward.

The rotation runs on the [B, S, H, D] view of X and writes [B, S, H, D]
memory, returned as its [B, H, S, D] view: q and k leave the op as views
of a heads-merged buffer, which the attention kernels read through their
strides.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register_op, same_as_input

_INV_FREQ = {}


def _inv_freq(base, half, device):
    """1 / base ** (i / half) for i < half: float64 in numpy, rounded to
    float32, as jnp takes it.  Cached per device: a copy from pageable
    host memory on every call would make the host wait for the card."""
    key = (float(base), half, device)
    if key not in _INV_FREQ:
        _INV_FREQ[key] = torch.as_tensor(
            1.0 / (base ** (np.arange(0, half) / half)), dtype=torch.float32,
            device=device)
    return _INV_FREQ[key]


@register_op("rope", infer=same_as_input(), grad="auto")
def _rope(ctx, op):
    x = ctx.get_input(op, "X")
    base = op.attr("base", 10000.0)
    pos_offset = op.attr("position_offset", 0)
    B, H, S, D = x.shape
    half = D // 2
    inv_freq = _inv_freq(base, half, x.device)
    offset = ctx.get_input(op, "Offset") if op.single_input("Offset") \
        else None
    if offset is None:
        pos = torch.arange(pos_offset, pos_offset + S, dtype=torch.float32,
                           device=x.device)
        freqs = torch.outer(pos, inv_freq)[None, :, None]    # [1,S,1,half]
    else:
        pos = offset.to(torch.float32)[:, None] + torch.arange(
            S, dtype=torch.float32, device=x.device)[None, :]  # [B, S]
        freqs = (pos[..., None] * inv_freq)[:, :, None]      # [B,S,1,half]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    xf = x.transpose(1, 2).float()                           # [B,S,H,D]
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    ctx.set_output(op, "Out", out.to(x.dtype).transpose(1, 2))
