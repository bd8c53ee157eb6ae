"""Gradient clipping: ``GradientClipByGlobalNorm``, static graph.

Counterpart of ``paddle_tpu/clip.py:92-139``.  ``Optimizer.apply_gradients``
calls the clip between backward and the update ops; the clip appends graph
ops (role Optimize): per gradient ``elementwise_mul`` + ``reduce_sum``,
then ``sum``, ``sqrt``, ``elementwise_max`` and ``elementwise_div`` for the
scale, and one ``elementwise_mul`` per gradient.  The JAX package's
``PT_FUSED_GLOBAL_CLIP`` opt-in, the other clips and the dygraph branch
wait for a later slice.
"""
from __future__ import annotations

import os

from .framework.core import OpRole, op_role_guard

__all__ = ["GradientClipBase", "GradientClipByGlobalNorm", "ClipByGlobalNorm"]


class GradientClipBase:
    def __call__(self, params_grads):
        with op_role_guard(OpRole.Optimize):
            return self._static_clip(params_grads)

    def _static_clip(self, params_grads):
        raise NotImplementedError


class GradientClipByGlobalNorm(GradientClipBase):
    """Scale ALL gradients by clip_norm / max(global_norm, clip_norm),
    global_norm = sqrt(sum_i ||g_i||^2)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _static_clip(self, params_grads):
        from .layers import nn
        from .layers import tensor as T
        if os.environ.get("PT_FUSED_GLOBAL_CLIP", "0") == "1":
            raise NotImplementedError(
                "PT_FUSED_GLOBAL_CLIP=1 (the global_norm_sq op) is not "
                "ported yet")
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "trainable", True)]
        if not grads:
            return params_grads
        sq_sums = [T.reduce_sum(T.elementwise_mul(g, g)) for g in grads]
        norm = nn.sqrt(T.sums(sq_sums))
        clip_var = T.fill_constant([1], "float32", self.clip_norm)
        scale_var = T.elementwise_div(
            clip_var, T.elementwise_max(norm, clip_var))
        out = []
        for p, g in params_grads:
            if g is None or not getattr(p, "trainable", True):
                out.append((p, g))
                continue
            out.append((p, T.elementwise_mul(g, scale_var)))
        return out


ClipByGlobalNorm = GradientClipByGlobalNorm
