"""Gradient clipping, static graph: ``GradientClipByValue``,
``GradientClipByNorm``, ``GradientClipByGlobalNorm`` and
``set_gradient_clip``.

Counterpart of ``paddle_tpu/clip.py:38-169``.  ``Optimizer.apply_gradients``
calls the clip (the optimizer's ``grad_clip``, else the program's from
``set_gradient_clip``) between backward and the update ops; the clip
appends graph ops (role Optimize).  ByValue: one ``clip`` a gradient.
ByNorm: one ``clip_by_norm`` a gradient.  ByGlobalNorm: per gradient
``elementwise_mul`` + ``reduce_sum``, then ``sum`` (or, with
``PT_FUSED_GLOBAL_CLIP=1``, one ``global_norm_sq`` over every gradient),
``sqrt``, ``elementwise_max`` and ``elementwise_div`` for the scale, and
one ``elementwise_mul`` per gradient.  The dygraph branch waits for a
later slice.
"""
from __future__ import annotations

import os

from .framework.core import OpRole, op_role_guard

__all__ = ["GradientClipBase", "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "set_gradient_clip", "ClipByValue",
           "ClipByNorm", "ClipByGlobalNorm"]


class GradientClipBase:
    def __call__(self, params_grads):
        with op_role_guard(OpRole.Optimize):
            return self._static_clip(params_grads)

    def _static_clip(self, params_grads):
        raise NotImplementedError


def _each_grad(params_grads, fn):
    """(p, fn(g)) for each trainable parameter's gradient, the rest as they
    are."""
    return [(p, g) if g is None or not getattr(p, "trainable", True)
            else (p, fn(g)) for p, g in params_grads]


class GradientClipByValue(GradientClipBase):
    """Clip each gradient elementwise into [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _static_clip(self, params_grads):
        from .layers import tensor as T
        return _each_grad(params_grads,
                          lambda g: T.clip(g, self.min, self.max))


class GradientClipByNorm(GradientClipBase):
    """Per-gradient L2-norm clip: g * clip_norm / max(||g||, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _static_clip(self, params_grads):
        from .layers import nn
        return _each_grad(params_grads,
                          lambda g: nn.clip_by_norm(g, self.clip_norm))


class GradientClipByGlobalNorm(GradientClipBase):
    """Scale ALL gradients by clip_norm / max(global_norm, clip_norm),
    global_norm = sqrt(sum_i ||g_i||^2)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _static_clip(self, params_grads):
        from .framework.layer_helper import LayerHelper
        from .layers import nn
        from .layers import tensor as T
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "trainable", True)]
        if not grads:
            return params_grads
        if os.environ.get("PT_FUSED_GLOBAL_CLIP", "0") == "1":
            helper = LayerHelper("global_norm")
            sq = helper.create_variable_for_type_inference("float32")
            helper.append_op("global_norm_sq",
                             inputs={"X": [g.name for g in grads]},
                             outputs={"Out": [sq.name]}, attrs={})
            norm = nn.sqrt(sq)
        else:
            sq_sums = [T.reduce_sum(T.elementwise_mul(g, g)) for g in grads]
            norm = nn.sqrt(T.sums(sq_sums))
        clip_var = T.fill_constant([1], "float32", self.clip_norm)
        scale_var = T.elementwise_div(
            clip_var, T.elementwise_max(norm, clip_var))
        return _each_grad(params_grads,
                          lambda g: T.elementwise_mul(g, scale_var))


def set_gradient_clip(clip, param_list=None, program=None):
    """The program's default clip: an optimizer without its own
    ``grad_clip`` applies it in ``apply_gradients``, to `param_list`'s
    parameters only where one is given."""
    from .framework.core import default_main_program
    if clip is not None and not isinstance(clip, GradientClipBase):
        raise TypeError("clip must be a GradientClipBase instance or None")
    program = program or default_main_program()
    program._gradient_clip = clip
    program._gradient_clip_params = (
        [p.name if hasattr(p, "name") else p for p in param_list]
        if param_list else None)


ClipByValue = GradientClipByValue
ClipByNorm = GradientClipByNorm
ClipByGlobalNorm = GradientClipByGlobalNorm
