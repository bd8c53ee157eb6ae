"""White/black op lists for autocast, as in
``paddle_tpu/contrib/mixed_precision/fp16_lists.py``.  White = run in low
precision (matrix products); black = keep float32 (reductions, losses,
normalisation statistics); every other op runs in whatever precision its
inputs carry."""
from __future__ import annotations

white_list = {
    "conv2d", "conv2d_transpose", "depthwise_conv2d",
    "matmul", "matmul_v2", "mul", "bmm", "dot",
    "fused_attention", "flash_attention",
}

black_list = {
    "softmax_with_cross_entropy", "cross_entropy", "bce_loss",
    "sigmoid_cross_entropy_with_logits", "kldiv_loss", "huber_loss",
    "mse_loss", "smooth_l1_loss",
    "mean", "reduce_mean", "reduce_sum", "logsumexp", "sum",
    "exp", "log", "log2", "log10", "log1p", "rsqrt", "pow",
    "softmax", "log_softmax",
    "squared_l2_norm", "norm", "p_norm", "clip_by_norm",
    "cumsum", "erf",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.black_varnames = set(custom_black_varnames or [])
        for t in custom_white_list or []:
            self.black_list.discard(t)
            self.white_list.add(t)
        for t in custom_black_list or []:
            self.white_list.discard(t)
            self.black_list.add(t)
