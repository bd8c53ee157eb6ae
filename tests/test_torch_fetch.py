"""bfloat16 fetches as numpy, in both packages.

The JAX package returns each fetch through np.asarray, which gives a
bfloat16 array (numpy's ml_dtypes.bfloat16) for a bfloat16 value.  The
port returns the same dtype with the same bits: Executor.run and
Predictor.run with return_numpy=True, and io's saved parameters.

* A white-list grad of a small bf16-AMP BERT training step (the
  test_torch_train configuration), one step from the JAX startup scope
  carried across: the shape and dtype of the JAX package's fetch, values
  within 2e-2 of its largest value (bf16 keeps 8 mantissa bits, 0.4% a
  rounding, and the two packages sum in other orders, as the bf16 loss
  band of test_torch_train).
* A bf16 output of Predictor.run: within one bf16 ulp (2**-8 relative).
* A bf16 numpy array goes back in bit for bit (feeds, loaded parameters).
"""
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import clip as j_clip
from paddle_tpu import optimizer as j_opt
from paddle_tpu.contrib import mixed_precision as j_mp
from paddle_tpu.framework.core import reset_unique_name as j_reset_names
from paddle_tpu.models import build_bert_pretrain as j_build
from paddle_tpu.ops.registry import reset_op_seed as j_reset_seed
from paddle_tpu_torch import clip as t_clip
from paddle_tpu_torch import optimizer as t_opt
from paddle_tpu_torch.contrib import mixed_precision as t_mp
from paddle_tpu_torch.framework.executor import to_numpy, to_tensor
from paddle_tpu_torch.interop import scope_from_arrays
from paddle_tpu_torch.models import build_bert_pretrain as t_build
from paddle_tpu_torch.ops.registry import reset_op_seed as t_reset_seed

B, S, V, P = 4, 32, 97, 5
CFG = dict(batch_size=B, seq_len=S, vocab_size=V, hidden=128, num_layers=2,
           num_heads=2, intermediate=256, max_predictions=P)
EXTRA_WHITE = ["lookup_table", "layer_norm", "elementwise_add",
               "elementwise_mul", "gelu", "scale", "transpose2", "reshape2",
               "flash_attention_qkv", "softmax"]
BF16_GRAD_RTOL = 2e-2
# white-list grads: the first fc's weight, the QKV projection's output
GRADS = ["fc_0.w_0@GRAD", "fc_4.tmp_1@GRAD"]


def _build(pkg):
    if pkg is jpt:
        j_reset_names()
        j_reset_seed()
        build, clip, opt, mp = j_build, j_clip, j_opt, j_mp
    else:
        tpt.reset_unique_name()
        t_reset_seed()
        build, clip, opt, mp = t_build, t_clip, t_opt, t_mp
    main, startup = pkg.Program(), pkg.Program()
    startup._is_startup = True
    with pkg.program_guard(main, startup), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the flash path's dropout note
        feeds, outs = build(dropout=0.0, **CFG)
        o = opt.AdamOptimizer(learning_rate=1e-3,
                              grad_clip=clip.GradientClipByGlobalNorm(1.0))
        o = mp.decorate(o, dtype="bfloat16",
                        amp_lists=mp.AutoMixedPrecisionLists(
                            custom_white_list=EXTRA_WHITE))
        o.minimize(outs["loss"])
    return main, startup, outs["loss"].name


def _feed():
    rng = np.random.RandomState(0)
    mask = np.ones((B, S), "float32")
    mask[1, 20:] = 0.0
    return {"input_ids": rng.randint(0, V, (B, S)).astype("int64"),
            "token_type_ids": (rng.rand(B, S) > 0.5).astype("int64"),
            "attn_mask": mask,
            "mlm_positions": rng.randint(0, S, (B, P)).astype("int64"),
            "mlm_labels": rng.randint(0, V, (B, P)).astype("int64"),
            "mlm_weights": np.ones((B, P), "float32")}


@pytest.fixture(scope="module")
def amp_fetches():
    """One bf16-AMP step in each package from one startup scope: the
    loss and GRADS, fetched with return_numpy=True."""
    j_main, j_startup, loss = _build(jpt)
    t_main, _, _ = _build(tpt)
    j_scope = jpt.Scope()
    jpt.Executor().run(j_startup, scope=j_scope)
    arrays = {n: np.asarray(j_scope.find_var(n))
              for n in j_scope.local_var_names()}
    t_scope = scope_from_arrays(arrays, "cpu", program=t_main)
    fetch = [loss] + GRADS
    want = [np.asarray(x) for x in jpt.Executor().run(
        j_main, feed=_feed(), fetch_list=fetch, scope=j_scope)]
    got = tpt.Executor(tpt.CPUPlace()).run(t_main, feed=_feed(),
                                           fetch_list=fetch, scope=t_scope)
    return dict(zip(fetch, zip(got, want)))


@pytest.mark.parametrize("name", GRADS)
def test_bf16_grad_fetch_matches_the_jax_fetch(amp_fetches, name):
    got, want = amp_fetches[name]
    assert want.dtype == ml_dtypes.bfloat16  # the reference's own fetch
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.astype(np.float32), want.astype(np.float32)
    top = np.abs(w).max()
    assert top > 0 and np.isfinite(g).all()
    assert np.abs(g - w).max() <= BF16_GRAD_RTOL * top


def test_fp32_loss_fetch_is_unchanged(amp_fetches):
    got, want = next(iter(amp_fetches.values()))
    assert got.dtype == want.dtype == np.float32


def _cast_program(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.scale(pkg.layers.cast(x, "bfloat16"), scale=3.0)
    return main, y


def test_predictor_returns_bf16_outputs_as_the_jax_predictor_does():
    x = np.random.RandomState(1).randn(4, 6).astype("float32")
    outs = []
    for pkg, kw in ((jpt, {}), (tpt, {"device": "cpu"})):
        main, y = _cast_program(pkg)
        pred = pkg.inference.Predictor(main, ["x"], [y], scope=pkg.Scope(),
                                       **kw)
        outs.append(np.asarray(pred.run({"x": x})[0]))
    got, want = outs
    assert want.dtype == ml_dtypes.bfloat16
    assert got.dtype == want.dtype and got.shape == want.shape == (4, 6)
    g, w = got.astype(np.float32), want.astype(np.float32)
    assert np.all(np.abs(g - w) <= 2.0 ** -8 * np.abs(w))


def test_bf16_numpy_round_trips_bit_for_bit():
    t = torch.from_numpy(np.random.RandomState(2).randn(3, 5).astype(
        "float32")).to(torch.bfloat16)
    a = to_numpy(t.t())  # a strided view too
    assert a.dtype == ml_dtypes.bfloat16 and a.shape == (5, 3)
    np.testing.assert_array_equal(a.astype(np.float32), t.t().float().numpy())
    back = to_tensor(a, torch.device("cpu"))
    assert back.dtype == torch.bfloat16 and torch.equal(back, t.t())
