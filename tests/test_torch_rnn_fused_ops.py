"""The fused recurrences in the port (``ops/rnn_fused_ops.py``: ``lstm``,
``lstmp``, ``gru``, ``rnn``, ``cudnn_lstm``) against the JAX package, on
the CPU.

* Twins of tests/test_rnn_fused_ops.py: its own ``OpCase``s (the
  reference's numpy step loops as ``ref``) built in the JAX package and
  run in the port; outputs and grads within each case's rtol 1e-4 / atol
  1e-5 of the JAX package's, and of the numpy reference.
* Each op keeps its own gate layout and its own output past a row's end:
  more cases over H0 / C0, a Bias on ``gru``, ``lstmp``'s identity
  projection, ``rnn``'s four modes, two layers and both directions; the
  fused ops output zeros past a row's length.
* ``rnn``'s dropout between layers: at rate 0 equal to the JAX package
  within the case's limits; above it, each layer draws its own mask (a
  keep rate within 5 sigma of 1 - p, and the second layer's mask is not
  the first's), where the JAX package draws one mask for every layer.
"""
import numpy as np
import pytest

import test_rnn_fused_ops as ref
from op_test import OpCase
from torch_op_util import check_case, run_both

R = np.random.RandomState
TOL = dict(rtol=1e-4, atol=1e-5)


def _reference_cases(fn, *args):
    """The OpCases a test of tests/test_rnn_fused_ops.py runs."""
    cases = []
    saved = ref.run_case
    ref.run_case = cases.append
    try:
        fn(*args)
    finally:
        ref.run_case = saved
    return cases


REFERENCE = (
    _reference_cases(ref.test_lstm_forward_backward)
    + _reference_cases(ref.test_lstm_reverse_and_peepholes)
    + _reference_cases(ref.test_lstmp)
    + [c for o in (False, True) for c in _reference_cases(ref.test_gru, o)]
    + _reference_cases(ref.test_rnn_bidirectional_lstm)
    + _reference_cases(ref.test_rnn_two_layer_gru)
    + _reference_cases(ref.test_cudnn_lstm_alias))


def _ids(cases):
    return [f"{c.name}{i}" for i, c in enumerate(cases)]


@pytest.mark.parametrize("case", REFERENCE, ids=_ids(REFERENCE))
def test_reference_case_follows_jax_and_numpy(case):
    got = check_case(case)
    if case.ref is None:
        return
    want = case.ref()
    if not isinstance(want, dict):
        want = {next(iter(case.outputs)): want}
    for i, slot in enumerate(case.outputs):
        if slot in want:
            np.testing.assert_allclose(np.asarray(got[i]), want[slot],
                                       rtol=case.rtol, atol=case.atol,
                                       err_msg=f"{case.name}: {slot}")


B, T, H, D = 3, 5, 4, 3
LEN = np.array([5, 2, 4], "int64")


def _r(seed, *shape, scale=0.3):
    return (R(seed).randn(*shape) * scale).astype("float32")


def _weights(mode, layers, ndir, seed=30):
    k = {"LSTM": 4, "GRU": 3}.get(mode, 1)
    ws, rr = [], R(seed)
    for layer in range(layers):
        din = D if layer == 0 else H * ndir
        for _ in range(ndir):
            ws += [(rr.randn(din, k * H) * 0.3).astype("float32"),
                   (rr.randn(H, k * H) * 0.3).astype("float32"),
                   (rr.randn(k * H) * 0.1).astype("float32"),
                   (rr.randn(k * H) * 0.1).astype("float32")]
    return ws


def _rnn_case(mode, layers, bidirec, name, drop=0.0):
    outs = {"Out": 1, "LastH": 1}
    if mode == "LSTM":
        outs["LastC"] = 1
    return OpCase("rnn", {"Input": _r(31, B, T, D, scale=0.5),
                          "WeightList": _weights(mode, layers,
                                                 2 if bidirec else 1),
                          "Lengths": LEN},
                  outputs=outs, attrs={"mode": mode, "hidden_size": H,
                                       "num_layers": layers,
                                       "is_bidirec": bidirec,
                                       "dropout_prob": drop},
                  grad=["Input", "WeightList"], name=name, **TOL)


LAYOUTS = [
    OpCase("lstm", {"Input": _r(40, B, T, 4 * H), "Weight": _r(41, H, 4 * H),
                    "Bias": _r(42, 4 * H, scale=0.1), "Lengths": LEN,
                    "H0": _r(43, B, H), "C0": _r(44, B, H)},
           outputs={"Hidden": 1, "Cell": 1}, grad=["Input", "Weight",
                                                    "Bias", "H0", "C0"],
           name="lstm_h0_c0", **TOL),
    OpCase("lstm", {"Input": _r(45, B, T, 4 * H), "Weight": _r(46, H, 4 * H),
                    "Bias": _r(47, 7 * H, scale=0.1), "Lengths": LEN},
           outputs={"Hidden": 1, "Cell": 1},
           attrs={"use_peepholes": True, "is_reverse": False},
           grad=["Input", "Weight", "Bias"], name="lstm_peepholes", **TOL),
    OpCase("lstmp", {"Input": _r(48, B, T, 4 * H), "Weight": _r(49, 3, 4 * H),
                     "ProjWeight": _r(50, H, 3),
                     "Bias": _r(51, 7 * H, scale=0.1), "Lengths": LEN},
           outputs={"Projection": 1, "Cell": 1},
           attrs={"use_peepholes": True, "is_reverse": True,
                  "proj_activation": "identity"},
           grad=["Input", "Weight", "ProjWeight", "Bias"],
           name="lstmp_identity_peepholes_reverse", **TOL),
] + [
    OpCase("gru", {"Input": _r(52, B, T, 3 * H), "Weight": _r(53, H, 3 * H),
                   "Bias": _r(54, 3 * H, scale=0.1), "H0": _r(55, B, H),
                   "Lengths": LEN},
           outputs={"Hidden": 1}, attrs={"origin_mode": o,
                                         "is_reverse": True},
           grad=["Input", "Weight", "Bias", "H0"],
           name=f"gru_bias_h0_reverse_origin_{o}", **TOL)
    for o in (False, True)
] + [
    _rnn_case("LSTM", 2, True, "rnn_lstm_2_layers_bidirectional"),
    _rnn_case("GRU", 2, True, "rnn_gru_2_layers_bidirectional"),
    _rnn_case("RNN_TANH", 2, True, "rnn_tanh_2_layers_bidirectional"),
    _rnn_case("RNN_RELU", 2, False, "rnn_relu_2_layers"),
    _rnn_case("GRU", 3, False, "rnn_gru_3_layers_dropout_0", drop=0.0),
]


@pytest.mark.parametrize("case", LAYOUTS, ids=[c.name for c in LAYOUTS])
def test_layout_case_follows_jax(case):
    check_case(case)


@pytest.mark.parametrize("case", LAYOUTS[:5] + LAYOUTS[5:7],
                         ids=[c.name for c in LAYOUTS[:5] + LAYOUTS[5:7]])
def test_fused_ops_output_zeros_past_a_rows_end(case):
    """The fused ops zero their per-step outputs past a row's length
    (lstm_rnn / gru_rnn repeat the frozen state instead)."""
    _, got, names = run_both(case)
    for name, out in zip(names, got):
        if not name.startswith("out_") or "Last" in name:
            continue
        for b, n in enumerate(LEN):
            assert not np.asarray(out)[b, n:].any(), (case.name, name, b)
            assert np.asarray(out)[b, :n].any(), (case.name, name, b)


P = 0.5
NB, NH = 64, 64


def _dropout_case(layers):
    """RNN_RELU at identity input weights and no recurrence, positive
    inputs: layer l's output is the input masked by every mask before it
    and scaled by 1 / (1 - p) each; LastH[l] (one step) exposes layer l's
    output, so the masks of layers 0 and 1 are read from it."""
    ws = []
    for _ in range(layers):
        ws += [np.eye(NH, dtype="float32"),
               np.zeros((NH, NH), "float32"), np.zeros(NH, "float32"),
               np.zeros(NH, "float32")]
    x = R(60).uniform(0.5, 1.5, (NB, 1, NH)).astype("float32")
    return OpCase("rnn", {"Input": x, "WeightList": ws,
                          "Lengths": np.ones(NB, "int64")},
                  outputs={"Out": 1, "LastH": 1},
                  attrs={"mode": "RNN_RELU", "hidden_size": NH,
                         "num_layers": layers, "dropout_prob": P},
                  name=f"rnn_dropout_{layers}_layers"), x


def _masks(last_h):
    """(layer 0's mask, layer 1's mask where layer 0 kept) from LastH."""
    m0 = np.asarray(last_h)[1] != 0
    m1 = np.asarray(last_h)[2][m0] != 0
    return m0, m1


def test_rnn_dropout_draws_a_mask_a_layer():
    case, x = _dropout_case(3)
    want, got, _ = run_both(case)
    n = NB * NH
    bound = 5 * np.sqrt(P * (1 - P) / n)
    m0, m1 = _masks(got[1])
    # each layer's keep rate near 1 - p; the second mask is not the first
    assert abs(m0.mean() - (1 - P)) < bound, m0.mean()
    assert abs(m1.mean() - (1 - P)) < 5 * np.sqrt(P * (1 - P) / m1.size), \
        m1.mean()
    # kept elements are the input scaled once a layer
    out = np.asarray(got[0])[:, 0]
    kept = out != 0
    np.testing.assert_allclose(out[kept], x[:, 0][kept] / (1 - P) ** 2,
                               rtol=1e-6)
    # the JAX package draws one mask for all: its second layer keeps
    # exactly what its first kept
    j0, j1 = _masks(want[1])
    assert abs(j0.mean() - (1 - P)) < bound and j1.all()
    # the port's layers are not the reference's one mask: a quarter of the
    # elements survive both layers, not a half
    assert abs(kept.mean() - (1 - P) ** 2) < bound, kept.mean()


def test_rnn_dropout_draws_anew_each_run_and_alike_at_a_run_count():
    """Masks follow the run count (ops/registry.py run_seed): a second run
    of one executor draws other masks, a fresh executor at the same run
    count the same."""
    import json

    import paddle_tpu_torch as tpt
    from op_test import _build
    from paddle_tpu.framework.serde import program_to_json
    from paddle_tpu_torch.framework.serde import program_from_json

    case, _ = _dropout_case(2)
    main, startup, feed, outs, _ = _build(case, with_loss=False)
    t_main = program_from_json(program_to_json(main))
    assert json.loads(program_to_json(main))["blocks"][0]["ops"][0][
        "attrs"]["dropout_prob"] == P
    runs = []
    for _ in range(2):
        exe = tpt.Executor(tpt.CPUPlace())
        scope = tpt.Scope()
        runs.append([exe.run(t_main, feed=feed, fetch_list=outs,
                             scope=scope)[0] for _ in range(2)])
    assert not np.array_equal(runs[0][0], runs[0][1])
    assert np.array_equal(runs[0][0], runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1])
