"""Generation's ops through both packages: the dense KV-cache ops
(``kv_cache_write``, ``kv_cache_insert``, ``cached_attention``),
``arg_max`` / ``arg_min`` and ``flash_attention`` with ``impl="xla"``.

Each case builds the same one-op program in both packages, feeds the same
numpy inputs (a cache is persistable state set in each scope), and
compares the fetches: the cache writes and the arg ops bit for bit, the
attention within rtol 1e-5 / atol 1e-6 (the two packages sum their
products in other orders).  Then the port alone: a write into state
keeps the cache's tensor and ``data_ptr``; a write into a fed cache
leaves the caller's array alone; the xla formulation's in-op dropout
keeps its rate; the xla formulation under sequence parallelism raises.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt

R = np.random.RandomState(4321)


def _f(*shape):
    return R.randn(*shape).astype("float32")


def _run(pkg, op_type, inputs, outputs, attrs, fetch, state=None,
         scope=None):
    """One-op program: `inputs` ({slot: {name: array}}) are fed, except
    the names in `state` ({name: array}), which are persistable vars set
    in the scope.  Returns the `fetch` values as numpy."""
    main = pkg.Program()
    block = main.global_block()
    scope = scope if scope is not None else pkg.Scope()
    state = state or {}
    feed = {}
    for slot, named in inputs.items():
        for name, arr in named.items():
            if name in state:
                block.create_var(name=name, shape=list(arr.shape),
                                 dtype=str(arr.dtype), persistable=True)
                scope.set_var(name, arr.copy())
            else:
                block.create_var(name=name, shape=list(arr.shape),
                                 dtype=str(arr.dtype), is_data=True)
                feed[name] = arr
    block.append_op(op_type,
                    inputs={s: list(n) for s, n in inputs.items()},
                    outputs={s: list(n) for s, n in outputs.items()},
                    attrs=dict(attrs))
    exe = pkg.Executor(pkg.CPUPlace())
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)


def _write_case(T, positions, B=3, Hkv=2, S=8, D=4):
    cache = _f(B, Hkv, S, D)
    return ({"Cache": {"c": cache}, "New": {"n": _f(B, Hkv, T, D)},
             "Positions": {"p": np.asarray(positions, "int32")}},
            {"Out": ["c"]}, {"c": cache})


def _insert_case(slot, Sb=5, slots=3, Hkv=2, S=8, D=4):
    cache = _f(slots, Hkv, S, D)
    return ({"Cache": {"c": cache}, "New": {"n": _f(1, Hkv, Sb, D)},
             "Slot": {"s": np.asarray([slot], "int32")}},
            {"Out": ["c"]}, {"c": cache})


WRITE_CASES = {
    "kv_cache_write_ragged": ("kv_cache_write", _write_case(1, [0, 3, 7])),
    "kv_cache_write_t3": ("kv_cache_write", _write_case(3, [2, 0, 4])),
    "kv_cache_write_clamp_at_end": ("kv_cache_write",
                                    _write_case(2, [0, 5, 7])),
    "kv_cache_insert_slot1": ("kv_cache_insert", _insert_case(1)),
    "kv_cache_insert_last_slot_full_width": ("kv_cache_insert",
                                             _insert_case(2, Sb=8)),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_cache_writes_match_jax_bit_for_bit(case):
    op_type, (inputs, outputs, state) = WRITE_CASES[case]
    want = _run(jpt, op_type, inputs, outputs, {}, ["c"], state)[0]
    got = _run(tpt, op_type, inputs, outputs, {}, ["c"], state)[0]
    assert got.dtype == np.float32 and got.shape == np.asarray(want).shape
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not np.array_equal(got, state["c"])  # something was written


def _attn_case(B, H, Hkv, T, S, D, positions, scale=None):
    inputs = {"Q": {"q": _f(B, H, T, D)}, "K": {"k": _f(B, Hkv, S, D)},
              "V": {"v": _f(B, Hkv, S, D)},
              "Positions": {"p": np.asarray(positions, "int32")}}
    return inputs, ({} if scale is None else {"scale": scale})


ATTN_CASES = {
    "mha_t1": _attn_case(3, 4, 4, 1, 16, 8, [0, 7, 15]),
    "gqa_t1": _attn_case(3, 4, 2, 1, 16, 8, [5, 0, 15]),
    "gqa4_t1_one_row": _attn_case(1, 4, 1, 1, 16, 8, [9]),
    "mha_t1_one_slot": _attn_case(1, 2, 2, 1, 16, 8, [11]),
    "mha_t3": _attn_case(2, 4, 4, 3, 16, 8, [0, 13]),
    "gqa_t4_scale": _attn_case(2, 4, 2, 4, 16, 8, [3, 12], scale=0.2),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_cached_attention_matches_jax(case):
    inputs, attrs = ATTN_CASES[case]
    want = _run(jpt, "cached_attention", inputs, {"Out": ["o"]}, attrs,
                ["o"])[0]
    got = _run(tpt, "cached_attention", inputs, {"Out": ["o"]}, attrs,
               ["o"])[0]
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


ARG_CASES = {
    # ties: the first index of the extreme value, as jnp.argmax gives it
    "arg_max_ties": ("arg_max", np.array([[1, 3, 3, 0], [2, 2, 2, 2],
                                          [-1, 5, 0, 5]], "float32"),
                     {"axis": -1}),
    "arg_min_ties": ("arg_min", np.array([[1, 0, 3, 0], [2, 2, 2, 2]],
                                         "float32"), {"axis": 1}),
    "arg_max_axis0_keepdims": ("arg_max", _f(5, 3, 2),
                               {"axis": 0, "keepdims": True}),
    "arg_max_flatten": ("arg_max", _f(4, 6), {"flatten": True}),
    "arg_max_int32_out": ("arg_max", _f(3, 7), {"axis": 1,
                                                "dtype": "int32"}),
}


@pytest.mark.parametrize("case", sorted(ARG_CASES))
def test_arg_ops_match_jax(case):
    op_type, x, attrs = ARG_CASES[case]
    want = np.asarray(_run(jpt, op_type, {"X": {"x": x}}, {"Out": ["o"]},
                           attrs, ["o"])[0])
    got = _run(tpt, op_type, {"X": {"x": x}}, {"Out": ["o"]}, attrs,
               ["o"])[0]
    # jax without x64 hands int64 back as int32; the port keeps int64
    assert got.dtype == np.dtype(attrs.get("dtype", "int64"))
    np.testing.assert_array_equal(got, want)


def _xla_case(layout, causal, bias, scale=None, Sq=12, Sk=12, dropout=0.0,
              is_test=False):
    B, H, D = 2, 3, 8
    shape = (lambda S: (B, S, H, D)) if layout == "bshd" else \
        (lambda S: (B, H, S, D))
    inputs = {"Q": {"q": _f(*shape(Sq))}, "K": {"k": _f(*shape(Sk))},
              "V": {"v": _f(*shape(Sk))}}
    if bias:
        inputs["Bias"] = {"b": np.where(R.rand(B, 1, 1, Sk) > 0.3, 0.0,
                                        -1e4).astype("float32")}
    attrs = {"impl": "xla", "layout": layout, "causal": causal,
             "dropout_prob": dropout, "is_test": is_test}
    if scale is not None:
        attrs["scale"] = scale
    return inputs, attrs


XLA_CASES = {
    "bhsd_causal": _xla_case("bhsd", True, False),
    "bhsd_bias": _xla_case("bhsd", False, True, scale=0.3),
    "bhsd_bias_causal": _xla_case("bhsd", True, True),
    "bshd_causal": _xla_case("bshd", True, False),
    "bshd_bias_sq_ne_sk": _xla_case("bshd", False, True, Sq=5, Sk=12),
    # dropout off in a test run, as the reference reads is_test
    "bhsd_dropout_is_test": _xla_case("bhsd", True, False, dropout=0.5,
                                      is_test=True),
}


@pytest.mark.parametrize("case", sorted(XLA_CASES))
def test_flash_attention_xla_matches_jax(case):
    inputs, attrs = XLA_CASES[case]
    want = _run(jpt, "flash_attention", inputs, {"Out": ["o"]}, attrs,
                ["o"])[0]
    got = _run(tpt, "flash_attention", inputs, {"Out": ["o"]}, attrs,
               ["o"])[0]
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_flash_attention_xla_dropout_keeps_its_rate():
    """In-op probability dropout: with q = k = 0 every probability is
    1 / S and v = 1, so a row's output is (kept columns / S) / (1 - p),
    1 on average; 64 rows of 64 columns at p = 0.5 hold it within 5
    sigma, and two runs draw different masks."""
    B, H, S, D = 1, 4, 64, 8
    zeros, ones = np.zeros((B, H, S, D), "float32"), \
        np.ones((B, H, S, D), "float32")
    main = tpt.Program()
    block = main.global_block()
    for n in "qkv":
        block.create_var(name=n, shape=[B, H, S, D], dtype="float32",
                         is_data=True)
    block.append_op("flash_attention", inputs={"Q": ["q"], "K": ["k"],
                                               "V": ["v"]},
                    outputs={"Out": ["o"]},
                    attrs={"impl": "xla", "dropout_prob": 0.5,
                           "__op_seed__": 3})
    exe = tpt.Executor(tpt.CPUPlace())
    feed = {"q": zeros, "k": zeros, "v": ones}
    a = exe.run(main, feed=feed, fetch_list=["o"], scope=tpt.Scope())[0]
    b = exe.run(main, feed=feed, fetch_list=["o"], scope=tpt.Scope())[0]
    rows = a[..., 0].ravel()
    sigma = np.sqrt(0.25 / S) / 0.5 / np.sqrt(rows.size)
    assert abs(rows.mean() - 1.0) < 5 * sigma
    assert np.allclose(a, a[..., :1])  # every column of v is 1
    assert not np.array_equal(a, b)


def test_flash_attention_xla_impl_raises_under_sequence_parallelism():
    """The einsum formulation would attend over the local shard only
    under the 'sp' mesh axis: it raises there, as the reference does."""
    from paddle_tpu_torch.ops.registry import LowerContext, lower_op

    main = tpt.Program()
    block = main.global_block()
    q = torch.zeros(1, 2, 8, 16)
    for n in "qkv":
        block.create_var(name=n, shape=[1, 2, 8, 16], dtype="float32")
    op = block.append_op("flash_attention",
                         inputs={"Q": ["q"], "K": ["k"], "V": ["v"]},
                         outputs={"Out": ["o"]}, attrs={"impl": "xla"})
    ctx = LowerContext(block, {"q": q, "k": q, "v": q}, torch.device("cpu"))
    ctx.axis_names = ("dp", "sp")
    with pytest.raises(NotImplementedError, match="sequence parallel"):
        lower_op(ctx, op, 0)


def test_cache_write_into_state_keeps_the_tensor():
    """The decode step's write goes into the scope's own cache tensor: the
    same object, the same data_ptr, run after run, with the rows
    written; nothing else of the cache changes."""
    inputs, outputs, state = _write_case(1, [0, 3, 7])
    scope = tpt.Scope()
    cache = torch.from_numpy(state["c"].copy())
    main = tpt.Program()
    block = main.global_block()
    block.create_var(name="c", shape=list(cache.shape), dtype="float32",
                     persistable=True)
    for n, arr in (("n", inputs["New"]["n"]), ("p", inputs["Positions"]["p"])):
        block.create_var(name=n, shape=list(arr.shape), dtype=str(arr.dtype),
                         is_data=True)
    block.append_op("kv_cache_write",
                    inputs={"Cache": ["c"], "New": ["n"], "Positions": ["p"]},
                    outputs={"Out": ["c"]})
    scope.set_var("c", cache)
    ptr = cache.data_ptr()
    exe = tpt.Executor(tpt.CPUPlace())
    want = state["c"].copy()
    for step in range(3):
        new = _f(3, 2, 1, 4)
        pos = np.array([step, 3 + step, 7 - step], "int32")
        exe.run(main, feed={"n": new, "p": pos}, scope=scope)
        for b in range(3):
            want[b, :, pos[b]] = new[b, :, 0]
        assert scope.find_var("c") is cache and cache.data_ptr() == ptr
        np.testing.assert_array_equal(cache.numpy(), want)


def test_cache_write_into_a_fed_cache_leaves_the_array():
    """A fed cache is the caller's: the op writes into a copy."""
    inputs, outputs, _ = _write_case(1, [1, 2, 3])
    fed = inputs["Cache"]["c"]
    before = fed.copy()
    got = _run(tpt, "kv_cache_write", inputs, outputs, {}, ["c"])[0]
    np.testing.assert_array_equal(fed, before)
    assert not np.array_equal(got, before)
    np.testing.assert_array_equal(got[0, :, 1], inputs["New"]["n"][0, :, 0])
