"""The paged KV cache's ops through both packages: ``kv_pool_write`` and
``kv_pool_gather``.

Each case builds the same one-op program in both packages, with the pool
as persistable state set in each scope and the rest fed, and compares
the fetches bit for bit: the routed rows on their pages and offsets, the
trash-page redirect of rows at or past ``Lengths`` (the trash page 0
itself compared only where one row at most lands there, since duplicate
scatter indices leave it indeterminate in both), logical positions past
the block table clipped to its last entry, and table entries past the
pool clipped on a gather.  Then the port alone: a write into state keeps
the pool's tensor and ``data_ptr``; a fed pool is left as it was.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu_torch as tpt

R = np.random.RandomState(97)


def _run(pkg, op_type, inputs, outputs, fetch, state, scope=None):
    """One-op program: `inputs` ({slot: {name: array}}) are fed, except
    the names in `state`, which are persistable vars set in the scope."""
    main = pkg.Program()
    block = main.global_block()
    scope = scope if scope is not None else pkg.Scope()
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
                    outputs={s: list(n) for s, n in outputs.items()})
    return pkg.Executor(pkg.CPUPlace()).run(main, feed=feed,
                                            fetch_list=fetch, scope=scope)


def _write_case(positions, table, lengths, T, P=6, Hkv=2, pt=4, D=3):
    pool = R.randn(P, Hkv, pt, D).astype("float32")
    new = R.randn(len(positions), Hkv, T, D).astype("float32")
    return {"Pool": {"pool": pool}, "New": {"new": new},
            "Positions": {"pos": np.asarray(positions, "int32")},
            "BlockTable": {"bt": np.asarray(table, "int32")},
            "Lengths": {"len": np.asarray(lengths, "int32")}}


WRITE_CASES = {
    # slot 0 crosses a page boundary (3 -> page 1 off 3; 4, 5 -> page 2);
    # slot 1 has one live row, its other two go to the trash page
    "cross_page_and_trash": (_write_case([3, 0], [[1, 2], [3, 0]], [3, 1],
                                         T=3), False),
    # a decode step: one row a slot, slot 1 idle (its row to the trash)
    "decode_idle_slot": (_write_case([5, 2, 7], [[1, 4], [2, 0], [3, 5]],
                                     [1, 0, 1], T=1), True),
    # logical positions past the table (2 pages of 4) clip to its last
    # entry, as take_along_axis(mode="clip") does
    "clipped_table_index": (_write_case([6], [[1, 2]], [3], T=3), True),
    # a prefill from position 0 over 3 pages, pad tail to the trash page
    "prefill_pad_tail": (_write_case([0], [[4, 1, 5]], [9], T=12), False),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_kv_pool_write_matches_jax_bit_for_bit(case):
    inputs, trash_exact = WRITE_CASES[case]
    state = {"pool": inputs["Pool"]["pool"]}
    want = np.asarray(_run(jpt, "kv_pool_write", inputs,
                           {"Out": ["pool"]}, ["pool"], state)[0])
    got = _run(tpt, "kv_pool_write", inputs, {"Out": ["pool"]}, ["pool"],
               state)[0]
    assert got.dtype == np.float32 and got.shape == want.shape
    first = 0 if trash_exact else 1
    np.testing.assert_array_equal(got[first:], want[first:])
    assert not np.array_equal(got[1:], state["pool"][1:])


GATHER_CASES = {
    "two_slots": [[1, 2, 0], [3, 0, 0]],
    "shared_pages": [[4, 5, 1], [4, 5, 2]],
    # entries past the pool (P = 6) clip to its last page
    "clipped_entries": [[7, 1, 9], [2, 6, 3]],
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_kv_pool_gather_matches_jax_bit_for_bit(case):
    pool = R.randn(6, 2, 4, 3).astype("float32")
    inputs = {"Pool": {"pool": pool},
              "BlockTable": {"bt": np.asarray(GATHER_CASES[case], "int32")}}
    state = {"pool": pool}
    want = np.asarray(_run(jpt, "kv_pool_gather", inputs, {"Out": ["o"]},
                           ["o"], state)[0])
    got = _run(tpt, "kv_pool_gather", inputs, {"Out": ["o"]}, ["o"],
               state)[0]
    assert got.shape == want.shape == (2, 2, 12, 3)
    np.testing.assert_array_equal(got, want)


def test_kv_pool_write_then_gather_roundtrip():
    """The port's write-then-gather: each live row reads back at its
    logical position of its slot's view."""
    inputs, _ = WRITE_CASES["cross_page_and_trash"]
    scope = tpt.Scope()
    _run(tpt, "kv_pool_write", inputs, {"Out": ["pool"]}, ["pool"],
         {"pool": inputs["Pool"]["pool"]}, scope=scope)
    pool = scope.find_var("pool").numpy()
    bt = inputs["BlockTable"]["bt"]
    view = _run(tpt, "kv_pool_gather", {"Pool": {"pool": pool},
                                        "BlockTable": {"bt": bt}},
                {"Out": ["o"]}, ["o"], {"pool": pool})[0]
    new = inputs["New"]["new"]
    for t in range(3):
        np.testing.assert_array_equal(view[0, :, 3 + t], new[0, :, t])
    np.testing.assert_array_equal(view[1, :, 0], new[1, :, 0])


def test_pool_write_into_state_keeps_the_tensor():
    """The write goes into the scope's own pool tensor: the same object
    and data_ptr run after run, with the rows written."""
    inputs, _ = WRITE_CASES["decode_idle_slot"]
    pool = torch.from_numpy(inputs["Pool"]["pool"].copy())
    main = tpt.Program()
    block = main.global_block()
    block.create_var(name="pool", shape=list(pool.shape), dtype="float32",
                     persistable=True)
    feed = {}
    for slot in ("New", "Positions", "BlockTable", "Lengths"):
        (n, arr), = inputs[slot].items()
        block.create_var(name=n, shape=list(arr.shape),
                         dtype=str(arr.dtype), is_data=True)
        feed[n] = arr
    block.append_op("kv_pool_write",
                    inputs={"Pool": ["pool"], "New": ["new"],
                            "Positions": ["pos"], "BlockTable": ["bt"],
                            "Lengths": ["len"]},
                    outputs={"Out": ["pool"]})
    scope = tpt.Scope()
    scope.set_var("pool", pool)
    ptr = pool.data_ptr()
    exe = tpt.Executor(tpt.CPUPlace())
    want = pool.numpy().copy()
    for step in range(3):
        new = R.randn(3, 2, 1, 3).astype("float32")
        pos = np.asarray([step, 1 + step, 4 + step], "int32")
        exe.run(main, feed=dict(feed, new=new, pos=pos), scope=scope)
        for b in (0, 2):  # slot 1 is idle
            page = feed["bt"][b, pos[b] // 4]
            want[page, :, pos[b] % 4] = new[b, :, 0]
        assert scope.find_var("pool") is pool and pool.data_ptr() == ptr
        np.testing.assert_array_equal(pool.numpy()[1:], want[1:])


def test_pool_write_into_a_fed_pool_leaves_the_array():
    """A fed pool is the caller's: the op writes into a copy."""
    inputs, _ = WRITE_CASES["cross_page_and_trash"]
    fed = inputs["Pool"]["pool"]
    before = fed.copy()
    got = _run(tpt, "kv_pool_write", inputs, {"Out": ["pool"]}, ["pool"],
               {})[0]
    np.testing.assert_array_equal(fed, before)
    np.testing.assert_array_equal(got[1, :, 3], inputs["New"]["new"][0, :, 0])
