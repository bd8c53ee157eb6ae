"""The 16-byte alignment check of the kernels' wrappers.

TMA (the bf16 kernels) and 16-byte cp.async (the fp32 forward) read an
operand only where its address and every byte stride (of a dim longer
than 1) are positive multiples of 16.  ``tma_aligned`` says whether a
tensor meets that; ``tma_operand`` passes such a tensor through and
copies any other to fresh contiguous memory, counting the copy in its
owner's ``.realigned``.  Both are pure Python over a tensor's
address and strides, so they are checked here on CPU tensors.
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as tfa


def _bf16(*shape):
    return torch.arange(int(torch.tensor(shape).prod())).reshape(shape).to(
        torch.bfloat16)


def _offset(elems, shape, dtype=torch.bfloat16):
    """A contiguous `shape` starting `elems` elements into its storage."""
    n = int(torch.tensor(shape).prod())
    return torch.zeros(n + elems, dtype=dtype)[elems:].view(shape)


CASES = {
    "contiguous": (lambda: _bf16(2, 4, 32, 64), True),
    "bshd_view": (lambda: _bf16(2, 32, 4, 128).transpose(1, 2), True),
    "packed_qkv": (lambda: _bf16(2, 16, 3 * 256), True),
    "offset_2_bytes": (lambda: _offset(1, (2, 4, 32, 64)), False),
    "offset_8_bytes": (lambda: _offset(4, (2, 4, 32, 64)), False),
    "offset_16_bytes": (lambda: _offset(8, (2, 4, 32, 64)), True),
    "row_stride_136_bytes": (lambda: _bf16(2, 4, 32, 68)[..., :64], False),
    "row_stride_144_bytes": (lambda: _bf16(2, 4, 32, 72)[..., :64], True),
    "odd_head_stride": (lambda: _bf16(3 * 8200).as_strided(
        (2, 4, 32, 64), (8200, 2051, 64, 1)), False),
    "size_1_dims_ignored": (lambda: _bf16(4, 32, 64).as_strided(
        (1, 4, 1, 64), (3, 2048, 5, 1)), True),
    "expanded_heads": (lambda: _bf16(2, 1, 32, 64).expand(2, 4, 32, 64),
                       False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tma_aligned(case):
    make, want = CASES[case]
    assert tfa.tma_aligned(make()) is want


class _Owner:
    realigned = 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_tma_operand_copies_only_what_tma_cannot_read(case):
    make, aligned = CASES[case]
    t = make()
    owner = _Owner()
    got = tfa.tma_operand(t, owner)
    if aligned:
        assert got is t and owner.realigned == 0
    else:
        assert got is not t and owner.realigned == 1
        assert got.is_contiguous() and tfa.tma_aligned(got)
        assert got.data_ptr() != t.data_ptr()
    assert torch.equal(got, t)


def _f32(*shape):
    return torch.arange(int(torch.tensor(shape).prod()),
                        dtype=torch.float32).reshape(shape)


# float32 operands: the forward kernel reads them with 16-byte cp.async
# copies, so the rule is the same in bytes (4 bytes an element)
F32_CASES = {
    "contiguous": (lambda: _f32(2, 4, 32, 64), True),
    "bshd_view": (lambda: _f32(2, 32, 4, 128).transpose(1, 2), True),
    "packed_qkv": (lambda: _f32(2, 16, 3 * 256), True),
    "offset_4_bytes": (lambda: _offset(1, (2, 4, 32, 64), torch.float32),
                       False),
    "offset_8_bytes": (lambda: _offset(2, (2, 4, 32, 64), torch.float32),
                       False),
    "offset_16_bytes": (lambda: _offset(4, (2, 4, 32, 64), torch.float32),
                        True),
    "row_stride_264_bytes": (lambda: _f32(2, 4, 32, 66)[..., :64], False),
    "row_stride_272_bytes": (lambda: _f32(2, 4, 32, 68)[..., :64], True),
}


def test_tma_operand_leaves_float32_alone():
    """Aligned float32 operands, as the model paths hand them to the
    kernels (contiguous, [B, H, S, D] views of [B, S, H, D] buffers, the
    packed qkv), are read in place: nothing is copied or counted."""
    owner = _Owner()
    for case in ("contiguous", "bshd_view", "packed_qkv", "offset_16_bytes"):
        t = F32_CASES[case][0]()
        assert tfa.tma_operand(t, owner) is t, case
    assert owner.realigned == 0


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_tma_operand_copies_misaligned_float32(case):
    """A float32 view whose address or row stride is not a multiple of 16
    bytes is copied to contiguous memory and counted, as a bfloat16 one
    is; an aligned one is not."""
    make, aligned = F32_CASES[case]
    t = make()
    assert tfa.tma_aligned(t) is aligned
    owner = _Owner()
    got = tfa.tma_operand(t, owner)
    if aligned:
        assert got is t and owner.realigned == 0
    else:
        assert got is not t and owner.realigned == 1
        assert got.is_contiguous() and tfa.tma_aligned(got)
    assert got.dtype == torch.float32 and torch.equal(got, t)


def test_wrappers_count_realigned_operands():
    """The six wrappers, whose bf16 kernels all load through TMA, carry the
    count, starting from a plain integer the smoke test resets and reads."""
    for w in (tfa.flash_attention_packed, tfa.flash_attention_packed_dkv,
              tfa.flash_attention_packed_dq, tfa.flash_attention_unpacked,
              tfa.flash_attention_unpacked_dkv,
              tfa.flash_attention_unpacked_dq):
        assert isinstance(w.realigned, int) and w.realigned >= 0


def test_cpu_calls_take_the_plain_versions_without_realigning():
    """A CPU tensor never reaches the alignment check: the wrapper takes the
    plain version, whatever the tensor's address."""
    q = _offset(1, (1, 2, 16, 64)).float()
    before = tfa.flash_attention_unpacked.realigned
    out, lse = tfa.flash_attention_unpacked(q, q, q, None, True)
    assert out.shape == q.shape and lse.shape == (1, 2, 16)
    assert tfa.flash_attention_unpacked.realigned == before
