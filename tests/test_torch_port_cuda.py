'''The CUDA attention kernels (forward with lse, dQ, dK/dV) against their
plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the test helpers that do, so on a machine with a card and no
JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_port_cuda.py
'''
import pytest
import torch

from bmt_tpu_torch.ops.attention import scaled_dot_attention
from bmt_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_forward,
    flash_attention_lse_reference, flash_attention_reference,
    key_mask_and_causal, launch_counts, row_dot)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# (atol, rtol). fp32: the same math summed in another order. bf16: the
# output rounds to 8 mantissa bits and the plain version also rounds p to
# bf16, so the two may differ by an ulp or two of |out|
KERNEL_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
# gradients: fp32 as above; bf16 rounds dS and P to bf16 at values that
# differ slightly between the two versions and the gradient rounds to bf16
# at the end, so they may differ by two ulps (2^-7 relative each)
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
# lse: fp32 in both, from the same inputs; sums in another order
LSE_TOL = (1e-5, 1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kind', [
    ((2, 4, 256, 96, 256), 'padding'), ((2, 4, 96, 256, 256), 'padding'),
    ((2, 4, 22, 22, 256), 'causal'), ((2, 2, 70, 70, 64), 'causal'),
    ((2, 2, 70, 70, 64), 'none'), ((1, 1, 1, 33, 8), 'padding')])
def test_kernel_matches_plain_on_card(cuda, dtype, shape, kind):
    '''Serving-like and ragged shapes; the last batch row has every key
    masked, so its rows are NaN in both versions.'''
    B, H, Sq, Sk, d = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, H, S, d, generator=g, device=cuda).to(dtype)
               for S in (Sq, Sk, Sk))
    valid = torch.rand(B, Sk, generator=g, device=cuda) > 0.3
    valid[:, 0] = True
    valid[-1] = False
    if kind == 'none':
        mask = None
    elif kind == 'padding':
        mask = valid[:, None, None, :]
    else:
        mask = (valid[:, None, None, :]
                & torch.ones(Sq, Sk, dtype=torch.bool, device=cuda).tril())
    before = flash_attention.launches
    out = flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    key_mask, causal = key_mask_and_causal(mask, B, Sk, cuda)
    ref = flash_attention_reference(q, k, v, key_mask, causal)
    atol, rtol = KERNEL_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol,
                               equal_nan=True)
    if kind != 'none':
        assert out[-1].isnan().all()
    if B > 1:
        assert not out[0].isnan().any()


def _inputs(cuda, dtype, shape, kind, seed=0):
    B, H, Sq, Sk, d = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, H, S, d, generator=g, device=cuda).to(dtype)
               for S in (Sq, Sk, Sk))
    dout = torch.randn(B, H, Sq, d, generator=g, device=cuda).to(dtype)
    key_mask = (torch.rand(B, Sk, generator=g, device=cuda) > 0.3).int()
    key_mask[:, 0] = 1
    key_mask[-1] = 0                       # the last batch row sees nothing
    return q, k, v, dout, key_mask, kind == 'causal'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kind', [
    ((2, 4, 256, 96, 256), 'padding'), ((2, 4, 96, 256, 256), 'padding'),
    ((2, 4, 21, 21, 256), 'causal'), ((2, 2, 70, 70, 64), 'causal'),
    ((3, 2, 33, 70, 64), 'padding'), ((1, 1, 1, 33, 8), 'padding')])
def test_training_kernels_match_plain_on_card(cuda, dtype, shape, kind):
    '''The lse forward, dQ and dK/dV at ragged shapes (tiles cut by Sq and
    Sk); the plain backward gets the kernel's lse and D, so both sides see
    the same inputs. The empty batch row has lse -inf and zero gradients in
    both.'''
    q, k, v, dout, km, causal = _inputs(cuda, dtype, shape, kind)
    before = (flash_attention.launches, flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    drow = row_dot(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, km, causal, lse, drow, dout)
    dk, dv = flash_attention_bwd_dkv(q, k, v, km, causal, lse, drow, dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, causal)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=KERNEL_TOL[dtype][0],
                               rtol=KERNEL_TOL[dtype][1], equal_nan=True)
    assert torch.equal(lse.isneginf(), ref_lse.isneginf())
    assert lse[-1].isneginf().all()
    torch.testing.assert_close(lse.nan_to_num(neginf=0.0),
                               ref_lse.nan_to_num(neginf=0.0),
                               atol=LSE_TOL[0], rtol=LSE_TOL[1])
    ref_dq = flash_attention_bwd_dq_reference(q, k, v, km, causal, lse, drow,
                                              dout)
    ref_dk, ref_dv = flash_attention_bwd_dkv_reference(q, k, v, km, causal,
                                                       lse, drow, dout)
    atol, rtol = BWD_TOL[dtype]
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and not got.isnan().any()
        assert (got[-1] == 0).all() and (want[-1] == 0).all()
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize('shape,kind', [
    ((2, 2, 33, 70, 8), 'padding'), ((2, 2, 70, 70, 8), 'causal'),
    ((2, 2, 129, 33, 24), 'padding'), ((2, 2, 70, 70, 24), 'causal'),
    ((3, 2, 33, 129, 64), 'padding'), ((3, 2, 129, 129, 64), 'causal'),
    ((2, 2, 70, 129, 72), 'padding'), ((2, 2, 129, 129, 72), 'causal'),
    ((2, 4, 129, 70, 256), 'padding'), ((2, 4, 129, 129, 256), 'causal'),
    ((2, 2, 2048, 2048, 256), 'padding'), ((2, 2, 2048, 2048, 256), 'causal')])
def test_bf16_tensor_core_kernels_match_plain_on_card(cuda, shape, kind):
    '''The bf16 tensor-core forward (with lse), dQ and dK/dV at head dims
    that are and are not multiples of 16 (8, 24, 72: zero-padded to the 64-
    or 256-column tile in shared memory), query and key lengths that cut the
    32-, 64- and 128-row tiles (33, 70, 129) and S = 2048; the last batch row has
    every key masked, so its output is NaN, its lse -inf and its dQ, dK, dV
    exactly 0.'''
    q, k, v, dout, km, causal = _inputs(cuda, torch.bfloat16, shape, kind)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    drow = row_dot(out, dout)
    dq = flash_attention_bwd_dq(q, k, v, km, causal, lse, drow, dout)
    dk, dv = flash_attention_bwd_dkv(q, k, v, km, causal, lse, drow, dout)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, causal)
    torch.testing.assert_close(out.float(), ref_out.float(),
                               atol=KERNEL_TOL[torch.bfloat16][0],
                               rtol=KERNEL_TOL[torch.bfloat16][1],
                               equal_nan=True)
    assert out[-1].isnan().all() and not out[0].isnan().any()
    assert torch.equal(lse.isneginf(), ref_lse.isneginf())
    assert lse[-1].isneginf().all()
    torch.testing.assert_close(lse.nan_to_num(neginf=0.0),
                               ref_lse.nan_to_num(neginf=0.0),
                               atol=LSE_TOL[0], rtol=LSE_TOL[1])
    ref_dq = flash_attention_bwd_dq_reference(q, k, v, km, causal, lse, drow,
                                              dout)
    ref_dk, ref_dv = flash_attention_bwd_dkv_reference(q, k, v, km, causal,
                                                       lse, drow, dout)
    atol, rtol = BWD_TOL[torch.bfloat16]
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == torch.bfloat16 and not got.isnan().any()
        assert (got[-1] == 0).all() and (want[-1] == 0).all()
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize('shape,kind', [
    ((2, 4, 256, 256, 256), 'padding'), ((2, 2, 129, 129, 64), 'causal')])
def test_bf16_dq_kernel_is_deterministic_on_card(cuda, shape, kind):
    '''No atomics: one block owns a query tile and sums over the key tiles
    in one fixed order, so two launches on the same inputs give the same
    bits.'''
    q, k, v, dout, km, causal = _inputs(cuda, torch.bfloat16, shape, kind)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    drow = row_dot(out, dout)
    before = flash_attention_bwd_dq.launches
    first, second = (flash_attention_bwd_dq(q, k, v, km, causal, lse, drow,
                                            dout) for _ in range(2))
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == before + 2
    assert torch.equal(first, second)
    assert first.abs().max() > 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernels_refuse_unaligned_tensors_on_card(cuda, dtype):
    '''The kernels copy 16-byte chunks: a contiguous tensor whose data does
    not start on a 16-byte boundary is refused before any launch.'''
    base = torch.zeros(1 + 4 * 16, device=cuda, dtype=dtype)
    bad = base[1:].view(1, 1, 4, 16)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    good = torch.zeros(1, 1, 4, 16, device=cuda, dtype=dtype)
    km = torch.ones(1, 4, dtype=torch.int32, device=cuda)
    rows = torch.zeros(1, 1, 4, device=cuda)
    before = dict(launch_counts())
    with pytest.raises(ValueError, match='16-byte'):
        flash_attention(bad, good, good, None)
    with pytest.raises(ValueError, match='16-byte'):
        flash_attention(good, good, bad, None)
    with pytest.raises(ValueError, match='16-byte'):
        flash_attention_bwd_dq(good, bad, good, km, False, rows, rows, good)
    with pytest.raises(ValueError, match='16-byte'):
        flash_attention_bwd_dkv(good, good, good, km, False, rows, rows, bad)
    assert launch_counts() == before


def test_autograd_through_kernels_matches_plain_attention_on_card(cuda):
    '''fp32: gradients of flash_attention under autograd (three kernel
    launches) against autograd through the plain attention math.'''
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 4, S, 64, generator=g, device=cuda,
                           requires_grad=True) for S in (40, 50, 50))
    mask = torch.ones(2, 1, 1, 50, dtype=torch.bool, device=cuda)
    mask[1, ..., 30:] = False
    dout = torch.randn(2, 4, 40, 64, generator=g, device=cuda)
    before = flash_attention_bwd_dkv.launches
    got = torch.autograd.grad(flash_attention(q, k, v, mask), (q, k, v),
                              dout)
    assert flash_attention_bwd_dkv.launches == before + 1
    want = torch.autograd.grad(scaled_dot_attention(q, k, v, mask),
                               (q, k, v), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_kernel_wrapper_rejects_bad_inputs_on_card(cuda):
    q = torch.zeros(1, 1, 4, 264, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, None)                   # d > 256
    q = torch.zeros(1, 1, 4, 12, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, None)                   # d % 8 != 0
    q = torch.zeros(1, 4, 2, 16, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_attention(q, q, q, None)                   # not contiguous
    q = torch.zeros(1, 1, 4, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q, None)                   # fp16
    q = torch.zeros(1, 1, 4, 16, device=cuda)
    km = torch.ones(1, 4, dtype=torch.int32, device=cuda)
    rows = torch.zeros(1, 1, 4, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_bwd_dq(q, q, q, km, False, rows, rows, q)  # lse bf16
