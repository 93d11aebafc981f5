'''The CUDA attention kernels (forward with lse, dQ, dK/dV) against their
plain PyTorch versions, the checkpoint loaders, the single-video app and a
MoE train step through them, the int8 linear's ``torch._int_mm`` product
and int8 levels, and the threefry kernels (dropout and random bits, bit for
bit their plain versions, a graph reading its key at each replay), on the
card.

Every test here needs a CUDA device and skips without one. The file imports
neither JAX nor the test helpers that do, so on a machine with a card and no
JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_port_cuda.py
'''
import copy

import pytest
import torch
from torch import nn

from bmt_tpu_torch.ops.attention import scaled_dot_attention
from bmt_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_forward,
    flash_attention_lse_reference, flash_attention_reference,
    bf16_key_splits, fp32_key_splits, key_mask_and_causal, launch_counts,
    row_dot)
from bmt_tpu_torch.ops.quant import (Int8Linear, int8_matmul,
                                     quantize_rows_int8)

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
    _check_training_kernels(*_inputs(cuda, dtype, shape, kind), dtype)


def _check_training_kernels(q, k, v, dout, km, causal, dtype):
    '''The three kernels once each against their plain versions; the last
    batch row has every key masked.'''
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('sq,sk', [(800, 800), (300, 800), (800, 300)])
def test_kernels_at_proposal_shapes_match_plain_on_card(cuda, dtype, sq, sk):
    '''The proposal generator's longest calls (H=4, d=256; 800 audio and
    300 video rows, which cut the 64- and 128-row query tiles and the
    32-key tiles): key masks of a video as long as the pad, of videos
    shorter than it (65% and 40% of the rows) and of a row with every key
    masked.'''
    q, k, v, dout, _, _ = _inputs(cuda, dtype, (4, 4, sq, sk, 256),
                                  'padding')
    lengths = torch.tensor([sk, int(0.65 * sk), int(0.4 * sk), 0],
                           device=cuda)
    km = (torch.arange(sk, device=cuda)[None, :] < lengths[:, None]).int()
    _check_training_kernels(q, k, v, dout, km, False, dtype)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kind', [
    ((2, 2, 33, 70, 8), 'padding'), ((2, 2, 70, 70, 8), 'causal'),
    ((2, 2, 129, 33, 24), 'padding'), ((2, 2, 70, 70, 24), 'causal'),
    ((3, 2, 33, 129, 64), 'padding'), ((3, 2, 129, 129, 64), 'causal'),
    ((2, 2, 70, 129, 72), 'padding'), ((2, 2, 129, 129, 72), 'causal'),
    ((2, 4, 129, 70, 256), 'padding'), ((2, 4, 129, 129, 256), 'causal'),
    ((2, 2, 2048, 2048, 256), 'padding'), ((2, 2, 2048, 2048, 256), 'causal')])
def test_tensor_core_kernels_match_plain_on_card(cuda, dtype, shape, kind):
    '''The tensor-core forward (with lse; 3xTF32 in fp32, bf16 in bf16)
    and the dQ and dK/dV of that dtype at head dims that are and are not
    multiples of 16 (8, 24, 72: zero-padded to the 64- or 256-column tile in
    shared memory), query and key lengths that cut the 32-, 64- and 128-row
    tiles (33, 70, 129) and S = 2048; the last batch row has every key
    masked, so its output is NaN, its lse -inf and its dQ, dK, dV exactly
    0. The small fp32 shapes fill few blocks, so their key loops split.'''
    _check_training_kernels(*_inputs(cuda, dtype, shape, kind), dtype)


# the edges of the bf16 backward kernels' tiles (64 rows; regions of 64
# head-dim columns, or 32 at d <= 32): every length of {1, 63, 65, 129, 800}
# on the query side and on the key side at every head dim, causal with
# Sq != Sk among them
EDGE_LENGTHS = [(1, 800, 'padding'), (63, 65, 'causal'), (65, 63, 'padding'),
                (129, 1, 'causal'), (800, 129, 'padding')]
BF16_EDGE_CASES = [((2, 2, sq, sk, d), kind) for d in (8, 24, 32, 40, 64,
                                                        72, 256)
                   for sq, sk, kind in EDGE_LENGTHS]


@pytest.mark.parametrize('shape,kind', BF16_EDGE_CASES)
def test_bf16_backward_kernels_at_tile_edges_on_card(cuda, shape, kind):
    """The bf16 dQ and dK/dV kernels (wgmma on TMA tiles) against their
    plain versions at query and key lengths that cut the 64-row tiles or
    fill less than one, head dims that leave part of a 32- or 64-column
    region (or whole regions) to TMA's zero fill, causal with Sq != Sk,
    ragged key masks and a batch row with every key masked, whose
    gradients are exactly 0 and never NaN. The forward is the plain one,
    so only the backward kernels are under test."""
    q, k, v, dout, km, causal = _inputs(cuda, torch.bfloat16, shape, kind)
    out, lse = flash_attention_lse_reference(q, k, v, km, causal)
    drow = row_dot(out, dout)
    args = (q, k, v, km, causal, lse, drow, dout)
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    got = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    want = (flash_attention_bwd_dq_reference(*args),
            *flash_attention_bwd_dkv_reference(*args))
    atol, rtol = BWD_TOL[torch.bfloat16]
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and not a.isnan().any()
        assert (a[-1] == 0).all() and (b[-1] == 0).all()
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol)


# the fp32 backward kernels (three TF32 wgmma products on TMA tiles; 64-row
# blocks over 32-row loop tiles; at head dims padded to 256 a cluster of two
# blocks, one a 128-column half): the proposal cell's four calls (B = 16,
# keys of videos shorter than the pad), S = 2048 causal, and every head dim
# of {8, 24, 64, 72, 256} at lengths that cut the 32- and 64-row tiles or
# fill less than one (the decoder's 21), causal with Sq != Sk among them
FP32_BWD_CASES = (
    [((16, 4, sq, sk, 256), 'videos')
     for sq, sk in ((800, 800), (300, 300), (800, 300), (300, 800))]
    + [((2, 2, 2048, 2048, 256), 'causal')]
    + [((2, 2, sq, sk, d), kind) for d in (8, 24, 64, 72, 256)
       for sq, sk, kind in ((21, 21, 'causal'), (65, 33, 'padding'),
                            (129, 800, 'causal'))])


@pytest.mark.parametrize('shape,kind', FP32_BWD_CASES)
def test_fp32_backward_kernels_on_card(cuda, shape, kind):
    '''The fp32 dQ and dK/dV kernels against their plain versions within
    BWD_TOL[float32]; the forward is the plain one, so only the backward
    kernels are under test. With "videos" the batch rows keep the keys of
    videos of 100%, 65%, 40% and 90% of the pad in turn; in every case the
    last batch row has every key masked, and its gradients are exactly 0
    and never NaN.'''
    q, k, v, dout, km, causal = _inputs(cuda, torch.float32, shape, kind)
    if kind == 'videos':
        B, Sk = km.shape
        lengths = torch.tensor([Sk, int(0.65 * Sk), int(0.4 * Sk),
                                int(0.9 * Sk)] * B, device=cuda)[:B]
        lengths[-1] = 0
        km = (torch.arange(Sk, device=cuda)[None, :]
              < lengths[:, None]).int()
    out, lse = flash_attention_lse_reference(q, k, v, km, causal)
    drow = row_dot(out, dout)
    args = (q, k, v, km, causal, lse, drow, dout)
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    got = (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(n + 1 for n in before)
    want = (flash_attention_bwd_dq_reference(*args),
            *flash_attention_bwd_dkv_reference(*args))
    atol, rtol = BWD_TOL[torch.float32]
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and not a.isnan().any()
        assert (a[-1] == 0).all() and (b[-1] == 0).all()
        torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


# the edges of the bf16 forward's tiles (64-row halves of 128-row query
# blocks, 64-key tiles; head dims padded to 32, 64 or 256): every length of
# {1, 21, 63, 65, 129, 800} on the query and on the key side, causal and
# padded, at every head dim
FWD_EDGE_LENGTHS = [(1, 65, 'padding'), (21, 21, 'causal'),
                    (63, 129, 'padding'), (65, 63, 'causal'),
                    (129, 800, 'causal'), (800, 1, 'padding'),
                    (21, 800, 'padding'), (800, 65, 'causal')]
BF16_FWD_EDGE_CASES = [((2, 2, sq, sk, d), kind)
                       for d in (8, 24, 32, 40, 64, 72, 256)
                       for sq, sk, kind in FWD_EDGE_LENGTHS]


@pytest.mark.parametrize('with_lse', [True, False])
@pytest.mark.parametrize('shape,kind', BF16_FWD_EDGE_CASES)
def test_bf16_forward_kernel_at_tile_edges_on_card(cuda, shape, kind,
                                                   with_lse):
    '''The bf16 forward (wgmma on TMA tiles) against its plain version at
    query and key lengths that cut its tiles or fill less than one, head
    dims that leave part of a 32- or 64-column region (or whole regions) to
    TMA's zero fill, causal with Sq != Sk, ragged key masks and a batch row
    with every key masked (NaN, lse -inf), with and without lse. (A
    launch of several rows takes no key split;
    test_bf16_key_split_is_deterministic_on_card has the split.)'''
    q, k, v, _, km, causal = _inputs(cuda, torch.bfloat16, shape, kind)
    before = flash_attention.launches
    got = flash_attention_forward(q, k, v, km, causal, with_lse=with_lse)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    out, lse = got if with_lse else (got, None)
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, causal)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                               rtol=rtol, equal_nan=True)
    assert out[-1].isnan().all() and not out[0].isnan().any()
    if with_lse:
        assert torch.equal(lse.isneginf(), ref_lse.isneginf())
        assert lse[-1].isneginf().all()
        torch.testing.assert_close(lse.nan_to_num(neginf=0.0),
                                   ref_lse.nan_to_num(neginf=0.0),
                                   atol=LSE_TOL[0], rtol=LSE_TOL[1])


# the edges of the fp32 forward's tiles (three TF32 wgmma products; 64-row
# query blocks, at head dims padded to 256 a cluster of two blocks of 128
# columns, 32-key tiles): lengths that cut them or fill less than one, the
# decoder's 21 rows, causal with Sq != Sk, at every head dim of {8, 24, 64,
# 72, 256} (64: one block; 72: the second block's columns all zero fill)
FP32_FWD_EDGE_CASES = [((2, 2, sq, sk, d), kind) for d in (8, 24, 64, 72, 256)
                       for sq, sk, kind in ((1, 65, 'padding'),
                                            (21, 21, 'causal'),
                                            (65, 33, 'padding'),
                                            (129, 800, 'causal'),
                                            (800, 65, 'causal'))]


def _check_fp32_forward(q, k, v, km, causal, with_lse=True):
    '''The fp32 forward once against its plain version: out within
    KERNEL_TOL, lse within LSE_TOL, the batch row with every key masked
    NaN with lse -inf in both.'''
    before = flash_attention.launches
    got = flash_attention_forward(q, k, v, km, causal, with_lse=with_lse)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    out, lse = got if with_lse else (got, None)
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, causal)
    atol, rtol = KERNEL_TOL[torch.float32]
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref_out, atol=atol, rtol=rtol,
                               equal_nan=True)
    assert out[-1].isnan().all() and not out[0].isnan().any()
    if with_lse:
        assert torch.equal(lse.isneginf(), ref_lse.isneginf())
        assert lse[-1].isneginf().all()
        torch.testing.assert_close(lse.nan_to_num(neginf=0.0),
                                   ref_lse.nan_to_num(neginf=0.0),
                                   atol=LSE_TOL[0], rtol=LSE_TOL[1])


@pytest.mark.parametrize('with_lse', [True, False])
@pytest.mark.parametrize('shape,kind', FP32_FWD_EDGE_CASES)
def test_fp32_forward_kernel_at_tile_edges_on_card(cuda, shape, kind,
                                                   with_lse):
    '''The fp32 forward (TF32 wgmma on TMA tiles) against its plain
    version at query and key lengths that cut its tiles or fill less than
    one, head dims that leave part of a 32-column region (or a cluster
    block's whole half) to TMA's zero fill, causal with Sq != Sk, ragged
    key masks and a batch row with every key masked (NaN, lse -inf), with
    and without lse. (Launches of several rows here fill few blocks, so
    the small ones split their key loops.)'''
    q, k, v, _, km, causal = _inputs(cuda, torch.float32, shape, kind)
    _check_fp32_forward(q, k, v, km, causal, with_lse)


@pytest.mark.parametrize('shape,kind', [
    ((32, 4, 21, 21, 256), 'causal'), ((32, 4, 21, 256, 256), 'padding'),
    ((32, 4, 21, 96, 256), 'padding'), ((32, 4, 256, 256, 256), 'padding'),
    ((2, 2, 2048, 2048, 256), 'causal'), ((2, 4, 2048, 2048, 64), 'causal')])
def test_fp32_forward_at_decoder_and_long_shapes_on_card(cuda, shape, kind):
    '''The fp32 forward where the fp32 train step launches it (the
    decoder's 21-row calls at B=32, whose 128 query tiles take 256 blocks,
    and the encoder's 256x256) and at S = 2048 causal, where a first row's
    long run of small terms would show the tensor core's truncated adds if
    O were not summed a tile at a time, at head dims padded to 256 (the
    cluster) and 64 (one block).'''
    q, k, v, _, km, causal = _inputs(cuda, torch.float32, shape, kind)
    _check_fp32_forward(q, k, v, km, causal)


# the tensor-parallel shapes: the flagship's H = 4 heads over mp 2 (H = 2)
# and mp 4 (H = 1) at d = 256 (the train cell B = 32: 256 audio, 96 video
# rows, 22 caption tokens; the proposal cell B = 16: 800 and 300 rows), and
# the pipeline's microbatches of 8 rows (B = 32 over n_micro 4)
MP_CASES = [
    ((32, 2, 256, 256, 256), 'padding'), ((32, 2, 96, 256, 256), 'padding'),
    ((32, 2, 22, 22, 256), 'causal'), ((32, 2, 22, 96, 256), 'padding'),
    ((16, 2, 800, 800, 256), 'padding'), ((16, 2, 300, 300, 256), 'padding'),
    ((16, 2, 800, 300, 256), 'padding'), ((16, 2, 300, 800, 256), 'padding'),
    ((32, 1, 256, 256, 256), 'padding'), ((32, 1, 22, 22, 256), 'causal'),
    ((8, 4, 256, 96, 256), 'padding'), ((8, 4, 96, 96, 256), 'padding')]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kind', MP_CASES)
def test_kernels_at_tensor_and_pipeline_parallel_shapes_on_card(
        cuda, dtype, shape, kind):
    """The three kernels at H/mp heads (2 and 1) and at the pipeline's
    8-row microbatches against their plain versions: fewer heads halve the
    blocks of a launch, and the fp32 forward splits its key loop when they
    no longer fill the card (``fp32_key_splits``)."""
    _check_training_kernels(*_inputs(cuda, dtype, shape, kind), dtype)


def _app_key_mask(cuda, B, Sk, seed):
    '''B=1: every key valid (the proposal forward of a video as long as the
    pad). B>1: ragged valid lengths, as a caption batch's crops have.'''
    if B == 1:
        return torch.ones(1, Sk, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    lengths = torch.randint(1, Sk + 1, (B,), generator=g, device=cuda)
    return (torch.arange(Sk, device=cuda)[None, :]
            < lengths[:, None]).int()


# the uni-modal audio models' calls (d_model_audio 128, H=4: d = 32, the
# bf16 kernels' 32-column tiles, zero-padded to 64 columns in fp32): the
# encoder's self-attention over up to 800 audio rows, the decoder's causal
# self-attention over the caption and its cross-attention to the memory
D32_CASES = [((4, 4, 300, 300, 32), 'padding'),
             ((4, 4, 23, 23, 32), 'causal'),
             ((4, 4, 23, 800, 32), 'padding'),
             ((2, 4, 800, 800, 32), 'padding')]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kind', D32_CASES)
def test_kernels_at_head_dim_32_match_plain_on_card(cuda, dtype, shape, kind):
    '''The lse forward, dQ and dK/dV at d = 32, where the columns 32-63 of
    the padded tiles must load as zero and never be stored: ragged padded
    key masks, causal, and a batch row with every key masked (lse -inf,
    gradients exactly 0).'''
    _check_training_kernels(*_inputs(cuda, dtype, shape, kind), dtype)


@pytest.mark.parametrize('B,Sq,Sk', [
    (1, 800, 800), (1, 300, 300), (1, 800, 300), (1, 300, 800),
    (100, 512, 512), (100, 192, 192), (100, 512, 192), (100, 192, 512)])
def test_fp32_forward_at_the_app_shapes_on_card(cuda, B, Sq, Sk):
    '''The fp32 forward and lse where the single-video app launches them
    (H=4, d=256): the B=1 proposal forward, whose key loops split, and the
    B=100 caption batch with ragged key lengths.'''
    q, k, v, _, _, _ = _inputs(cuda, torch.float32, (B, 4, Sq, Sk, 256),
                               'none')
    km = _app_key_mask(cuda, B, Sk, seed=Sq + Sk)
    before = flash_attention.launches
    out, lse = flash_attention_forward(q, k, v, km, False, with_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, False)
    atol, rtol = KERNEL_TOL[torch.float32]
    torch.testing.assert_close(out, ref_out, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=LSE_TOL[0],
                               rtol=LSE_TOL[1])


@pytest.mark.parametrize('shape,kind,n_sms,splits', [
    ((1, 4, 300, 300, 256), 'none', None, 3),
    ((1, 4, 800, 800, 256), 'none', 300, 2),
    ((2, 4, 300, 800, 256), 'padding', 250, 3),
    ((2, 2, 129, 129, 64), 'causal', 60, 5)])
def test_fp32_key_split_is_deterministic_on_card(cuda, monkeypatch, shape,
                                                 kind, n_sms, splits):
    '''The fp32 forward with each row's key loop split over blocks (a
    cluster's two blocks counted at d > 64): the count the rule picks for
    this card at B=1 (3 at 300 query rows), or one forced by giving the
    rule another SM count. Out and lse are the same
    bits in two launches (no atomics), agree with the unsplit kernel (one
    SM: no split) and the plain version, and a batch row with every key
    masked is NaN with lse -inf. Under causal the last splits of the first
    query tiles hold no key tile and write empty partials.'''
    from bmt_tpu_torch.ops import flash_attention as fa
    q, k, v, _, km, causal = _inputs(cuda, torch.float32, shape, kind)
    if kind == 'none':
        km = torch.ones_like(km)
    if n_sms is not None:
        monkeypatch.setattr(fa, '_sm_count', lambda device: n_sms)
    B, H, Sq, Sk, _ = shape
    assert fp32_key_splits(B, H, Sq, Sk, shape[4],
                           fa._sm_count(q.device)) == splits
    before = flash_attention.launches
    first, second = (flash_attention_forward(q, k, v, km, causal,
                                             with_lse=True)
                     for _ in range(2))
    monkeypatch.setattr(fa, '_sm_count', lambda device: 1)
    whole = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 3
    assert torch.equal(first[0].nan_to_num(7.0), second[0].nan_to_num(7.0))
    assert torch.equal(first[1], second[1])
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, causal)
    atol, rtol = KERNEL_TOL[torch.float32]
    for out, lse in (first, whole):
        torch.testing.assert_close(out, ref_out, atol=atol, rtol=rtol,
                                   equal_nan=True)
        assert torch.equal(lse.isneginf(), ref_lse.isneginf())
        torch.testing.assert_close(lse.nan_to_num(neginf=0.0),
                                   ref_lse.nan_to_num(neginf=0.0),
                                   atol=LSE_TOL[0], rtol=LSE_TOL[1])
    if kind != 'none':
        assert first[0][-1].isnan().all() and first[1][-1].isneginf().all()
        assert not first[0][0].isnan().any()


@pytest.mark.parametrize('shape,kind,n_sms,splits', [
    ((1, 4, 800, 800, 256), 'none', None, 4),
    ((1, 4, 300, 800, 256), 'none', None, 7),
    ((1, 4, 300, 300, 256), 'padding', 200, 5),
    ((1, 2, 129, 129, 64), 'causal', 40, 3),
    ((1, 4, 800, 800, 32), 'padding', 100, 7),
    ((1, 4, 129, 800, 40), 'empty', None, 13)])
def test_bf16_key_split_is_deterministic_on_card(cuda, monkeypatch, shape,
                                                 kind, n_sms, splits):
    '''The bf16 forward with each row's key loop split over blocks, in a
    launch of one batch row (a served video's): the count the rule picks
    for this card (4 at 800x800, 7 at 300x800), or one forced by giving the
    rule another SM count. Out and lse are the same bits in two launches
    (no atomics), agree with the unsplit kernel (one SM: no split) and the
    plain version; with every key masked the row is NaN with lse -inf.
    Under causal the last splits of the first query blocks hold no key
    tile and write empty partials.'''
    from bmt_tpu_torch.ops import flash_attention as fa
    q, k, v, _, km, causal = _inputs(cuda, torch.bfloat16, shape, kind)
    Sk = shape[3]
    km = torch.ones_like(km)
    if kind == 'padding':
        km[:, Sk * 3 // 5:] = 0
    elif kind == 'empty':
        km.zero_()
    if n_sms is not None:
        monkeypatch.setattr(fa, '_sm_count', lambda device: n_sms)
    B, H, Sq, Sk, d = shape
    assert bf16_key_splits(B, H, Sq, Sk, d, fa._sm_count(q.device)) == \
        splits
    before = flash_attention.launches
    first, second = (flash_attention_forward(q, k, v, km, causal,
                                             with_lse=True)
                     for _ in range(2))
    monkeypatch.setattr(fa, '_sm_count', lambda device: 1)
    whole = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 3
    assert torch.equal(first[0].nan_to_num(7.0), second[0].nan_to_num(7.0))
    assert torch.equal(first[1], second[1])
    ref_out, ref_lse = flash_attention_lse_reference(q, k, v, km, causal)
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    for out, lse in (first, whole):
        torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                                   rtol=rtol, equal_nan=True)
        assert torch.equal(lse.isneginf(), ref_lse.isneginf())
        torch.testing.assert_close(lse.nan_to_num(neginf=0.0),
                                   ref_lse.nan_to_num(neginf=0.0),
                                   atol=LSE_TOL[0], rtol=LSE_TOL[1])
    if kind == 'empty':
        assert first[0].isnan().all() and first[1].isneginf().all()
    else:
        assert not first[0].isnan().any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kind', [
    ((2, 4, 256, 256, 256), 'padding'), ((2, 2, 129, 129, 64), 'causal'),
    ((2, 4, 256, 256, 256), 'causal'), ((4, 4, 300, 300, 32), 'padding'),
    ((4, 4, 23, 23, 32), 'causal'), ((16, 4, 800, 800, 256), 'padding'),
    ((32, 4, 800, 800, 32), 'padding')])
def test_backward_kernels_are_deterministic_on_card(cuda, dtype, shape,
                                                    kind):
    '''No atomics: one block owns a query tile (dQ) or a key tile (dK/dV)
    and sums over the other side's tiles in one fixed order, so two
    launches on the same inputs give the same bits, in fp32 (3xTF32) and in
    bf16 (wgmma), at the train cell's 256x256, the proposal cell's 800x800
    and the audio models' d = 32.'''
    q, k, v, dout, km, causal = _inputs(cuda, dtype, shape, kind)
    out, lse = flash_attention_forward(q, k, v, km, causal, with_lse=True)
    drow = row_dot(out, dout)
    args = (q, k, v, km, causal, lse, drow, dout)
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    first, second = ((flash_attention_bwd_dq(*args),
                      *flash_attention_bwd_dkv(*args)) for _ in range(2))
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == tuple(n + 2 for n in before)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
        assert a.abs().max() > 0


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


# ---------------------------------------------------------------------------
# checkpoints and the single-video app on the card
# ---------------------------------------------------------------------------

SMALL_CAP = ['--procedure', 'train_cap', '--dont_log', '--d_vid', '20',
             '--d_aud', '6', '--use_linear_embedder', '--d_model_audio', '8',
             '--d_model_video', '16', '--d_model', '16', '--d_model_caps',
             '16', '--H', '2', '--N', '2']
SMALL_PROP = ['--procedure', 'train_prop', '--dont_log', '--d_vid', '20',
              '--d_aud', '6', '--use_linear_embedder', '--d_model_audio', '8',
              '--d_model_video', '16', '--d_model', '16', '--H', '2', '--N',
              '1', '--anchors_num_audio', '2', '--anchors_num_video', '3',
              '--kernel_sizes_audio', '3', '5', '--kernel_sizes_video', '3',
              '--conv_layers_audio', '8', '--conv_layers_video', '8',
              '--pad_audio_feats_up_to', '40', '--pad_video_feats_up_to',
              '16']


def _small_checkpoints(path):
    '''Native directories of a small captioner (d_k = 8) and proposal
    generator, written from seeded models built on the CPU.'''
    from bmt_tpu_torch.config import Config, build_parser
    from bmt_tpu_torch.models import (BiModalTransformer, CapModelDims,
                                      MultimodalProposalGenerator,
                                      PropModelDims)
    from bmt_tpu_torch.train.checkpoint import save_checkpoint
    itos = ['<unk>', '<blank>', '<s>', '</s>'] + [f'w{i}' for i in range(20)]
    cfg = Config(build_parser().parse_args(SMALL_CAP))
    cap = BiModalTransformer(CapModelDims.from_config(cfg, len(itos)),
                             device='cpu',
                             generator=torch.Generator().manual_seed(0))
    save_checkpoint(path, cap, {'config': cfg.to_dict(), 'vocab_itos': itos})
    pcfg = Config(build_parser().parse_args(SMALL_PROP))
    prop = MultimodalProposalGenerator(
        PropModelDims.from_config(pcfg), device='cpu',
        generator=torch.Generator().manual_seed(1))
    prop.set_anchors([2.0, 6.0], [3.0, 9.0, 20.0])
    save_checkpoint(path, prop, {'config': pcfg.to_dict()},
                    name='best_prop_model')
    return cap


def test_load_cap_checkpoint_builds_on_the_card_by_default(cuda, tmp_path):
    from bmt_tpu_torch.train.checkpoint import (load_cap_checkpoint,
                                                load_prop_checkpoint)
    cap = _small_checkpoints(str(tmp_path))
    _, _, model, vocab = load_cap_checkpoint(str(tmp_path))
    assert len(vocab) == 24
    for a, b in zip(cap.parameters(), model.parameters()):
        assert b.device.type == 'cuda' and torch.equal(a, b.cpu())
    _, _, prop = load_prop_checkpoint(str(tmp_path))
    assert prop.anchors_V.device.type == 'cuda'


def test_single_video_app_kernel_equals_torch_on_card(cuda, tmp_path):
    '''The app on the card through the fp32 forward kernel and through
    plain attention: the same segments (within fp32 rounding) and
    sentences; the kernel launches in the 'kernel' run only.'''
    import json

    import numpy as np

    from bmt_tpu_torch.scripts.single_video_prediction import main
    _small_checkpoints(str(tmp_path))
    rng = np.random.default_rng(2)
    feats = {}
    for key, shape in (('rgb', (14, 20)), ('flow', (14, 20)),
                       ('vggish', (37, 6))):
        feats[key] = str(tmp_path / f'v_{key}.npy')
        np.save(feats[key], rng.normal(size=shape).astype(np.float32))
    outs = {}
    for impl in ('kernel', 'torch'):
        before = flash_attention.launches
        out = str(tmp_path / f'{impl}.json')
        main(['--prop_generator_model_path', str(tmp_path),
              '--pretrained_cap_model_path', str(tmp_path),
              '--vggish_features_path', feats['vggish'],
              '--rgb_features_path', feats['rgb'],
              '--flow_features_path', feats['flow'],
              '--duration_in_secs', '35.84', '--max_prop_per_vid', '8',
              '--output_json', out, '--attention_impl', impl])
        launched = flash_attention.launches - before
        # 1 proposal layer x 4 attentions, 2 captioner layers x 4 in one
        # caption batch
        assert launched == (4 + 8 if impl == 'kernel' else 0), (impl,
                                                                launched)
        with open(out) as f:
            outs[impl] = json.load(f)
    assert len(outs['kernel']) == len(outs['torch']) == 8
    for a, b in zip(outs['kernel'], outs['torch']):
        assert abs(a['start'] - b['start']) <= 0.1 + 1e-6
        assert abs(a['end'] - b['end']) <= 0.1 + 1e-6
        assert a['sentence'] == b['sentence']


@pytest.mark.parametrize('rows', [1, 16, 17, 64])
@pytest.mark.parametrize('d_in,d_out', [(300, 10172), (1024, 300), (44, 20)])
def test_int8_linear_on_card_equals_the_exact_product(cuda, rows, d_in,
                                                      d_out):
    '''torch._int_mm behind Int8Linear at 16 rows or fewer (padded to 17)
    and at sizes that are not multiples of 8 (the weights padded): the
    card's int32 product of the same operands equals the CPU's exact one;
    the card's int8 weights, their scales, the activations' levels and
    scales and the layer's output equal the CPU path's bit for bit (the
    scales divide by 127 exactly on both, ``ops.quant.per_127``), and the
    layer stays within int8 quantization error of the fp32 linear.'''
    g = torch.Generator().manual_seed(rows)
    linear = nn.Linear(d_in, d_out)
    x = torch.randn(3, rows, d_in, generator=g)
    on_cpu = Int8Linear(linear)
    on_card = Int8Linear(copy.deepcopy(linear).to(cuda))
    assert torch.equal(on_card.w_q.cpu(), on_cpu.w_q)
    assert torch.equal(on_card.w_scale.cpu(), on_cpu.w_scale)
    x_q = torch.randint(-127, 128, (rows, on_cpu.w_q.shape[1]), generator=g,
                        dtype=torch.int8)
    torch.testing.assert_close(int8_matmul(x_q.to(cuda), on_card.w_q).cpu(),
                               int8_matmul(x_q, on_cpu.w_q), atol=0, rtol=0)
    want_q, want_scale = quantize_rows_int8(x)
    got_q, got_scale = quantize_rows_int8(x.to(cuda))
    assert torch.equal(got_q.cpu(), want_q)
    assert torch.equal(got_scale.cpu(), want_scale)
    want = linear(x).detach()
    got = on_card(x.to(cuda)).cpu()
    assert torch.equal(got, on_cpu(x))
    assert (got - want).abs().max() < 0.02 * want.abs().max()
    assert on_card(x.to(cuda, torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_int8_kv_levels_on_card_equal_the_cpu(cuda, dtype):
    '''The int8 cross K/V of ``--kv_cache_int8`` from the same K on the
    card and the CPU: the same levels and per-channel scales, bit for
    bit.'''
    from bmt_tpu_torch.ops.attention import _quantize_per_channel
    g = torch.Generator().manual_seed(3)
    k = (torch.randn(4, 4, 256, 256, generator=g) * 3).to(dtype)
    q8, scale = _quantize_per_channel(k)
    q8_card, scale_card = _quantize_per_channel(k.to(cuda))
    assert torch.equal(q8_card.cpu(), q8)
    assert torch.equal(scale_card.cpu(), scale)


def test_moe_train_step_kernel_equals_torch_on_card(cuda):
    '''Two fp32 Adam steps of a small MoE captioner (E=4, LoRA adapters
    on the attention projections, dropout 0) through the CUDA kernels and
    through plain attention: the same losses, gradient norms and
    parameters within fp32 summation error; every kernel launched.'''
    import types

    from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
    from bmt_tpu_torch.ops.lora import add_lora, lora_frozen_predicate
    from bmt_tpu_torch.train.optim import build_optimizer
    from bmt_tpu_torch.train.steps import (init_train_state,
                                           make_cap_train_step)
    cfg = types.SimpleNamespace(optimizer='adam', lr=1e-3, grad_clip=1.0,
                                eps=1e-3)
    dims = CapModelDims(voc_size=50, d_model_A=16, d_model_V=32,
                        d_model_C=32, d_model=64, H=2, N=2, d_ff_A=32,
                        d_ff_V=64, d_ff_C=64, dout_p=0.0, d_vid=32,
                        d_aud=16, use_linear_embedder=True, moe_experts=4)
    g = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(2):
        src = {'rgb': torch.randn(4, 24, 32, generator=g),
               'flow': torch.randn(4, 24, 32, generator=g),
               'audio': torch.randn(4, 40, 16, generator=g)}
        src['audio'][1, 30:] = 1.0
        caption = torch.randint(4, 50, (4, 9), generator=g)
        caption[:, 0] = 2
        caption[2, 6:] = 1
        batches.append({'src': src, 'caption': caption})
    out = {}
    for impl in ('kernel', 'torch'):
        for lora in (False, True):
            model = BiModalTransformer(
                dims, device=cuda,
                generator=torch.Generator(device=cuda).manual_seed(1))
            if lora:
                add_lora(model, 4, torch.Generator(device=cuda).manual_seed(2))
            opt = build_optimizer(cfg, model, frozen=(
                lora_frozen_predicate if lora else None))
            state = init_train_state(model, opt)
            step = make_cap_train_step(dims, 0.7, 1, impl,
                                       moe_aux_coeff=0.01)
            before = launch_counts()
            metrics = [step(state, b)[1] for b in batches]
            launched = {k: v - before[k] for k, v in launch_counts().items()}
            assert all(launched.values()) == (impl == 'kernel'), launched
            out[impl, lora] = ([m['loss'].item() for m in metrics],
                               [m['grad_norm'].item() for m in metrics],
                               {n: p.detach().clone()
                                for n, p in model.named_parameters()})
    for lora in (False, True):
        (lk, gk, pk), (lt, gt, pt) = out['kernel', lora], out['torch', lora]
        torch.testing.assert_close(lk, lt, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(gk, gt, atol=1e-4, rtol=1e-4)
        for n in pk:
            torch.testing.assert_close(pk[n], pt[n], atol=1e-6, rtol=0,
                                       msg=n)


# ---------------------------------------------------------------------------
# multi-step dispatch: CUDA graphs of the train steps
# ---------------------------------------------------------------------------

def _small_cell(cuda, kind, dtype, seed=0):
    '''(state, step, batches) of a small cell with dropout 0.1 and EMA:
    the captioner ('cap'; 'cap_accum' with 2 microbatches) or the proposal
    generator with remat ('prop').'''
    import types

    from bmt_tpu_torch.models import (BiModalTransformer, CapModelDims,
                                      MultimodalProposalGenerator,
                                      PropModelDims)
    from bmt_tpu_torch.train.optim import build_optimizer
    from bmt_tpu_torch.train.steps import (init_train_state,
                                           make_cap_train_step,
                                           make_prop_train_step, prop_frozen)
    cfg = types.SimpleNamespace(optimizer='adam', lr=1e-3, grad_clip=1.0,
                                weight_decay=1e-4)
    g = torch.Generator().manual_seed(seed)
    src = [{'rgb': torch.randn(4, 24, 32, generator=g),
            'flow': torch.randn(4, 24, 32, generator=g),
            'audio': torch.randn(4, 40, 16, generator=g)}
           for _ in range(3)]
    for s in src:
        s['audio'][1, 30:] = 1.0
        s['rgb'][2, 20:] = 1.0
    if kind.startswith('cap'):
        dims = CapModelDims(voc_size=50, d_model_A=16, d_model_V=32,
                            d_model_C=32, d_model=64, H=2, N=2, d_ff_A=32,
                            d_ff_V=64, d_ff_C=64, dout_p=0.1, d_vid=32,
                            d_aud=16, use_linear_embedder=True)
        model = BiModalTransformer(
            dims, device=cuda,
            generator=torch.Generator(device=cuda).manual_seed(1))
        state = init_train_state(model, build_optimizer(cfg, model), seed=3,
                                 ema=True)
        step = make_cap_train_step(dims, 0.7, 1, 'kernel', dtype,
                                   accum_steps=2 if kind == 'cap_accum'
                                   else 1, ema_decay=0.99)
        batches = []
        for s in src:
            caption = torch.randint(4, 50, (4, 9), generator=g)
            caption[:, 0] = 2
            caption[2, 6:] = 1
            batches.append({'src': {k: v.numpy() for k, v in s.items()},
                            'caption': caption.numpy()})
        return state, step, batches
    dims = PropModelDims(d_model_A=16, d_model_V=32, d_model=64, H=2, N=2,
                         d_ff_A=32, d_ff_V=64, d_vid=32, d_aud=16,
                         kernel_sizes_A=(3, 5), kernel_sizes_V=(3, 5),
                         conv_layers_A=(8,), conv_layers_V=(8,),
                         anchors_num_A=2, anchors_num_V=2, dout_p=0.1,
                         remat=True, use_linear_embedder=True)
    model = MultimodalProposalGenerator(
        dims, device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(1))
    model.set_anchors([2.0, 6.0], [3.0, 9.0])
    state = init_train_state(model, build_optimizer(
        cfg, model, frozen=prop_frozen(False)), seed=3, ema=True)
    step = make_prop_train_step(dims, 1, 'kernel', dtype, ema_decay=0.99)
    batches = [{'src': {k: v.numpy() for k, v in s.items()},
                'centers': torch.rand(4, 3, generator=g).numpy() * 30,
                'lengths': torch.rand(4, 3, generator=g).numpy() * 10 + 1,
                'valid': torch.tensor([[True, True, False]] * 4).numpy()}
               for s in src]
    return state, step, batches


def _changed_tensors(state) -> list:
    opt = state.optimizer
    return (list(state.model.parameters())
            + [v for p in opt.params for v in opt.inner.state[p].values()]
            + opt.device_state() + list(state.ema.values()))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['cap', 'cap_accum', 'prop'])
def test_graphed_steps_equal_eager_steps_on_card(cuda, kind, dtype):
    '''Two bundles of 3 steps through ``make_multistep`` (a warm-up, a
    capture, then replays) against 6 eager steps from the same seed,
    dropout on: the stacked losses and every tensor of the state bit for
    bit; one graph, 5 replays; each bundle counts its steps' kernel
    launches, the replays' included.'''
    from bmt_tpu_torch.ops.flash_attention import reset_launch_counts
    from bmt_tpu_torch.train.steps import make_multistep
    eager, step, batches = _small_cell(cuda, kind, dtype)
    graphed, gstep, _ = _small_cell(cuda, kind, dtype)
    multistep = make_multistep(gstep)
    per_step = None
    for _ in range(2):
        reset_launch_counts()
        losses = []
        for b in batches:
            eager, m = step(eager, b)
            losses.append(m['loss'])
        torch.cuda.synchronize()
        if per_step is None:
            per_step = launch_counts()
            assert all(per_step.values()), per_step
        reset_launch_counts()
        graphed, m = multistep(graphed, batches)
        torch.cuda.synchronize()
        assert launch_counts() == per_step
        torch.testing.assert_close(m['loss'], torch.stack(losses), atol=0,
                                   rtol=0)
    report = graphed.graphs.report()
    assert (report['graphs'], report['replays']) == (1, 5), report
    assert graphed.step == eager.step == 6
    for a, b in zip(_changed_tensors(eager), _changed_tensors(graphed)):
        assert torch.equal(a, b)


def test_graphs_follow_a_load_and_refuse_a_rebound_tensor_on_card(cuda):
    '''After the capture, a checkpoint load copies into the captured
    tensors and the replays go on from the loaded state (as eager steps
    from it do); a tensor of the state rebound instead makes the next
    replay raise.'''
    from bmt_tpu_torch.train.checkpoint import (load_optimizer_state,
                                                optimizer_state_tree)
    from bmt_tpu_torch.train.steps import make_multistep
    eager, step, batches = _small_cell(cuda, 'cap', torch.float32)
    graphed, gstep, _ = _small_cell(cuda, 'cap', torch.float32)
    multistep = make_multistep(gstep)
    graphed, _ = multistep(graphed, batches)          # warm-up, capture
    eager, _ = step(eager, batches[0])
    saved = optimizer_state_tree(eager.model, eager.optimizer)
    params = {n: p.detach().clone() for n, p in eager.model.named_parameters()}
    for state in (eager, graphed):
        load_optimizer_state(state.model, state.optimizer, saved)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(params[n])
                state.ema[n].copy_(params[n])
        state.step = 1
    for b in batches:
        eager, _ = step(eager, b)
    graphed, _ = multistep(graphed, batches)
    for a, b in zip(_changed_tensors(eager), _changed_tensors(graphed)):
        assert torch.equal(a, b)
    name = next(iter(graphed.ema))
    graphed.ema[name] = graphed.ema[name].clone()
    with pytest.raises(RuntimeError, match='rebound'):
        multistep(graphed, batches)


# ---------------------------------------------------------------------------
# the threefry2x32 kernels (csrc/threefry.cu)
# ---------------------------------------------------------------------------

def _same_bits(a, b) -> bool:
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and torch.equal(a.view(view[a.dtype]),
                                              b.view(view[b.dtype]))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('p', [0.1, 0.5])
@pytest.mark.parametrize('whole,block,offsets', [
    ((7,), None, None), ((3, 5, 7), None, None),
    ((32, 96, 4096), None, None), ((32, 4, 256, 256), None, None),
    ((32, 96, 4096), (16, 96, 2048), (16, 0, 2048)),
    ((16, 800, 128), (16, 400, 128), (0, 400, 0)),
    ((4, 2, 21, 256), (2, 1, 21, 256), (2, 1, 0, 0))])
def test_threefry_dropout_kernel_matches_plain_on_card(cuda, dtype, p, whole,
                                                       block, offsets):
    '''The kernel's block of the mask of ``whole`` (all of it when block is
    None) against the plain version's whole draw sliced there, bit for
    bit; one launch.'''
    from bmt_tpu_torch.ops import prng
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(whole, generator=g, device=cuda).to(dtype) * 10
    key = prng.Key(prng.key(5, cuda), (3, 7))
    where = tuple(slice(o, o + b) for o, b in zip(offsets, block)) \
        if block else tuple(slice(None) for _ in whole)
    before = prng.dropout_kernel.launches
    got = prng.dropout_kernel(x[where].contiguous(), key, p, whole,
                              offsets or (0,) * len(whole))
    torch.cuda.synchronize()
    assert prng.dropout_kernel.launches == before + 1
    want = prng.dropout_reference(x, key, p)[where].contiguous()
    assert _same_bits(got, want)


@pytest.mark.parametrize('whole,block,offsets', [
    ((64, 10172), None, None), ((64, 10172), (32, 10172), (32, 0)),
    ((5,), None, None), ((2, 3, 4, 5), (1, 3, 2, 5), (1, 0, 2, 0))])
def test_threefry_bits32_kernel_matches_plain_on_card(cuda, whole, block,
                                                      offsets):
    from bmt_tpu_torch.ops import prng
    key = prng.Key(prng.key(9, cuda), (1,))
    got = prng.bits32_kernel(key, whole, block, offsets)
    want = prng.bits_reference(key, whole, torch.uint32, block, offsets)
    assert torch.equal(got.to(torch.int64), want.to(torch.int64))
    # uniform and categorical take the kernel's bits on the card
    u = prng.uniform(key, whole, block=block, offsets=offsets)
    cpu = prng.uniform(prng.Key(key.base.cpu(), key.path), whole,
                       block=block, offsets=offsets)
    assert torch.equal(u.cpu(), cpu)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_threefry_dropout_backward_on_card(cuda, dtype):
    '''The backward runs the kernel on the gradient: the forward's mask,
    g / keep where kept; two launches.'''
    from bmt_tpu_torch.ops import prng
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4, 33, 65, generator=g, device=cuda).to(dtype)
    x.requires_grad_()
    grad = torch.randn(4, 33, 65, generator=g, device=cuda).to(dtype)
    key = prng.key(4, cuda)
    before = prng.dropout_kernel.launches
    prng.dropout(x, key, 0.1).backward(grad)
    torch.cuda.synchronize()
    assert prng.dropout_kernel.launches == before + 2
    assert _same_bits(x.grad, prng.dropout_reference(grad, key, 0.1))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('conv,offsets,whole', [
    ((16, 512, 800), (0, 0, 0), None), ((2, 24, 37), (0, 0, 0), None),
    ((16, 512, 400), (0, 400, 0), (16, 800, 512))])
def test_threefry_dropout_reads_a_transposed_view_in_place_on_card(
        cuda, dtype, conv, offsets, whole):
    '''A proposal head's (B, D, S) conv output dropped through its
    (B, S, D) view (at the proposal cell's head width, whole and an sp
    block): no copy, the result has the view's strides, each element
    keeps the mask of its (B, S, D) index, and the gradient too.'''
    from bmt_tpu_torch.ops import prng
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(conv, generator=g, device=cuda).to(dtype)
    key = prng.Key(prng.key(7, cuda), (1, 2))
    view = x.transpose(1, 2)
    whole = whole or tuple(view.shape)
    got = prng.dropout_kernel(view, key, 0.1, whole, offsets)
    assert got.stride() == view.stride()
    want = prng.dropout_reference(view.contiguous(), key, 0.1, whole,
                                  offsets)
    assert _same_bits(got.contiguous(), want)
    leaf = x.clone().requires_grad_()
    grad = torch.randn(conv, generator=g, device=cuda).to(dtype)
    prng.dropout(leaf.transpose(1, 2), key, 0.1, whole, offsets).backward(
        grad.transpose(1, 2))
    assert _same_bits(leaf.grad.transpose(1, 2).contiguous(),
                      prng.dropout_reference(grad.transpose(1, 2).contiguous(),
                                             key, 0.1, whole, offsets))
    strided = x[:, ::2]                 # not dense: copied, then drawn
    assert _same_bits(
        prng.dropout_kernel(strided, key, 0.1, strided.shape,
                            (0, 0, 0)).contiguous(),
        prng.dropout_reference(strided.contiguous(), key, 0.1))


def test_threefry_kernel_reads_its_key_at_each_replay_on_card(cuda):
    '''Captured in a CUDA graph, the kernel reads the key from its buffer
    when the graph replays: a new key there gives that key's mask.'''
    from bmt_tpu_torch.ops import prng
    x = torch.randn(8, 100, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    buf = prng.key(0, cuda)
    prng.dropout_kernel(x, prng.Key(buf), 0.3, x.shape, (0, 0))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prng.dropout_kernel(x, prng.Key(buf, (2,)), 0.3, x.shape,
                                  (0, 0))
    for seed in (1, 2):
        buf.copy_(prng.key(seed, cuda))
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, prng.dropout_reference(
            x, prng.Key(prng.key(seed, cuda), (2,)), 0.3))


def test_threefry_kernels_refuse_bad_inputs_on_card(cuda):
    from bmt_tpu_torch.ops import prng
    x = torch.ones(4, 4, device=cuda)
    with pytest.raises(ValueError, match='uint32'):
        prng.dropout_kernel(x, prng.Key(torch.zeros(2, device=cuda)), 0.1,
                            x.shape, (0, 0))
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        prng.dropout_kernel(x.half(), prng.Key(prng.key(0, cuda)), 0.1,
                            x.shape, (0, 0))
    with pytest.raises(ValueError, match='folds'):
        prng.dropout_kernel(x, prng.Key(prng.key(0, cuda), tuple(range(9))),
                            0.1, x.shape, (0, 0))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_rbg_graphed_steps_equal_eager_steps_on_card(cuda, dtype):
    '''Under prng_impl 'rbg' (the generator path) a graphed bundle is its
    eager steps bit for bit too, and launches no threefry kernel.'''
    from bmt_tpu_torch.ops import launches, prng
    from bmt_tpu_torch.train.steps import init_train_state, make_multistep
    cells = []
    for _ in range(2):
        state, step, batches = _small_cell(cuda, 'cap', dtype)
        cells.append((init_train_state(state.model, state.optimizer, seed=3,
                                       ema=True, prng_impl='rbg'), step))
    (eager, step), (graphed, gstep) = cells
    multistep = make_multistep(gstep)
    launches.reset([prng.KERNEL_DROPOUT, prng.KERNEL_BITS32])
    for _ in range(2):
        losses = []
        for b in batches:
            eager, m = step(eager, b)
            losses.append(m['loss'])
        graphed, m = multistep(graphed, batches)
        torch.testing.assert_close(m['loss'], torch.stack(losses), atol=0,
                                   rtol=0)
    assert prng.dropout_kernel.launches == prng.bits32_kernel.launches == 0
    for a, b in zip(_changed_tensors(eager), _changed_tensors(graphed)):
        assert torch.equal(a, b)


def test_failed_capture_raises_on_card(cuda):
    '''A step whose body reads the device on the host cannot be captured:
    the bundle raises (the warm-up step ran; nothing falls back to eager
    steps after it).'''
    from bmt_tpu_torch.train.steps import TrainStep, make_multistep
    state, step, batches = _small_cell(cuda, 'cap', torch.float32)

    def body(state, inputs):
        out = step.body(state, inputs)
        out['host'] = torch.tensor(out['loss'].item())
        return out
    multistep = make_multistep(TrainStep(body, step.casts, key=step.key))
    with pytest.raises(RuntimeError, match='capturing the train step'):
        multistep(state, batches)
    assert state.step == 1
