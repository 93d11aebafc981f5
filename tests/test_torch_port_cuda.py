'''The CUDA attention kernels (forward with lse, dQ, dK/dV) against their
plain PyTorch versions, and the checkpoint loaders and the single-video app
through them, on the card.

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
    fp32_key_splits, key_mask_and_causal, launch_counts, row_dot)

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


def _app_key_mask(cuda, B, Sk, seed):
    '''B=1: every key valid (the proposal forward of a video as long as the
    pad). B>1: ragged valid lengths, as a caption batch's crops have.'''
    if B == 1:
        return torch.ones(1, Sk, dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    lengths = torch.randint(1, Sk + 1, (B,), generator=g, device=cuda)
    return (torch.arange(Sk, device=cuda)[None, :]
            < lengths[:, None]).int()


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
    ((1, 4, 800, 800, 256), 'none', None, 2),
    ((1, 4, 300, 300, 256), 'none', 200, 10),
    ((2, 4, 300, 800, 256), 'padding', 120, 3),
    ((2, 2, 129, 129, 64), 'causal', 60, 5)])
def test_fp32_key_split_is_deterministic_on_card(cuda, monkeypatch, shape,
                                                 kind, n_sms, splits):
    '''The fp32 forward with each row's key loop split over blocks: the
    count the rule picks for this card at B=1 (2 at 800 query rows), or one
    forced by giving the rule another SM count. Out and lse are the same
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
    assert fp32_key_splits(B, H, Sq, Sk, fa._sm_count(q.device)) == splits
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


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,kind', [
    ((2, 4, 256, 256, 256), 'padding'), ((2, 2, 129, 129, 64), 'causal'),
    ((2, 4, 256, 256, 256), 'causal')])
def test_backward_kernels_are_deterministic_on_card(cuda, dtype, shape,
                                                    kind):
    '''No atomics: one block owns a query tile (dQ) or a key tile (dK/dV)
    and sums over the other side's tiles in one fixed order, so two
    launches on the same inputs give the same bits, in fp32 (3xTF32) and in
    bf16.'''
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
