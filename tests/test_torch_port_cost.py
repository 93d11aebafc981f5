'''The attention kernels' cost model (FLOPs and bytes from shapes, for the
bound a chip measurement is held against) and the kernel build's cache key.
Neither needs a card or nvcc.'''
import pytest
import torch

from bmt_tpu_torch.ops import _build
from bmt_tpu_torch.ops.flash_attention import (BF16_BK, BF16_BQ, FP32_BK,
                                               FP32_BQ, FP32_CLUSTER, KERNEL,
                                               KERNEL_DKV,
                                               KERNEL_DQ, attention_bound_ms,
                                               attention_cost,
                                               bf16_key_splits,
                                               fp32_key_splits, key_splits)

# the train cell's encoder self-attention call: B=32, H=4, S=256, d=256
TRAIN_CALL = (32, 4, 256, 256, 256)


@pytest.mark.parametrize('kernel,mbytes,products', [
    (KERNEL, 67.3, 2), (KERNEL_DQ, 84.2, 3), (KERNEL_DKV, 101.0, 4)])
def test_cost_at_the_train_call(kernel, mbytes, products):
    '''bf16 at B=32, H=4, S=256, d=256: 67.3, 84.2 and 101.0 MB, 2 d FLOPs
    per pair and product; memory-bound on the H100 (128-171 FLOP/byte
    against its 295).'''
    flops, nbytes = attention_cost(kernel, *TRAIN_CALL, 'bfloat16', False)
    assert round(nbytes / 1e6, 1) == mbytes
    assert flops == 2 * products * 32 * 4 * 256 * 256 * 256
    bound, by = attention_bound_ms(flops, nbytes, 'bfloat16')
    assert by == 'bytes'
    assert bound == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_cost_counts_each_input_and_output_once():
    B, H, Sq, Sk, d = 2, 3, 5, 7, 8
    t_q, t_k = B * H * Sq * d * 2, B * H * Sk * d * 2      # bf16 bytes
    mask, row = B * Sk * 4, B * H * Sq * 4
    cost = {kern: attention_cost(kern, B, H, Sq, Sk, d, 'bfloat16',
                                 False)[1] for kern in (KERNEL, KERNEL_DQ,
                                                        KERNEL_DKV)}
    assert cost[KERNEL] == 2 * t_q + 2 * t_k + mask + row
    assert attention_cost(KERNEL, B, H, Sq, Sk, d, 'bfloat16', False,
                          with_lse=False)[1] == 2 * t_q + 2 * t_k + mask
    assert cost[KERNEL_DQ] == 3 * t_q + 2 * t_k + mask + 2 * row
    assert cost[KERNEL_DKV] == 2 * t_q + 4 * t_k + mask + 2 * row
    assert attention_cost(KERNEL, B, H, Sq, Sk, d, 'float32', False)[1] \
        == 2 * (2 * t_q + 2 * t_k) + mask + row


@pytest.mark.parametrize('S', [1, 21, 256, 2048])
def test_causal_cost_counts_half_the_pairs_plus_the_diagonal(S):
    for kernel, products in ((KERNEL, 2), (KERNEL_DQ, 3), (KERNEL_DKV, 4)):
        full, nb = attention_cost(kernel, 2, 4, S, S, 64, 'bfloat16', False)
        causal, nb_c = attention_cost(kernel, 2, 4, S, S, 64, 'bfloat16',
                                      True)
        assert causal == 2 * products * 2 * 4 * 64 * (S * (S + 1) // 2)
        assert full == 2 * products * 2 * 4 * 64 * S * S
        assert nb_c == nb                      # the bytes do not change


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert attention_bound_ms(989e9, 1, 'bfloat16') == pytest.approx(
        (1.0, 'operations'))
    assert attention_bound_ms(1, 3.35e9, 'bfloat16') == pytest.approx(
        (1.0, 'bytes'))
    # fp32 on the tensor cores: three TF32 products a product, 495 / 3
    assert attention_bound_ms(165e9, 1, 'float32')[0] == pytest.approx(1.0)


@pytest.mark.parametrize('B,Sq,Sk,splits', [
    (1, 800, 800, 1), (1, 300, 300, 3), (1, 800, 300, 1), (1, 300, 800, 3),
    (100, 512, 512, 1), (100, 192, 192, 1), (2, 64, 64, 2), (1, 64, 2048, 16)])
def test_fp32_key_splits_fill_one_wave(B, Sq, Sk, splits):
    '''The fp32 forward at H=4, d=256 on 132 SMs, a cluster of two blocks
    a 64-row query tile: the app's B=1 proposal calls at 300 query rows
    split their key loops (40 blocks take 3 splits of 4 key tiles), those
    at 800 rows (104 blocks) and its B=100 caption calls do not, and no
    split is empty.'''
    assert fp32_key_splits(B, 4, Sq, Sk, 256, 132) == splits
    blocks = B * 4 * -(-Sq // FP32_BQ) * FP32_CLUSTER
    tiles = -(-Sk // FP32_BK)
    chunk = -(-tiles // splits)
    assert blocks * splits <= max(blocks, 132)
    assert (splits - 1) * chunk < tiles <= splits * chunk


def test_fp32_key_splits_never_exceed_the_key_tiles():
    for Sk in (1, 31, 32, 33, 95):
        for d in (32, 64, 256):
            for n_sms in (1, 8, 132, 1000):
                splits = fp32_key_splits(1, 1, 1, Sk, d, n_sms)
                assert 1 <= splits <= -(-Sk // FP32_BK)


@pytest.mark.parametrize('B,Sq,Sk,d', [
    (1, 800, 800, 256), (1, 300, 300, 256), (1, 800, 300, 256),
    (1, 300, 800, 256), (1, 800, 800, 32), (1, 23, 800, 32)])
def test_bf16_key_splits_fill_at_most_one_wave(B, Sq, Sk, d):
    '''The bf16 forward at H=4 on 132 SMs: a served video's B=1 calls (and
    the audio models' at d = 32, two blocks an SM) split their key loops
    over more than one block, the blocks of all splits fill at most one
    wave, and no split is empty.'''
    splits = bf16_key_splits(B, 4, Sq, Sk, d, 132)
    blocks, tiles = B * 4 * -(-Sq // BF16_BQ), -(-Sk // BF16_BK)
    wave = 132 * (2 if d <= 32 else 1)
    chunk = -(-tiles // splits)
    assert 1 < splits <= tiles
    assert blocks * splits <= wave
    assert (splits - 1) * chunk < tiles <= splits * chunk


@pytest.mark.parametrize('B,H,Sq,Sk,d', [
    (32, 4, 256, 256, 256), (16, 4, 800, 800, 256), (32, 4, 21, 256, 256),
    (32, 4, 800, 800, 32), (16, 2, 800, 800, 256), (8, 4, 256, 256, 256),
    (8, 4, 96, 96, 256), (2, 4, 300, 800, 256)])
def test_bf16_key_splits_leave_calls_that_fill_the_card_whole(B, H, Sq, Sk,
                                                              d):
    '''The train cell's calls, the proposal cell's B=16 800x800, the
    decoder's 21-row calls at B=32 (128 blocks, one a head and batch row:
    132 // 128 = 1), the audio encoder at d = 32 and H = 2 take no split;
    nor do launches of several batch rows that leave the card idle (the
    pipeline's 8-row microbatches, two videos), so that a row's bits do
    not hang on how its batch is cut.'''
    assert bf16_key_splits(B, H, Sq, Sk, d, 132) == 1


def test_bf16_key_splits_never_exceed_the_key_tiles():
    for Sk in (1, 63, 64, 65, 129, 800):
        for d in (8, 32, 64, 256):
            for n_sms in (1, 8, 132, 1000):
                splits = bf16_key_splits(1, 1, 1, Sk, d, n_sms)
                tiles = -(-Sk // BF16_BK)
                chunk = -(-tiles // splits)
                assert 1 <= splits <= tiles
                assert (splits - 1) * chunk < tiles <= splits * chunk


def test_key_splits_pick_the_rule_by_dtype():
    assert key_splits(1, 4, 800, 800, 256, torch.bfloat16, 132) == \
        bf16_key_splits(1, 4, 800, 800, 256, 132) == 4
    assert key_splits(1, 4, 300, 800, 256, torch.float32, 132) == \
        fp32_key_splits(1, 4, 300, 800, 256, 132) == 3


def test_library_path_changes_with_any_header(tmp_path, monkeypatch):
    '''The built library's name hashes the source and every csrc/*.cuh, so
    an edited header never loads a stale library.'''
    monkeypatch.setattr(_build, 'CSRC_DIR', tmp_path)
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\n')
    (tmp_path / 'a.cuh').write_text('// a\n')
    (tmp_path / 'b.cuh').write_text('// b\n')
    first = _build._lib_path('k')
    assert _build._lib_path('k') == first              # deterministic
    (tmp_path / 'b.cuh').write_text('// b, edited\n')
    second = _build._lib_path('k')
    assert second != first
    (tmp_path / 'c.cuh').write_text('// new\n')
    third = _build._lib_path('k')
    assert third not in (first, second)
    (tmp_path / 'k.cu').write_text('#include "a.cuh"\n// edited\n')
    assert _build._lib_path('k') not in (first, second, third)
    assert first.parent == _build.BUILD_DIR and first.name.startswith('k-')


def test_the_real_sources_hash_their_header():
    '''Both kernel sources include the shared headers, which exist: the
    small one (cp.async of the masks, quad reductions) and the Hopper one
    (wgmma, TMA, the TF32 products and the tensor-map builder), which the
    fp32 forward includes too. The mma.sync header of the fp32 forward's
    earlier kernel is gone.'''
    header = _build.CSRC_DIR / 'mma_bf16.cuh'
    assert header.exists()
    for name in ('flash_attn_fwd', 'flash_attn_bwd'):
        assert '#include "mma_bf16.cuh"' in (
            _build.CSRC_DIR / f'{name}.cu').read_text()
    assert not (_build.CSRC_DIR / 'mma_tf32.cuh').exists()
    assert 'mma_tf32' not in (
        _build.CSRC_DIR / 'flash_attn_fwd.cu').read_text()
    # the shared Hopper header (wgmma, TMA and the tensor-map builder)
    assert (_build.CSRC_DIR / 'sm90.cuh').exists()
    for name in ('flash_attn_fwd', 'flash_attn_bwd'):
        src = (_build.CSRC_DIR / f'{name}.cu').read_text()
        assert '#include "sm90.cuh"' in src
        assert 'cuTensorMapEncodeTiled' not in src       # one copy, there
