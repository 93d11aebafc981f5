'''The bf16 forward's key split in plain PyTorch on the CPU: each key chunk's
partial (m, l and the unnormalised O, p rounded to bf16 for the value
product as the kernel does), joined in split order by the combine kernel's
plain version, against the unsplit plain forward and against the JAX
package's ``flash_attention`` (the Pallas kernel in interpret mode, bf16).
The CUDA kernels themselves are held to these plain versions on the card
(test_torch_port_cuda.py, chip_smoke.py).

Tolerance: ``KERNEL_TOL[bf16]`` = (2e-2, 1e-2), |got - want| <= atol + rtol
|want|, as the card tests hold the kernel: the output rounds to bf16 (one
ulp is 2^-7 relative), and the split rounds each chunk's p, taken against
the chunk's own max, where the unsplit version rounds the normalised p, so
the two may differ by an ulp or two. lse: fp32 sums in another order,
1e-5.'''
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bmt_tpu.ops.pallas_attention import flash_attention as j_flash_attention
from bmt_tpu_torch.ops.flash_attention import (
    BF16_BK, bf16_key_splits, combine_partials, flash_attention_lse_reference,
    key_mask_and_causal, split_partials)

KERNEL_TOL = {torch.bfloat16: (2e-2, 1e-2)}
LSE_ATOL = 1e-5


def _case(kind, rng):
    '''(q, k, v as numpy fp32 values of bf16, boolean mask (B, 1, 1|Sq,
    Sk)). The last batch row sees no key.'''
    causal = kind.startswith('causal')
    B, H, d = 3, 2, 16
    Sq, Sk = (130, 130) if causal else (70, 200)
    if kind == 'short_keys':
        Sk = 100                       # two 64-key tiles
    m = np.ones((B, 1, 1, Sk), bool)
    if not causal:
        m[1, ..., Sk * 3 // 5:] = False        # a ragged key padding
    m[-1] = False                              # nothing to see
    if causal:
        m = m & np.tri(Sq, Sk, dtype=bool)[None, None]
    q, k, v = (rng.normal(size=(B, H, S, d)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    # values exactly representable in bf16, so both frameworks see the same
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy()
               for x in (q, k, v))
    return q, k, v, m


def _split(kind, splits):
    q, k, v, m = _case(kind, np.random.default_rng(7))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    key_mask, causal = key_mask_and_causal(torch.from_numpy(m), q.shape[0],
                                           k.shape[2], 'cpu')
    parts = split_partials(tq, tk, tv, key_mask, causal, splits, BF16_BK)
    out, lse = combine_partials(*parts, torch.bfloat16)
    return (q, k, v, m), (tq, tk, tv, key_mask, causal), parts, out, lse


def _close(got, want):
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    got, want = got.float(), want.float()
    assert torch.equal(got.isnan(), want.isnan())
    diff = (got - want).nan_to_num(0.0).abs()
    assert bool((diff <= atol + rtol * want.nan_to_num(0.0).abs()).all()), \
        float(diff.max())


# (kind, splits): the padded 70x200 call over 4 key tiles in 2, 3 and 4
# chunks; causal 130x130 over 3 tiles, whose first query rows see no key
# of the later chunks; 100 keys (2 tiles) over 3 chunks, the last holding
# no key tile at all
CASES = [('padding', 2), ('padding', 3), ('padding', 4), ('causal', 2),
         ('causal', 3), ('short_keys', 3)]


@pytest.mark.parametrize('kind,splits', CASES)
def test_split_partials_join_to_the_unsplit_forward(kind, splits):
    _, (tq, tk, tv, key_mask, causal), (m, l, o), out, lse = _split(kind,
                                                                   splits)
    assert m.shape[0] == l.shape[0] == o.shape[0] == splits
    want_out, want_lse = flash_attention_lse_reference(tq, tk, tv, key_mask,
                                                       causal)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    _close(out, want_out)
    assert torch.equal(lse.isneginf(), want_lse.isneginf())
    np.testing.assert_allclose(lse.nan_to_num(neginf=0.0).numpy(),
                               want_lse.nan_to_num(neginf=0.0).numpy(),
                               atol=LSE_ATOL)
    # the batch row with every key masked: empty in every split, so NaN
    # out and lse -inf, as without the split
    assert m[:, -1].isneginf().all() and (l[:, -1] == 0).all()
    assert out[-1].isnan().all() and lse[-1].isneginf().all()
    assert not out[0].isnan().any()


@pytest.mark.parametrize('kind,splits', CASES)
def test_split_forward_matches_the_pallas_kernel(kind, splits):
    (q, k, v, m), _, _, out, _ = _split(kind, splits)
    want = j_flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                               for x in (q, k, v)), jnp.asarray(m))
    want = torch.from_numpy(np.asarray(want, np.float32))
    _close(out, want)


def test_a_chunk_past_the_keys_is_an_empty_partial():
    '''100 keys are two 64-key tiles; a third chunk holds none and
    contributes nothing: m = -inf, l = 0, O = 0 in every row.'''
    _, _, (m, l, o), _, _ = _split('short_keys', 3)
    assert m[2].isneginf().all() and (l[2] == 0).all() and (o[2] == 0).all()


def test_causal_rows_before_a_chunk_get_empty_partials():
    '''Causal 130x130 in 3 chunks of one tile: query rows 0-63 see no key
    of chunks 1 and 2, rows 64-127 none of chunk 2.'''
    _, _, (m, l, _), _, _ = _split('causal', 3)
    assert m[1, :-1, :, :64].isneginf().all()
    assert m[2, :-1, :, :128].isneginf().all()
    assert (l[2, :-1, :, :128] == 0).all()
    assert not m[2, :-1, :, 128:].isneginf().any()


def test_the_rule_splits_a_served_videos_calls():
    '''The split the card takes at a served video's B=1 calls (132 SMs):
    more than one chunk, none empty, so the partials above are the
    kernel's.'''
    for sq, sk in ((800, 800), (300, 300), (800, 300), (300, 800)):
        splits = bf16_key_splits(1, 4, sq, sk, 256, 132)
        tiles = -(-sk // BF16_BK)
        assert 1 < splits <= tiles
        assert (splits - 1) * -(-tiles // splits) < tiles
