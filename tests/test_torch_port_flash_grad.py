'''The plain versions of the attention kernels' training path against the
JAX package on the CPU: the lse forward against the tiled Pallas forward
(interpret mode), the backward against ``jax.vjp`` of the tiled Pallas
backward (``block_k=128``) and of the single-block custom VJP, and
``torch.autograd.gradcheck`` of ``FlashAttention`` in float64. The cases
are those of tests/test_pallas_grad.py: Sk=300 key padding (three key
blocks, the last partial), causal with padding, and a batch row with every
key masked.

Tolerances (fp32): 1e-5 absolute on outputs and lse, 2e-5 on gradients of
O(1): the same sums in another order over at most 300 keys. The plain
backward in bf16 is held to the tiled Pallas backward in bf16 within one
bf16 ulp: the two round at the same points. The CUDA
kernels are held to these plain versions in test_torch_port_cuda.py and
chip_smoke.py, which need a card.'''
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.ops.masks import subsequent_mask
from bmt_tpu.ops.pallas_attention import (_flash_attention_tiled,
                                          _flash_attention_tiled_bwd)
from bmt_tpu.ops.pallas_attention import flash_attention as j_flash_attention
from bmt_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention, flash_attention_backward_reference,
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_reference,
    flash_attention_bwd_dq, flash_attention_bwd_dq_reference,
    flash_attention_lse_reference, key_mask_and_causal, launch_counts,
    row_dot)
from tests.torch_port_util import assert_close_nan

ATOL, GRAD_ATOL = 1e-5, 2e-5


def _case(kind, rng):
    '''(q, k, v, dout, boolean mask (B, 1, 1|Sq, Sk)) as numpy.'''
    if kind == 'sk300_padding':
        B, H, Sq, Sk, d = 2, 2, 9, 300, 8
        m = np.ones((B, 1, 1, Sk), bool)
        m[1, ..., 250:] = False
    elif kind == 'causal_padding':
        B, H, Sq, Sk, d = 2, 2, 10, 10, 8
        pad = np.ones((B, 1, Sk), bool)
        pad[0, 0, 7:] = False
        causal = np.asarray(subsequent_mask(Sk))
        m = (pad[:, :, None, :] & causal[None])[:, 0][:, None]
    else:                                      # 'empty_row'
        B, H, Sq, Sk, d = 2, 1, 4, 140, 8
        m = np.ones((B, 1, 1, Sk), bool)
        m[0] = False                           # batch row 0: nothing to see
    q, k, v = (rng.normal(size=(B, H, S, d)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    dout = rng.normal(size=(B, H, Sq, d)).astype(np.float32)
    return q, k, v, dout, m


CASES = ['sk300_padding', 'causal_padding', 'empty_row']


@pytest.mark.parametrize('kind', CASES)
def test_lse_forward_matches_tiled_pallas(kind):
    q, k, v, _, m = _case(kind, np.random.default_rng(0))
    key_mask, causal = key_mask_and_causal(torch.from_numpy(m), q.shape[0],
                                           k.shape[2], 'cpu')
    jout, jlse = _flash_attention_tiled(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(key_mask.numpy()), causal, interpret=True, block_k=128,
        with_lse=True)
    out, lse = flash_attention_lse_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_mask, causal)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    assert_close_nan(out.numpy(), np.asarray(jout), ATOL)
    jlse = np.asarray(jlse)[..., 0]
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(jlse))
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL)
    if kind == 'empty_row':
        assert np.isneginf(lse[0].numpy()).all()


@pytest.mark.parametrize('kind', CASES)
@pytest.mark.parametrize('block_k', [128, None],
                         ids=['tiled_pallas_bwd', 'single_block_vjp'])
def test_backward_matches_jax_vjp(kind, block_k):
    '''Gradients through the wrapper under autograd (FlashAttention with
    the plain versions on the CPU) against jax.vjp of the JAX kernel with
    the same output cotangent; an empty row has zero gradients in all.'''
    q, k, v, dout, m = _case(kind, np.random.default_rng(1))
    _, vjp = jax.vjp(lambda q, k, v: j_flash_attention(
        q, k, v, jnp.asarray(m), block_k=block_k),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = launch_counts()
    got = torch.autograd.grad(flash_attention(tq, tk, tv, torch.from_numpy(m)),
                              (tq, tk, tv), torch.from_numpy(dout))
    assert launch_counts() == before             # no kernel on the CPU
    for name, a, b in zip('qkv', got, want):
        assert not a.isnan().any(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=f'd{name}')
    if kind == 'empty_row':
        assert all(float(g[0].abs().max()) == 0.0 for g in got)


@pytest.mark.parametrize('kind', CASES)
def test_bf16_backward_references_match_tiled_pallas(kind):
    '''bf16: the plain dQ and dK/dV, which the bf16 CUDA kernels are held to
    on the card, against the tiled Pallas backward in interpret mode on the
    same bf16 q, k, v, dO and the JAX forward's lse and out. Both round dS
    to bf16 before dQ and dK, P before dV, and each gradient to bf16 at the
    end. Tolerance: one bf16 ulp (2^-7 relative) over atol 1e-3, for the
    sums of fp32 products taken in another order before the last
    rounding.'''
    q, k, v, dout, m = _case(kind, np.random.default_rng(4))
    key_mask, causal = key_mask_and_causal(torch.from_numpy(m), q.shape[0],
                                           k.shape[2], 'cpu')
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    jkm = jnp.asarray(key_mask.numpy())
    jout, jlse = _flash_attention_tiled(jq, jk, jv, jkm, causal,
                                        interpret=True, block_k=128,
                                        with_lse=True)
    want = _flash_attention_tiled_bwd(jq, jk, jv, jkm, jlse, jout, jdo,
                                      causal, interpret=True, block_k=128)

    def bf16(x):                       # exact: bf16 values are fp32 values
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)

    tq, tk, tv, tdo, tout = (bf16(x) for x in (jq, jk, jv, jdo, jout))
    lse = torch.from_numpy(np.array(jlse)[..., 0])
    drow = row_dot(tout, tdo)
    dq = flash_attention_bwd_dq_reference(tq, tk, tv, key_mask, causal, lse,
                                          drow, tdo)
    dk, dv = flash_attention_bwd_dkv_reference(tq, tk, tv, key_mask, causal,
                                               lse, drow, tdo)
    for name, got, ref in zip(('dq', 'dk', 'dv'), (dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and not got.isnan().any(), name
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2 ** -7, atol=1e-3, err_msg=name)
    if kind == 'empty_row':
        assert all(float(g[0].abs().max()) == 0.0 for g in (dq, dk, dv))


@pytest.mark.parametrize('kind', ['sk300_padding', 'causal_padding'])
def test_backward_reference_equals_autograd_of_plain_forward(kind):
    '''flash_attention_backward_reference is the VJP of the plain forward
    (autograd through flash_attention_lse_reference's softmax).'''
    q, k, v, dout, m = _case(kind, np.random.default_rng(2))
    key_mask, causal = key_mask_and_causal(torch.from_numpy(m), q.shape[0],
                                           k.shape[2], 'cpu')
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = flash_attention_lse_reference(tq, tk, tv, key_mask, causal)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    got = flash_attention_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), key_mask, causal,
        out.detach(), lse.detach(), torch.from_numpy(dout))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL)


@pytest.mark.parametrize('causal', [False, True])
def test_flash_attention_gradcheck_float64(causal):
    g = torch.Generator().manual_seed(3)
    B, H, Sq, Sk, d = 2, 2, 5, 5 if causal else 7, 8
    q, k, v = (torch.randn(B, H, S, d, generator=g, dtype=torch.float64,
                           requires_grad=True) for S in (Sq, Sk, Sk))
    key_mask = torch.ones(B, Sk, dtype=torch.int32)
    key_mask[1, 3:] = 0
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, key_mask, causal),
        (q, k, v))


def test_backward_wrappers_never_run_plain_off_the_cpu():
    '''A tensor that is not on the CPU goes to the kernel launcher, which
    takes only CUDA tensors: there is no fallback to the plain version.'''
    t = torch.empty(1, 1, 4, 8, device='meta')
    km = torch.ones(1, 4, dtype=torch.int32, device='meta')
    rows = torch.empty(1, 1, 4, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        flash_attention_bwd_dq(t, t, t, km, False, rows, rows, t)
    with pytest.raises(ValueError, match='CUDA'):
        flash_attention_bwd_dkv(t, t, t, km, False, rows, rows, t)
