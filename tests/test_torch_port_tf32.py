'''The numerical plan of the fp32 attention forward kernel
(csrc/flash_attn_fwd.cu, csrc/mma_tf32.cuh), held to the JAX package on the
CPU.

The kernel runs fp32 products on the tensor cores in TF32: each operand x is
split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and each m16n8k8
step adds lo hi, hi lo, then hi hi into fp32 accumulators: three for
S = Q K^T, summed (lh + hl) + hh at the end, and O itself for P V. P V pairs
P's key columns 2 t, 2 t + 1 with the mma's k = t, t + 4, and reads V's
rows in the same order. Each warp takes one half (16 keys) of every 32-key
tile with its own softmax state, and the two halves of a row are joined at
the end. With a key split, blocks write per-chunk (m, l, O) partials that a
second kernel combines the same way. This file emulates that arithmetic in numpy (a
test helper, not part of the package): the tensor core's products of TF32
values are exact, and each k-step's sum is added to the fp32 accumulator
with one rounding. The emulation is then held to the tiled Pallas forward of
``bmt_tpu.ops.pallas_attention`` in interpret mode, as
tests/test_pallas_attention.py runs it.

Tolerances are those the kernel is held to on the card (chip_smoke.py
``TOL[float32]``, ``LSE_TOL``; tests/test_torch_port_cuda.py): out within
1e-4 + 1e-5 |ref|, lse within 1e-5 + 1e-5 |ref|. Three products read
2-9e-7 against Pallas; one product reads 1.8-4.1e-4 on out and 1e-4 to
1.9e-4 on lse, outside both, which is why the kernel takes three.
'''
import numpy as np
import pytest

import jax.numpy as jnp

from bmt_tpu.ops.pallas_attention import _flash_attention_tiled

TOL = (1e-4, 1e-5)
LSE_TOL = (1e-5, 1e-5)
BK = 32                      # the kernel's key tile
LN2 = np.float32(0.693147180559945309)
LOG2E = np.float32(1.44269504088896341)
# mma k index -> key within an 8-key step: k = t <-> 2 t, k = t + 4 <-> 2 t + 1
KEY_ORDER = np.array([0, 2, 4, 6, 1, 3, 5, 7])


def rna_tf32(x):
    '''cvt.rna.tf32.f32: fp32 rounded to 10 mantissa bits, to nearest, ties
    away from zero (the low 13 bits become 0).'''
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mma(acc, a, b):
    '''acc + a b for one 8-deep k-step: exact products of TF32 values, one
    fp32 rounding where the sum meets the accumulator.'''
    return (acc.astype(np.float64)
            + np.matmul(a.astype(np.float64), b.astype(np.float64))
            ).astype(np.float32)


def tf32_product(acc, a, b, products):
    '''acc + a b over k-steps of 8, one accumulator (P V): lo hi, hi lo,
    hi hi with 3 products, hi hi alone with 1.'''
    ahi, alo = split(a)
    bhi, blo = split(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if products == 3:
            acc = mma(acc, alo[..., ks], bhi[..., ks, :])
            acc = mma(acc, ahi[..., ks], blo[..., ks, :])
        acc = mma(acc, ahi[..., ks], bhi[..., ks, :])
    return acc


def tf32_logits(a, b, products):
    '''a b over k-steps of 8 into three accumulators (Q K^T): lo hi, hi lo
    and hi hi each summed alone, then (lh + hl) + hh.'''
    ahi, alo = split(a)
    bhi, blo = split(b)
    zero = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    lh, hl, hh = zero, zero, zero
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if products == 3:
            lh = mma(lh, alo[..., ks], bhi[..., ks, :])
            hl = mma(hl, ahi[..., ks], blo[..., ks, :])
        hh = mma(hh, ahi[..., ks], bhi[..., ks, :])
    return (lh + hl) + hh


def half_partial(q, k, v, valid, tiles, half, causal, products):
    '''(m in base-2 units, l, unnormalised O) of one query tile (all of q's
    rows) over key half ``half`` (16 keys) of each key tile in ``tiles``,
    as one warp computes them: q (BH, Sq, d), k/v (BH, Sk, d), valid (BH,
    Sk) bool.'''
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    W = BK // 2
    scale2 = np.float32(1 / np.sqrt(np.float32(d))) * LOG2E
    o = np.zeros((BH, Sq, d), np.float32)
    m = np.full((BH, Sq), -np.inf, np.float32)
    l = np.zeros((BH, Sq), np.float32)
    rows = np.arange(Sq)[:, None]
    for t in tiles:
        k0 = t * BK + half * W
        n = max(0, min(W, Sk - k0))
        kt, vt = (np.zeros((BH, W, d), np.float32) for _ in range(2))
        ok = np.zeros((BH, 1, W), bool)
        kt[:, :n], vt[:, :n] = k[:, k0:k0 + n], v[:, k0:k0 + n]
        ok[:, 0, :n] = valid[:, k0:k0 + n]
        if causal:
            ok = ok & (k0 + np.arange(W)[None, :] <= rows)
        s = tf32_logits(q, kt.transpose(0, 2, 1), products)
        s = np.where(ok, s * scale2, np.float32(-np.inf))
        m_new = np.maximum(m, s.max(-1))
        empty = m_new == -np.inf
        with np.errstate(invalid='ignore'):
            corr = np.where(empty, 0, np.exp2(m - m_new)).astype(np.float32)
            p = np.where(empty[..., None], 0,
                         np.exp2(s - m_new[..., None])).astype(np.float32)
        m = m_new
        l = corr * l + p.sum(-1, dtype=np.float32)
        o = o * corr[..., None]
        for kk in range(0, W, 8):
            keys = kk + KEY_ORDER
            o = tf32_product(o, p[..., keys], vt[:, keys, :], products)
    return m, l, o


def merge(parts):
    '''(m, l, O) of partials over disjoint keys, each weighed by
    exp2(m_s - max m) (0 where m_s is -inf) and summed in order: how a block
    joins its two key halves and how flash_attn_fwd_combine_kernel joins
    the splits.'''
    m = np.max([p[0] for p in parts], axis=0)
    l = np.zeros_like(m)
    o = np.zeros_like(parts[0][2])
    with np.errstate(invalid='ignore'):
        for ms, ls, os_ in parts:
            w = np.where(ms == -np.inf, 0, np.exp2(ms - m)).astype(np.float32)
            l = l + w * ls
            o = o + w[..., None] * os_
    return m, l, o


def kernel_partial(q, k, v, valid, tiles, causal=False, products=3):
    '''One block's (m, l, O) over key tiles ``tiles``: its two key halves
    joined.'''
    return merge([half_partial(q, k, v, valid, tiles, half, causal, products)
                  for half in (0, 1)])


def finish(m, l, o):
    '''(out, lse) from (m, l, O), as the kernel writes them.'''
    with np.errstate(divide='ignore', invalid='ignore'):
        return o * (np.float32(1) / l)[..., None], m * LN2 + np.log(l)


def inputs(Sk, seed=0, B=2, H=2, Sq=64, d=256, empty_row=False):
    '''q, k, v (B, H, S, d) fp32 and the (B, Sk) int32 key mask: batch row 1
    keeps 65% of its keys (or none, with ``empty_row``).'''
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, d)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    km = np.ones((B, Sk), np.int32)
    km[1, 0 if empty_row else int(0.65 * Sk):] = 0
    return q, k, v, km


def emulate(q, k, v, km, causal=False, products=3, splits=1):
    '''The kernel's (out, lse) for (B, H, Sq, d) inputs, key tiles split
    into ``splits`` chunks of ceil(tiles / splits) (one: no split).'''
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    valid = np.repeat(km[:, None, :] != 0, H, axis=1).reshape(B * H, Sk)
    flat = [x.reshape(B * H, -1, d) for x in (q, k, v)]
    tiles = -(-Sk // BK)
    chunk = -(-tiles // splits)
    if causal:                       # no tile wholly above the diagonal
        tiles = min(tiles, (Sq - 1) // BK + 1)
    parts = [kernel_partial(*flat, valid,
                            range(s * chunk, min(tiles, (s + 1) * chunk)),
                            causal, products) for s in range(splits)]
    out, lse = finish(*merge(parts))
    return out.reshape(q.shape), lse.reshape(B, H, Sq)


def pallas(q, k, v, km, causal=False):
    out, lse = _flash_attention_tiled(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
        causal, interpret=True, block_k=128, with_lse=True)
    return np.asarray(out), np.asarray(lse)[..., 0]


def outside(got, want, tol):
    '''How many elements lie outside atol + rtol |want|.'''
    return int((np.abs(got - want) > tol[0] + tol[1] * np.abs(want)).sum())


def test_rna_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10                                 # TF32 at 1.0
    x = np.array([1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4, -(1 + ulp / 2),
                  1 + ulp / 2 - 2.0 ** -23, 0.0, 3.0], np.float32)
    want = np.array([1 + ulp, 1, 1 + ulp, -(1 + ulp), 1, 0, 3], np.float32)
    np.testing.assert_array_equal(rna_tf32(x), want)
    hi, lo = split(np.float32([np.pi, -1 / 3]))
    assert (hi.view(np.uint32) & 0x1FFF == 0).all()
    assert (lo.view(np.uint32) & 0x1FFF == 0).all()
    np.testing.assert_allclose(hi.astype(np.float64) + lo,
                               np.float32([np.pi, -1 / 3]), rtol=2 ** -21)


@pytest.mark.parametrize('Sk', [192, 512, 800])
def test_three_tf32_products_match_pallas_fp32(Sk):
    '''Three products, with P V over the permuted keys, meet the fp32
    tolerances against the Pallas forward and lse (read: 2-9e-7).'''
    q, k, v, km = inputs(Sk)
    out, lse = emulate(q, k, v, km)
    jout, jlse = pallas(q, k, v, km)
    assert outside(out, jout, TOL) == 0
    assert outside(lse, jlse, LSE_TOL) == 0
    np.testing.assert_allclose(out, jout, atol=2e-6)


@pytest.mark.parametrize('Sk', [192, 512, 800])
def test_one_tf32_product_misses_the_fp32_tolerance(Sk):
    '''hi hi alone leaves out and lse outside the fp32 tolerances: this is
    why the kernel takes three products.'''
    q, k, v, km = inputs(Sk)
    out, lse = emulate(q, k, v, km, products=1)
    jout, jlse = pallas(q, k, v, km)
    assert outside(out, jout, TOL) > 0
    assert outside(lse, jlse, LSE_TOL) > 0


def test_permuted_keys_give_the_same_product():
    '''P V with P's columns and V's rows both in KEY_ORDER sums the same
    terms: the result differs only by rounding.'''
    rng = np.random.default_rng(3)
    p = rng.random((2, 16, 8)).astype(np.float32)
    v = rng.normal(size=(2, 8, 24)).astype(np.float32)
    zero = np.zeros((2, 16, 24), np.float32)
    permuted = tf32_product(zero, p[..., KEY_ORDER], v[:, KEY_ORDER], 3)
    np.testing.assert_allclose(permuted, tf32_product(zero, p, v, 3),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(permuted, p.astype(np.float64) @ v,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('Sk,splits,causal,empty_row', [
    (800, 2, False, False), (300, 5, False, False), (800, 5, False, True),
    (192, 3, True, False)])
def test_split_partials_combine_to_the_unsplit_result(Sk, splits, causal,
                                                      empty_row):
    '''Per-chunk (m, l, O) partials combined as the combine kernel does give
    the unsplit result up to rounding, and the Pallas one within the fp32
    tolerances. An empty batch row is NaN with lse -inf either way; under
    causal the last split has no key tile left and writes an empty
    partial.'''
    q, k, v, km = inputs(Sk, empty_row=empty_row)
    out, lse = emulate(q, k, v, km, causal)
    got, got_lse = emulate(q, k, v, km, causal, splits=splits)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(out))
    np.testing.assert_array_equal(np.isneginf(got_lse), np.isneginf(lse))
    assert np.isnan(got[1]).all() == empty_row
    np.testing.assert_allclose(got, out, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_lse, lse, atol=1e-6, rtol=1e-6)
    jout, jlse = pallas(q, k, v, km, causal)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jout))
    fin = ~np.isnan(jout)
    assert outside(got[fin], jout[fin], TOL) == 0
    fin = ~np.isneginf(jlse)
    assert outside(got_lse[fin], jlse[fin], LSE_TOL) == 0
