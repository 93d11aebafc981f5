'''The numerical plan of the fp32 attention kernels on tensor cores
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu, csrc/mma_tf32.cuh), held
to the JAX package on the CPU.

The kernels run fp32 products on the tensor cores in TF32: each operand x is
split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and each m16n8k8
step adds lo hi, hi lo, then hi hi into fp32 accumulators: three for
S = Q K^T, summed (lh + hl) + hh at the end, and O itself for P V. P V pairs
P's key columns 2 t, 2 t + 1 with the mma's k = t, t + 4, and reads V's
rows in the same order. Each warp takes one half (16 keys) of every 32-key
tile with its own softmax state, and the two halves of a row are joined at
the end. With a key split, blocks write per-chunk (m, l, O) partials that a
second kernel combines the same way.

The backward kernels (dQ over 16-key tiles, dK/dV over 16-query tiles) take
S and dP in two head-dim halves, each summed alone as S is above, then add
the halves; they rebuild P = exp2(S scale log2(e) - lse log2(e)) and
dS = P (dP - D) scale where the logit is valid (0 elsewhere), and sum each
tile's dS K, P^T dO and dS^T Q in two 8-wide steps with the columns paired
as in P V into a zeroed accumulator, which one fp32 add joins to dQ, dV or
dK. (The tensor core adds each mma's sum to its accumulator truncated, not
rounded, which this emulation cannot see; the zeroed accumulator keeps
that drift to one tile's terms: tests/test_torch_port_cuda.py holds it at
S = 2048, causal, on the card.)

This file emulates that arithmetic in numpy (a test helper, not part of the
package): the tensor core's products of TF32 values are exact, and each
k-step's sum is added to the fp32 accumulator with one rounding. The
emulation is then held to the tiled Pallas forward and backward of
``bmt_tpu.ops.pallas_attention`` in interpret mode, as
tests/test_pallas_attention.py runs them.

Tolerances are those the kernels are held to on the card (chip_smoke.py
``TOL[float32]``, ``LSE_TOL``, ``BWD_TOL[float32]``;
tests/test_torch_port_cuda.py): out and the gradients within
1e-4 + 1e-5 |ref|, lse within 1e-5 + 1e-5 |ref|. Forward: three products
read 2-9e-7 against Pallas; one product reads 1.8-4.1e-4 on out and 1e-4 to
1.9e-4 on lse, outside both, which is why the kernel takes three.
'''
import numpy as np
import pytest

import jax.numpy as jnp

from bmt_tpu.ops.pallas_attention import (_flash_attention_tiled,
                                          _flash_attention_tiled_bwd)

TOL = (1e-4, 1e-5)
LSE_TOL = (1e-5, 1e-5)
BK = 32                      # the forward kernel's key tile
BN = 16                      # the backward kernels' loop tile
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


# ---------------------------------------------------------------------------
# the backward: dQ, dK, dV
# ---------------------------------------------------------------------------

def pad_dim(x):
    '''x with its head dim zero-padded to the kernels' DP (64 or 256).'''
    d = x.shape[-1]
    dp = 64 if d <= 64 else 256
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, dp - d)])


def halves_logits(a, b, products):
    '''a b^T (a (BH, M, DP), b (BH, N, DP)) as the backward kernels take
    S and dP: each head-dim half summed alone into three accumulators
    (tf32_logits), then the two halves added.'''
    h = a.shape[-1] // 2
    return (tf32_logits(a[..., :h], b[..., :h].swapaxes(-1, -2), products)
            + tf32_logits(a[..., h:], b[..., h:].swapaxes(-1, -2), products))


def grad_product(acc, a, b, products):
    '''acc + a b over one 16-wide tile (a (BH, M, 16), b (BH, 16, n)) as
    the kernels add dS K, P^T dO and dS^T Q: two 8-wide steps with the
    columns in KEY_ORDER into a zeroed accumulator, then one fp32 add.'''
    t = np.zeros_like(acc)
    for c0 in (0, 8):
        cols = c0 + KEY_ORDER
        t = tf32_product(t, a[..., cols], b[:, cols], products)
    return acc + t


def probs(s, dp, ok, lse, D, scale):
    '''(P, dS) from the logits and dP, masked where the logit is not
    valid (never exp then mask): lse and D broadcast against s.'''
    with np.errstate(invalid='ignore', over='ignore'):
        p = np.where(ok, np.exp2(s * (scale * LOG2E) - lse * LOG2E),
                     0).astype(np.float32)
        ds = np.where(ok, p * (dp - D) * scale, 0).astype(np.float32)
    return p, ds


def tile(x, r0):
    '''Rows [r0, r0 + BN) of x (BH, S, ...), zero past S.'''
    out = np.zeros((x.shape[0], BN) + x.shape[2:], x.dtype)
    n = max(0, min(BN, x.shape[1] - r0))
    out[:, :n] = x[:, r0:r0 + n]
    return out


def emulate_bwd(q, k, v, km, lse, D, dout, causal=False, products=3):
    '''The kernels' (dQ, dK, dV) for (B, H, S, d) inputs, the forward's lse
    and D (B, H, Sq). Rows are independent, so each kernel's blocks are
    emulated all at once: dQ over key tiles of BN in order, dK/dV over
    query tiles of BN in order. A tile a block skips (causal) holds no
    valid logit and adds exact zeros here.'''
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    scale = np.float32(1 / np.sqrt(np.float32(d)))
    valid = np.repeat(km[:, None, :] != 0, H, axis=1).reshape(B * H, Sk)
    qf, kf, vf, of = (pad_dim(x).reshape(B * H, x.shape[2], -1)
                      for x in (q, k, v, dout))
    lf, Df = lse.reshape(B * H, Sq), D.reshape(B * H, Sq)
    qrow = np.arange(Sq)
    dq = np.zeros_like(qf)
    for k0 in range(0, Sk, BN):           # dQ: S (BH, Sq, BN)
        kt, vt = tile(kf, k0), tile(vf, k0)
        cols = k0 + np.arange(BN)
        ok = tile(valid, k0)[:, None, :]
        if causal:
            ok = ok & (cols[None, :] <= qrow[:, None])
        _, ds = probs(halves_logits(qf, kt, products),
                      halves_logits(of, vt, products), ok,
                      lf[..., None], Df[..., None], scale)
        dq = grad_product(dq, ds, kt, products)
    dk, dv = np.zeros_like(kf), np.zeros_like(vf)
    krow = np.arange(Sk)
    for q0 in range(0, Sq, BN):           # dK/dV: S^T (BH, Sk, BN)
        qt, ot = tile(qf, q0), tile(of, q0)
        lt, Dt = tile(lf, q0), tile(Df, q0)
        cols = q0 + np.arange(BN)
        ok = valid[..., None] & (cols < Sq)[None, None, :]
        if causal:
            ok = ok & (krow[:, None] <= cols[None, :])
        p, ds = probs(halves_logits(kf, qt, products),
                      halves_logits(vf, ot, products), ok,
                      lt[:, None, :], Dt[:, None, :], scale)
        dv = grad_product(dv, p, ot, products)
        dk = grad_product(dk, ds, qt, products)
    return tuple(g[..., :d].reshape(B, H, -1, d) for g in (dq, dk, dv))


def bwd_inputs(Sq, Sk, causal=False, empty_row=False, seed=0, d=256):
    '''q, k, v, key mask (inputs()), dO, and the Pallas forward's out and
    lse and D = rowsum(dO out) (NaN -> 0) for them.'''
    q, k, v, km = inputs(Sk, seed, Sq=Sq, d=d, empty_row=empty_row)
    dout = np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32)
    out, lse = pallas(q, k, v, km, causal)
    D = (dout * out).sum(-1, dtype=np.float32)
    return q, k, v, km, dout, out, lse, np.where(np.isnan(D), 0,
                                                 D).astype(np.float32)


def pallas_bwd(q, k, v, km, dout, out, lse, causal=False):
    '''(dq, dk, dv) of the tiled Pallas backward in interpret mode.'''
    lse8 = np.broadcast_to(lse[..., None], lse.shape + (8,))
    got = _flash_attention_tiled_bwd(
        *(jnp.asarray(x) for x in (q, k, v, km, lse8, out, dout)), causal,
        interpret=True, block_k=128)
    return tuple(np.asarray(g) for g in got)


BWD_CASES = {                 # (Sq, Sk, causal, empty_row, d)
    'sk192': (72, 192, False, False, 256),
    'sk300_padding': (72, 300, False, False, 256),
    'sk800_empty_row': (72, 800, False, True, 256),
    'causal': (72, 72, True, False, 256),
    'causal_d64_empty_row': (40, 40, True, True, 64)}


@pytest.mark.parametrize('case', list(BWD_CASES))
def test_three_tf32_products_match_pallas_backward(case):
    '''dQ, dK and dV by three products, S and dP in head-dim halves, meet
    the fp32 tolerance against the Pallas backward: with Sk cut by the
    16-key tiles (300), Sq by the 16- and 64-row tiles (72, 40), causal, and
    a batch row with every key masked, whose gradients are exactly 0.'''
    Sq, Sk, causal, empty_row, d = BWD_CASES[case]
    q, k, v, km, dout, out, lse, D = bwd_inputs(Sq, Sk, causal, empty_row,
                                                d=d)
    got = emulate_bwd(q, k, v, km, lse, D, dout, causal)
    want = pallas_bwd(q, k, v, km, dout, out, lse, causal)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert not np.isnan(g).any(), name
        assert outside(g, w, TOL) == 0, name
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
        if empty_row:
            assert (g[1] == 0).all() and (w[1] == 0).all(), name


@pytest.mark.parametrize('case', ['sk192', 'sk800_empty_row', 'causal'])
def test_one_tf32_product_in_the_backward(case):
    '''hi hi alone, for S, dP and the gradient products, leaves each of
    dQ, dK and dV outside the fp32 tolerance against the Pallas backward
    (read: 1.4e-4 to 2.4e-3, against 1.8e-7 to 3.3e-6 with three): this is
    why the backward kernels take three products too.'''
    Sq, Sk, causal, empty_row, d = BWD_CASES[case]
    q, k, v, km, dout, out, lse, D = bwd_inputs(Sq, Sk, causal, empty_row,
                                                d=d)
    got = emulate_bwd(q, k, v, km, lse, D, dout, causal, products=1)
    want = pallas_bwd(q, k, v, km, dout, out, lse, causal)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert outside(g, w, TOL) > 0, name


def test_halves_of_the_head_dim_sum_to_the_product():
    '''S and dP in two head-dim halves, each with its three accumulators,
    added: the product up to fp32 rounding.'''
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2, 16, 256)).astype(np.float32)
    b = rng.normal(size=(2, 16, 256)).astype(np.float32)
    want = a.astype(np.float64) @ b.swapaxes(-1, -2)
    np.testing.assert_allclose(halves_logits(a, b, 3), want, rtol=1e-6,
                               atol=2e-5)
