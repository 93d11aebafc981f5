'''The numerical plan of the fp32 attention kernels on tensor cores
(csrc/flash_attn_fwd.cu, csrc/flash_attn_bwd.cu, csrc/sm90.cuh), held to
the JAX package on the CPU.

The kernels run every fp32 product as three TF32 wgmma products: each
8-deep k-step adds lo(A) hi(B), hi(A) lo(B), then hi(A) hi(B) to fp32
accumulators. An operand in registers (A) is split hi = rna_tf32(x), lo =
rna_tf32(x - hi); one in shared memory (B) keeps its raw fp32 word, which
the tensor core reads truncated to TF32, beside lo = rna_tf32(x -
trunc(x)). The forward's Q, loaded once for the whole key loop, is split
once in shared memory as a register operand is (hi = rna(x) in place, lo
beside it), so the tensor core reads it exactly. At a head dim padded to
256 a cluster of two blocks takes S (and in the backward dP) over one
128-column half each, its small products in an accumulator of their own
added last, and adds the other's (x + y, the same bits in both); at 64 one
block takes all.

The forward (64 query rows a block, 32-key tiles in order) takes S = Q K^T
so, then the online softmax in base-2 units (corrections 0 and p 0 while a
row's max is -inf), and O^T += V^T P^T: V the register operand, P (not
rounded) written to shared memory as the B operand. A tile's product goes
into a zeroed accumulator, folded into O by one fma with the tile's
corrections, acc corr + tile. With a key split, blocks write per-chunk (m,
l, O) partials that a second kernel combines.

The backward kernels (dQ over 32-key tiles, dK/dV over 32-query tiles)
rebuild P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP - D) scale
where the logit is valid (0 elsewhere), and sum each tile's dQ^T = K^T
dS^T, dV^T = dO^T P and dK^T = Q^T dS into a zeroed accumulator, which one
fp32 add joins to the gradient.

The tensor core adds each product to its accumulator truncated, not
rounded, which the emulations below do not model (they round);
``test_tile_sums_keep_the_truncation_drift_down`` models it to show why the
kernels sum each tile from zero, and tests/test_torch_port_cuda.py holds the
kernels at S = 2048, causal, on the card.

This file emulates that arithmetic in numpy (a test helper, not part of the
package): the tensor core's products of TF32 values are exact, and each
k-step's sum is added to the fp32 accumulator with one rounding. The
emulation is then held to the tiled Pallas forward and backward of
``bmt_tpu.ops.pallas_attention`` in interpret mode, as
tests/test_pallas_attention.py runs them.

Tolerances are those the kernels are held to on the card (chip_smoke.py
``TOL[float32]``, ``LSE_TOL``, ``BWD_TOL[float32]``;
tests/test_torch_port_cuda.py): out and the gradients within
1e-4 + 1e-5 |ref|, lse within 1e-5 + 1e-5 |ref|. One product alone misses
them, which is why the kernels take three.
'''
import numpy as np
import pytest

import jax.numpy as jnp

from bmt_tpu.ops.pallas_attention import (_flash_attention_tiled,
                                          _flash_attention_tiled_bwd)

TOL = (1e-4, 1e-5)
LSE_TOL = (1e-5, 1e-5)
BK = 32                      # the forward kernel's key tile
BN = 32                      # the backward kernels' loop tile
LN2 = np.float32(0.693147180559945309)
LOG2E = np.float32(1.44269504088896341)


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


def pad_dim(x):
    """x with its head dim zero-padded to the kernels' DP (64 or 256)."""
    d = x.shape[-1]
    dp = 64 if d <= 64 else 256
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, dp - d)])


def trunc_tf32(x):
    """An fp32 word as the tensor core reads it in TF32: its low 13 bits
    dropped."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_shared(x):
    """(hi, lo) of a shared-memory operand as the products read it: the raw
    word truncated, and x - trunc(x) (exact in fp32) rounded to TF32."""
    hi = trunc_tf32(x)
    return hi, rna_tf32(x - hi)


def wg_mma(acc, a, b, products, a_right=False, small=None,
           lo_b_first=False):
    """acc + a b over k-steps of 8 (a (..., M, K), b (..., K, N)), as wgmma
    adds them: lo(A) hi(B), hi(A) lo(B), hi(A) hi(B) a step with 3
    products (hi(A) lo(B) first with ``lo_b_first``, as the forward's S),
    hi hi alone with 1. A, the product's register operand (split()), is a,
    or b with ``a_right``; the other is in shared memory (split_shared()).
    The two small products go into ``small`` when it is given (an
    accumulator of their own, returned beside acc), else into acc."""
    ahi, alo = split_shared(a) if a_right else split(a)
    bhi, blo = split(b) if a_right else split_shared(b)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if products == 3:
            first = ((ahi[..., ks], blo[..., ks, :]) if a_right
                     else (alo[..., ks], bhi[..., ks, :]))
            second = ((alo[..., ks], bhi[..., ks, :]) if a_right
                      else (ahi[..., ks], blo[..., ks, :]))
            if lo_b_first:
                first, second = second, first
            if small is None:
                acc = mma(acc, *first)
                acc = mma(acc, *second)
            else:
                small = mma(mma(small, *first), *second)
        acc = mma(acc, ahi[..., ks], bhi[..., ks, :])
    return acc if small is None else (acc, small)


def halves_logits(a, b, products, lo_b_first=False):
    """a b^T (a (BH, M, DP), b (BH, N, DP); A = a) as the kernels take S
    (and the backward dP): at DP = 256 each 128-column half (one block of
    the cluster) summed alone from zero, its small products in an
    accumulator of their own (the forward's with hi(A) lo(B) first) added
    last, then the halves added; at DP = 64 the whole width in one."""
    h = min(a.shape[-1], 128)
    zero = np.zeros(a.shape[:-1] + b.shape[1:2], np.float32)
    out = None
    for c in range(0, a.shape[-1], h):
        main, small = wg_mma(zero, a[..., c:c + h],
                             b[..., c:c + h].swapaxes(-1, -2), products,
                             small=zero, lo_b_first=lo_b_first)
        part = small + main
        out = part if out is None else out + part
    return out


def tile(x, r0):
    """Rows [r0, r0 + BN) of x (BH, S, ...), zero past S."""
    out = np.zeros((x.shape[0], BN) + x.shape[2:], x.dtype)
    n = max(0, min(BN, x.shape[1] - r0))
    out[:, :n] = x[:, r0:r0 + n]
    return out


def block_partial(qf, kf, vf, valid, tiles, scale, causal, products):
    """(m in base-2 units, l, unnormalised O) of the query rows of qf (BH,
    Sq, DP; padded head dim) over the key tiles ``tiles`` in order, as the
    forward's blocks compute them: S in the cluster's halves, the online
    softmax, each tile's P V summed from zero (P the shared-memory operand,
    V the register one) and folded in by acc corr + tile in one rounding.
    A tile that holds no valid key for a row leaves its (m, l, O) as they
    were, so the blocks' causal cut by query block need not be
    emulated."""
    BH, Sq, DP = qf.shape
    scale2 = np.float32(scale) * LOG2E
    o = np.zeros((BH, Sq, DP), np.float32)
    m = np.full((BH, Sq), -np.inf, np.float32)
    l = np.zeros((BH, Sq), np.float32)
    rows = np.arange(Sq)[:, None]
    for t in tiles:
        k0 = t * BK
        ok = tile(valid, k0)[:, None, :]
        if causal:
            ok = ok & (k0 + np.arange(BK)[None, :] <= rows)
        s = halves_logits(qf, tile(kf, k0), products, lo_b_first=True)
        x = np.where(ok, s * scale2, np.float32(-np.inf))
        m_new = np.maximum(m, x.max(-1))
        empty = m_new == -np.inf
        with np.errstate(invalid='ignore'):
            corr = np.where(empty, 0, np.exp2(m - m_new)).astype(np.float32)
            p = np.where(empty[..., None], 0,
                         np.exp2(x - m_new[..., None])).astype(np.float32)
        m = m_new
        l = corr * l + p.sum(-1, dtype=np.float32)
        part = wg_mma(np.zeros_like(o), p, tile(vf, k0), products,
                      a_right=True)
        o = (o.astype(np.float64) * corr[..., None] + part).astype(np.float32)
    return m, l, o


def merge(parts):
    """(m, l, O) of partials over disjoint keys, each weighed by
    exp2(m_s - max m) (0 where m_s is -inf) and summed in order: how
    flash_attn_fwd_combine_kernel joins the splits."""
    m = np.max([p[0] for p in parts], axis=0)
    l = np.zeros_like(m)
    o = np.zeros_like(parts[0][2])
    with np.errstate(invalid='ignore'):
        for ms, ls, os_ in parts:
            w = np.where(ms == -np.inf, 0, np.exp2(ms - m)).astype(np.float32)
            l = l + w * ls
            o = o + w[..., None] * os_
    return m, l, o


def finish(m, l, o):
    """(out, lse) from (m, l, O), as the kernel writes them."""
    with np.errstate(divide='ignore', invalid='ignore'):
        return o * (np.float32(1) / l)[..., None], m * LN2 + np.log(l)


def inputs(Sk, seed=0, B=2, H=2, Sq=64, d=256, empty_row=False):
    """q, k, v (B, H, S, d) fp32 and the (B, Sk) int32 key mask: batch row 1
    keeps 65% of its keys (or none, with ``empty_row``)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, d)).astype(np.float32)
               for S in (Sq, Sk, Sk))
    km = np.ones((B, Sk), np.int32)
    km[1, 0 if empty_row else int(0.65 * Sk):] = 0
    return q, k, v, km


def emulate(q, k, v, km, causal=False, products=3, splits=1):
    """The kernel's (out, lse) for (B, H, Sq, d) inputs, key tiles split
    into ``splits`` chunks of ceil(tiles / splits) (one: no split)."""
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    valid = np.repeat(km[:, None, :] != 0, H, axis=1).reshape(B * H, Sk)
    flat = [pad_dim(x).reshape(B * H, x.shape[2], -1) for x in (q, k, v)]
    scale = 1 / np.sqrt(np.float32(d))
    tiles = -(-Sk // BK)
    chunk = -(-tiles // splits)
    if causal:                       # no tile wholly above the diagonal
        tiles = min(tiles, (Sq - 1) // BK + 1)
    parts = [block_partial(*flat, valid,
                           range(s * chunk, min(tiles, (s + 1) * chunk)),
                           scale, causal, products) for s in range(splits)]
    out, lse = finish(*merge(parts))
    return out[..., :d].reshape(q.shape), lse.reshape(B, H, Sq)


def pallas(q, k, v, km, causal=False):
    out, lse = _flash_attention_tiled(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
        causal, interpret=True, block_k=128, with_lse=True)
    return np.asarray(out), np.asarray(lse)[..., 0]


def outside(got, want, tol):
    """How many elements lie outside atol + rtol |want|."""
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


FWD_CASES = {                 # (Sq, Sk, causal, empty_row, d)
    'sk192': (64, 192, False, False, 256),
    'sk512': (64, 512, False, False, 256),
    'sk800': (64, 800, False, False, 256),
    'causal_sq72': (72, 72, True, False, 256),
    'd64_sk300_empty_row': (40, 300, False, True, 64),
    'd40_causal_sq21': (21, 21, True, False, 40)}


@pytest.mark.parametrize('case', list(FWD_CASES))
def test_three_tf32_products_match_pallas_fp32(case):
    """Three products, S in the cluster's head-dim halves (one block at a
    head dim padded to 64) and O^T = V^T P^T summed a tile at a time, meet
    the fp32 tolerances against the Pallas forward and lse: with Sk cut by
    the 32-key tiles (300), Sq by the 64-row blocks (72, 40, 21), causal,
    and a batch row with every key masked (NaN, lse -inf in both)."""
    Sq, Sk, causal, empty_row, d = FWD_CASES[case]
    q, k, v, km = inputs(Sk, Sq=Sq, d=d, empty_row=empty_row)
    out, lse = emulate(q, k, v, km, causal)
    jout, jlse = pallas(q, k, v, km, causal)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(jout))
    np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(jlse))
    assert np.isnan(out[1]).all() == empty_row
    fin = ~np.isnan(jout)
    assert outside(out[fin], jout[fin], TOL) == 0
    fin = ~np.isneginf(jlse)
    assert outside(lse[fin], jlse[fin], LSE_TOL) == 0
    np.testing.assert_allclose(out[~np.isnan(out)], jout[~np.isnan(jout)],
                               atol=2e-6)


@pytest.mark.parametrize('Sk', [192, 512, 800])
def test_one_tf32_product_misses_the_fp32_tolerance(Sk):
    """hi hi alone, in S and in O^T, leaves out and lse outside the fp32
    tolerances: this is why the kernel takes three products."""
    q, k, v, km = inputs(Sk)
    out, lse = emulate(q, k, v, km, products=1)
    jout, jlse = pallas(q, k, v, km)
    assert outside(out, jout, TOL) > 0
    assert outside(lse, jlse, LSE_TOL) > 0


def test_q_split_once_in_shared_memory_is_read_exactly():
    """Q's split in shared memory, hi = rna(x) in place and lo = rna(x - hi)
    beside it, holds TF32 values, so the tensor core, which reads a
    shared-memory word truncated, reads them exactly: the products equal
    those of Q split in registers (A), bit for bit: at most 2^-23 |x| left
    out, where the raw word read truncated with its lo beside it (B's way)
    leaves up to 2^-22 |x|."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 64, 128)).astype(np.float32)
    hi, lo = split(x)
    np.testing.assert_array_equal(trunc_tf32(hi), hi)
    np.testing.assert_array_equal(trunc_tf32(lo), lo)
    k = rng.normal(size=(4, 32, 128)).astype(np.float32)
    zero = np.zeros((4, 64, 32), np.float32)
    from_registers = wg_mma(zero, x, k.swapaxes(-1, -2), 3)
    in_shared = zero
    khi, klo = split_shared(k.swapaxes(-1, -2))
    for k0 in range(0, 128, 8):
        ks = slice(k0, k0 + 8)
        in_shared = mma(in_shared, trunc_tf32(lo[..., ks]), khi[..., ks, :])
        in_shared = mma(in_shared, trunc_tf32(hi[..., ks]), klo[..., ks, :])
        in_shared = mma(in_shared, trunc_tf32(hi[..., ks]), khi[..., ks, :])
    np.testing.assert_array_equal(in_shared, from_registers)
    rest_rna = np.abs(x.astype(np.float64) - hi - lo)
    raw_hi, raw_lo = split_shared(x)
    rest_raw = np.abs(x.astype(np.float64) - raw_hi - raw_lo)
    assert (rest_rna <= 2.0 ** -23 * np.abs(x)).all()
    assert (rest_raw > 2.0 ** -23 * np.abs(x)).any()


def trunc_add(acc, x):
    """acc + x (float64) rounded to fp32 toward zero: how the tensor core
    adds a k-step's products to its accumulator."""
    exact = acc.astype(np.float64) + x
    r = exact.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(exact)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def test_tile_sums_keep_the_truncation_drift_down():
    """O over 2048 keys (64 tiles of 32, 4 k-steps each) with each k-step
    added truncated, as the tensor core adds: straight into O the
    truncations drift one way, 2048 / 8 of them a row; summed from zero a
    tile at a time and folded in by one rounded add (the kernels' way),
    only 4 a tile are truncated, at the tile's smaller magnitude. The
    folded sums' error is a fraction of the straight ones'."""
    rng = np.random.default_rng(4)
    p = rng.random((64, 2048)).astype(np.float32)
    v = rng.normal(size=(2048, 64)).astype(np.float32)
    exact = p.astype(np.float64) @ v
    straight = np.zeros((64, 64), np.float32)
    folded = np.zeros((64, 64), np.float32)
    for t in range(0, 2048, BK):
        part = np.zeros((64, 64), np.float32)
        for k in range(t, t + BK, 8):
            step = p[:, k:k + 8].astype(np.float64) @ v[k:k + 8]
            straight = trunc_add(straight, step)
            part = trunc_add(part, step)
        folded = (folded.astype(np.float64) + part).astype(np.float32)
    err_straight = np.abs(straight - exact).max()
    err_folded = np.abs(folded - exact).max()
    assert err_folded < err_straight / 5


@pytest.mark.parametrize('Sk,splits,causal,empty_row', [
    (800, 2, False, False), (300, 5, False, False), (800, 5, False, True),
    (192, 3, True, False)])
def test_split_partials_combine_to_the_unsplit_result(Sk, splits, causal,
                                                      empty_row):
    """Per-chunk (m, l, O) partials combined as the combine kernel does give
    the unsplit result up to rounding, and the Pallas one within the fp32
    tolerances. An empty batch row is NaN with lse -inf either way; under
    causal the last split has no key tile left and writes an empty
    partial."""
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

def grad_product(acc, a, b, products):
    """acc + a b over one BN-wide tile (a (BH, M, BN), b (BH, BN, n)) as
    the kernels add dQ^T = K^T dS^T, dV^T = dO^T P and dK^T = Q^T dS, b's
    side the register operand: into a zeroed accumulator, then one fp32
    add."""
    return acc + wg_mma(np.zeros_like(acc), a, b, products, a_right=True)


def probs(s, dp, ok, lse, D, scale):
    """(P, dS) from the logits and dP, masked where the logit is not
    valid (never exp then mask): lse and D broadcast against s."""
    with np.errstate(invalid='ignore', over='ignore'):
        p = np.where(ok, np.exp2(s * (scale * LOG2E) - lse * LOG2E),
                     0).astype(np.float32)
        ds = np.where(ok, p * (dp - D) * scale, 0).astype(np.float32)
    return p, ds


def emulate_bwd(q, k, v, km, lse, D, dout, causal=False, products=3):
    """The kernels' (dQ, dK, dV) for (B, H, S, d) inputs, the forward's lse
    and D (B, H, Sq). Rows are independent, so each kernel's blocks are
    emulated all at once: dQ over key tiles of BN in order, dK/dV over
    query tiles of BN in order. A tile a block skips (causal) holds no
    valid logit and adds exact zeros here."""
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
    """q, k, v, key mask (inputs()), dO, and the Pallas forward's out and
    lse and D = rowsum(dO out) (NaN -> 0) for them."""
    q, k, v, km = inputs(Sk, seed, Sq=Sq, d=d, empty_row=empty_row)
    dout = np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32)
    out, lse = pallas(q, k, v, km, causal)
    D = (dout * out).sum(-1, dtype=np.float32)
    return q, k, v, km, dout, out, lse, np.where(np.isnan(D), 0,
                                                 D).astype(np.float32)


def pallas_bwd(q, k, v, km, dout, out, lse, causal=False):
    """(dq, dk, dv) of the tiled Pallas backward in interpret mode."""
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
    """dQ, dK and dV by three TF32 products, S and dP in the
    cluster's head-dim halves, meet the fp32 tolerance against the Pallas
    backward: with Sk cut by the 32-key tiles (300), Sq by the 32- and
    64-row tiles (72, 40), causal, and a batch row with every key masked,
    whose gradients are exactly 0."""
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
    """hi hi alone, for S, dP and the gradient products,
    leaves each of dQ, dK and dV outside the fp32 tolerance against the
    Pallas backward: this is why the backward kernels take three
    products."""
    Sq, Sk, causal, empty_row, d = BWD_CASES[case]
    q, k, v, km, dout, out, lse, D = bwd_inputs(Sq, Sk, causal, empty_row,
                                                d=d)
    got = emulate_bwd(q, k, v, km, lse, D, dout, causal, products=1)
    want = pallas_bwd(q, k, v, km, dout, out, lse, causal)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        assert outside(g, w, TOL) > 0, name


def test_halves_of_the_head_dim_sum_to_the_product():
    """S and dP over the cluster's two 128-column halves, each summed alone
    by three products, added: the product up to fp32 rounding."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(2, 64, 256)).astype(np.float32)
    b = rng.normal(size=(2, 32, 256)).astype(np.float32)
    want = a.astype(np.float64) @ b.swapaxes(-1, -2)
    np.testing.assert_allclose(halves_logits(a, b, 3), want, rtol=1e-6,
                               atol=2e-5)


def test_split_keeps_fp32_accuracy():
    """A register operand's hi = rna(x), lo = rna(x - hi) leave at most
    2^-22 |x| out; a shared-memory operand's raw word, read truncated, with
    lo = rna(x - trunc(x)) at most 2^-21 |x|; the three products of a
    k-step sum to the exact product within fp32 rounding of its terms, in
    either operand order; hi hi alone reads the TF32 rounding."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=4096).astype(np.float32)
    for part, bound in ((split, 2.0 ** -22), (split_shared, 2.0 ** -21)):
        hi, lo = part(x)
        assert (hi.view(np.uint32) & 0x1FFF == 0).all()
        assert (lo.view(np.uint32) & 0x1FFF == 0).all()
        rest = np.abs(x.astype(np.float64) - hi - lo)
        assert (rest <= bound * np.abs(x)).all()
    a = rng.normal(size=(3, 64, 32)).astype(np.float32)
    b = rng.normal(size=(3, 32, 48)).astype(np.float32)
    want = a.astype(np.float64) @ b
    zero = np.zeros((3, 64, 48), np.float32)
    for right in (False, True):
        np.testing.assert_allclose(wg_mma(zero, a, b, 3, right), want,
                                   rtol=1e-6, atol=2e-5)
    assert np.abs(wg_mma(zero, a, b, 1) - want).max() > 1e-3
