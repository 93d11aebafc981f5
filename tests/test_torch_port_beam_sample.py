'''Beam search and sampling of the PyTorch port (``bmt_tpu_torch.decode.beam``,
``decode.sample``) and the decode state they share (the beam fold and the
int8 cross-KV of ``ops.attention``) against the JAX package, on the same
small fp32 weights and numpy inputs, on the CPU.

Tolerances:
- tokens are equal: both sides rank log-probs that agree to ~1e-6, and the
  random fp32 weights leave no exact ties for ``lax.top_k`` and
  ``torch.topk`` to order differently;
- beam scores (sums of up to 6 log-probs) within 1e-5;
- with ``kv_int8`` the end-to-end scores within 1e-3: the two encoders'
  fp32 memories differ by ~1e-7, and where a value lies that close to an
  int8 rounding boundary its level rounds the other way in the other
  package (one level of 2688 in this setup), moving a log-prob by ~1e-4.
  The int8 step itself is held to 1e-5 from JAX's own quantized state;
- ``filter_logits`` is exactly JAX's;
- sampled tokens cannot equal JAX's (another PRNG): the tests hold the
  sampler's invariants.'''
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.decode import beam_search_bimodal as j_beam
from bmt_tpu.decode import filter_logits as j_filter
from bmt_tpu.decode.greedy import bimodal_step_setup as j_step_setup
from bmt_tpu_torch.decode import (beam_search_bimodal, filter_logits,
                                  greedy_decode_bimodal,
                                  make_bimodal_beam_fn,
                                  make_bimodal_greedy_fn,
                                  make_bimodal_sample_fn,
                                  sample_decode_bimodal)
from bmt_tpu_torch.decode.greedy import bimodal_step_setup
from bmt_tpu_torch.decode.sample import _TOP_P_SUPPORT, make_sample_select_fn
from bmt_tpu_torch.ops.attention import cross_attention_step
from tests.torch_port_util import (END, PAD, START, features,
                                   jax_and_torch_model, to_jax, to_torch)

MAX_LEN = 6
SCORE_TOL = 1e-5
SCORE_TOL_INT8 = 1e-3


@pytest.fixture(scope='module')
def setup():
    jdims, params, model = jax_and_torch_model(seed=3)
    rng = np.random.default_rng(1)
    src = features(rng, 3, 6, 8, jdims, pad_rows={1: (3, 5)})
    return jdims, params, model, src


@pytest.mark.parametrize('kv_int8', [False, True])
@pytest.mark.parametrize('alpha', [0.0, 0.6, -0.5])
@pytest.mark.parametrize('K', [1, 3])
def test_beam_search_matches_jax(setup, K, alpha, kv_int8):
    '''B=3 (one row padded), the best beam's tokens and score; K=1 gives
    the port's greedy tokens.'''
    jdims, params, model, src = setup
    toks, scores = beam_search_bimodal(model, to_torch(src), MAX_LEN, START,
                                       END, PAD, K, alpha, kv_int8=kv_int8)
    jt, js = j_beam(params, jdims, to_jax(src), MAX_LEN, START, END, PAD, K,
                    alpha, kv_int8=kv_int8)
    assert toks.shape == (3, MAX_LEN + 1) and toks.dtype == torch.long
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=0,
                               atol=SCORE_TOL_INT8 if kv_int8 else SCORE_TOL)
    if K == 1:
        greedy = greedy_decode_bimodal(model, to_torch(src), MAX_LEN, START,
                                       END, PAD, kv_int8=kv_int8)
        np.testing.assert_array_equal(toks.numpy(), greedy.numpy())


def test_beam_early_stop_and_frozen_beams(setup):
    '''With end_idx a token the beams emit, finished beams hold </s> after
    their end, the loop stops early, and the result equals JAX's.'''
    jdims, params, model, src = setup
    first = greedy_decode_bimodal(model, to_torch(src), MAX_LEN, START, END,
                                  PAD).numpy()
    end = int(first[0, 1])
    toks, scores = beam_search_bimodal(model, to_torch(src), MAX_LEN, START,
                                       end, PAD, 3, 0.6)
    jt, js = j_beam(params, jdims, to_jax(src), MAX_LEN, START, end, PAD, 3,
                    0.6)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=SCORE_TOL,
                               rtol=0)
    for row in toks.numpy():
        hits = np.flatnonzero(row[1:] == end)
        if hits.size:
            assert (row[1 + hits[0]:] == end).all()


def _torch_state(jstate):
    '''A JAX decode state (list of layer dicts, int8 dicts and tuples) as
    torch tensors, copied (the port writes caches in place).'''
    if isinstance(jstate, dict):
        return {k: _torch_state(v) for k, v in jstate.items()}
    if isinstance(jstate, (list, tuple)):
        return type(jstate)(_torch_state(v) for v in jstate)
    return torch.from_numpy(np.array(jstate))


@pytest.mark.parametrize('K', [1, 2])
def test_int8_step_from_jax_state_matches_jax(setup, K):
    '''The int8 cross-attention step with the beams folded: JAX's quantized
    decode state (caches at B x K rows, K/V at B) through two steps of the
    port's decoder gives JAX's log-probs within 1e-5.'''
    jdims, params, model, src = setup
    jst, jfn, B = j_step_setup(params, jdims, to_jax(src), PAD, MAX_LEN,
                               kv_int8=True, cache_batch_mult=K)
    assert isinstance(jst[0]['kvA'], dict)
    tst = _torch_state(jst)
    masks = bimodal_step_setup(model, to_torch(src), PAD, MAX_LEN)
    _, tfn, _ = masks
    rng = np.random.default_rng(5)
    for step in range(2):
        cur = rng.integers(4, jdims.voc_size, size=(B * K, 1)).astype(np.int32)
        jlp, jst = jfn(jst, jnp.asarray(cur), step)
        with torch.no_grad():
            tlp, tst = tfn(tst, torch.from_numpy(cur).long(), step)
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5,
                                   rtol=0)


def test_beam_fold_equals_tiled_memory(setup):
    '''A query of B x K rows over the B-row memory equals the same query
    over the memory tiled per beam; a query that does not fold raises.'''
    _, _, model, _ = setup
    mha = model.decoder.layers[0].enc_att_A
    g = torch.Generator().manual_seed(0)
    k = torch.randn(2, 2, 5, 8, generator=g)
    v = torch.randn(2, 2, 5, 8, generator=g)
    mask = torch.tensor([[[True] * 5], [[True] * 3 + [False] * 2]])
    q = torch.randn(6, 1, 16, generator=g)
    with torch.no_grad():
        folded = cross_attention_step(mha, q, (k, v), mask)
        tiled = cross_attention_step(
            mha, q, (k.repeat_interleave(3, 0), v.repeat_interleave(3, 0)),
            mask.repeat_interleave(3, 0))
        torch.testing.assert_close(folded, tiled, atol=1e-6, rtol=0)
        with pytest.raises(ValueError, match='does not fold'):
            cross_attention_step(mha, q[:5], (k, v), mask)


def test_beam_reorder_writes_fresh_caches(setup):
    '''The self-attention caches are written in place at every step: the
    reorder by parent beam must copy them, so each beam's cache holds its
    own prefix (K=3 at every row equals running each row alone).'''
    jdims, _, model, src = setup
    both = beam_search_bimodal(model, to_torch(src), MAX_LEN, START, END, PAD,
                               3, 0.0)[0]
    for row in range(3):
        one = {k: v[row:row + 1] for k, v in to_torch(src).items()}
        alone = beam_search_bimodal(model, one, MAX_LEN, START, END, PAD, 3,
                                    0.0)[0]
        np.testing.assert_array_equal(alone.numpy()[0], both.numpy()[row])


def _log_probs(rng, B, V):
    x = rng.normal(size=(B, V)).astype(np.float32) * 3
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize('case', [
    dict(top_k=3), dict(top_k=1), dict(top_k=100), dict(top_p=0.5),
    dict(top_p=1e-6), dict(top_p=0.9, top_k=5), dict(top_k=4, tie=True),
    dict(top_p=0.999, V=700), dict(top_p=0.3, V=700)])
def test_filter_logits_equals_jax(case):
    '''Top-k (incl. k above V and a tie at the k-th score, which survives),
    top-p, both, and a nucleus larger than the 512-token support (V=700,
    near-uniform rows): the same -inf mask and the same values.'''
    case = dict(case)
    V = case.pop('V', 23)
    tie = case.pop('tie', False)
    rng = np.random.default_rng(len(str(case)) + V)
    lp = _log_probs(rng, 5, V)
    if V > _TOP_P_SUPPORT:
        lp = (lp / 50.0).astype(np.float32)           # near-uniform rows
    if tie:
        order = np.argsort(-lp[0])
        lp[0, order[4]] = lp[0, order[3]]             # ties the 4th score
    got = filter_logits(torch.from_numpy(lp), **case).numpy()
    want = np.asarray(j_filter(jnp.asarray(lp), **case))
    np.testing.assert_array_equal(got, want)
    if tie:
        assert np.isfinite(got[0]).sum() == 5
    if V > _TOP_P_SUPPORT and case['top_p'] > 0.99:
        assert np.isfinite(got).sum(-1).max() == _TOP_P_SUPPORT


def test_sample_top_k_1_equals_greedy(setup):
    jdims, _, model, src = setup
    greedy = greedy_decode_bimodal(model, to_torch(src), MAX_LEN, START, END,
                                   PAD)
    for seed in (0, 1):
        toks = sample_decode_bimodal(model, to_torch(src), seed, MAX_LEN,
                                     START, END, PAD, temperature=0.7,
                                     top_k=1)
        np.testing.assert_array_equal(toks.numpy(), greedy.numpy())


def test_sample_seeds_and_calls(setup):
    '''The same seed gives the same tokens, another seed and the next call
    of a bound sampler others; tokens are valid ids after <s>.'''
    jdims, _, model, src = setup
    x = to_torch(src)
    a = sample_decode_bimodal(model, x, 7, MAX_LEN, START, END, PAD)
    b = sample_decode_bimodal(model, x, 7, MAX_LEN, START, END, PAD)
    c = sample_decode_bimodal(model, x, 8, MAX_LEN, START, END, PAD)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    fn = make_bimodal_sample_fn(jdims, MAX_LEN, START, END, PAD, seed=7)
    first, second = fn(model, x), fn(model, x)
    assert not np.array_equal(first.numpy(), second.numpy())
    again = make_bimodal_sample_fn(jdims, MAX_LEN, START, END, PAD, seed=7)
    np.testing.assert_array_equal(again(model, x).numpy(), first.numpy())
    assert (a[:, 0] == START).all()
    assert ((a >= 0) & (a < jdims.voc_size)).all()


def test_sampled_tokens_lie_in_the_filtered_support():
    '''Every draw of the selector lies where filter_logits kept the row,
    and a row's draws follow its softmax.'''
    rng = np.random.default_rng(2)
    lp = torch.from_numpy(_log_probs(rng, 64, 40))
    for kw in (dict(top_k=5), dict(top_p=0.6), dict(top_k=7, top_p=0.8)):
        select = make_sample_select_fn(3, 1.3, **kw)
        keep = torch.isfinite(filter_logits(lp / 1.3, **kw))
        for step in range(8):
            tok = select(lp, step)
            assert keep[torch.arange(64), tok].all(), kw
    row = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]])).repeat(4000, 1)
    counts = np.bincount(make_sample_select_fn(0)(row, 0).numpy(),
                         minlength=4) / 4000
    np.testing.assert_allclose(counts, [0.5, 0.3, 0.15, 0.05], atol=0.03)


@pytest.mark.parametrize('temperature', [0.0, -1.0])
def test_temperature_must_be_positive(setup, temperature):
    jdims, _, model, src = setup
    with pytest.raises(ValueError, match='temperature must be > 0'):
        make_sample_select_fn(0, temperature)
    with pytest.raises(ValueError, match='temperature must be > 0'):
        make_bimodal_sample_fn(jdims, MAX_LEN, START, END, PAD,
                               temperature=temperature)
    with pytest.raises(ValueError, match='temperature must be > 0'):
        sample_decode_bimodal(model, to_torch(src), 0, MAX_LEN, START, END,
                              PAD, temperature=temperature)


def test_bound_decoders_match_the_functions(setup):
    '''make_bimodal_{greedy,beam,sample}_fn bind the functions' arguments;
    a uni-modal dims dispatches to the uni-modal decoders.'''
    jdims, _, model, src = setup
    x = to_torch(src)
    greedy = make_bimodal_greedy_fn(jdims, MAX_LEN, START, END, PAD,
                                    kv_int8=True)(model, x)
    np.testing.assert_array_equal(
        greedy.numpy(), greedy_decode_bimodal(model, x, MAX_LEN, START, END,
                                              PAD, kv_int8=True).numpy())
    beam = make_bimodal_beam_fn(jdims, MAX_LEN, START, END, PAD, 2, 0.6)
    np.testing.assert_array_equal(
        beam(model, x).numpy(),
        beam_search_bimodal(model, x, MAX_LEN, START, END, PAD, 2,
                            0.6)[0].numpy())
    import dataclasses
    from bmt_tpu_torch.decode import (beam_search_unimodal,
                                      greedy_decode_unimodal)
    from bmt_tpu_torch.models import UniModalTransformer
    audio = dataclasses.replace(model.dims, modality='audio')
    uni = UniModalTransformer(
        audio, device='cpu',
        generator=torch.Generator().manual_seed(0)).eval()
    ax = {'audio': x['audio']}
    want = greedy_decode_unimodal(uni, ax, MAX_LEN, START, END, PAD)
    for fn in (make_bimodal_greedy_fn(audio, MAX_LEN, START, END, PAD),
               make_bimodal_sample_fn(audio, MAX_LEN, START, END, PAD,
                                      top_k=1)):
        np.testing.assert_array_equal(fn(uni, ax).numpy(), want.numpy())
    np.testing.assert_array_equal(
        make_bimodal_beam_fn(audio, MAX_LEN, START, END, PAD, 2)(
            uni, ax).numpy(),
        beam_search_unimodal(uni, ax, MAX_LEN, START, END, PAD, 2)[0]
        .numpy())
