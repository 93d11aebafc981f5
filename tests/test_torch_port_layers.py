'''Layers, masks and parameter init of the PyTorch port against the JAX
package, on the same parameters and inputs (fp32, CPU). Tolerance 1e-5
absolute unless a test says otherwise: sums of a few dozen O(1) terms taken
in another order.'''
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.ops import layers as jl
from bmt_tpu.ops import masks as jm
from bmt_tpu_torch.ops import layers as tl
from bmt_tpu_torch.ops import masks as tm
from bmt_tpu_torch.params import init_params, load_jax_params, to_jax_tree
from tests.torch_port_util import (PAD, dims_pair, features,
                                   jax_and_torch_model, to_jax, to_torch)

ATOL = 1e-5


def _load(module, params):
    load_jax_params(module, jax.tree.map(np.asarray, params))
    return module.eval()


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 16)) * 4 + 2).astype(np.float32)
    params = {'scale': rng.normal(size=16).astype(np.float32),
              'bias': rng.normal(size=16).astype(np.float32)}
    ref = jl.layer_norm(to_jax(params), jnp.asarray(x))
    ln = _load(tl.LayerNorm(16), params)
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref), atol=ATOL)


def test_layer_norm_bf16_keeps_fp32_statistics():
    '''A bf16 input is normalised in fp32 and cast back once.'''
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32) * 50 + 100)
    xb = x.to(torch.bfloat16)
    ln = tl.LayerNorm(32)
    out = ln(xb)
    assert out.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(xb.float(), (32,), eps=1e-5)
    assert torch.equal(out, ref.to(torch.bfloat16))


def test_positional_table_matches_jax_and_reference_quirk():
    ours = tl.positional_encoding_table(3660, 300)
    np.testing.assert_array_equal(ours, jl.positional_encoding_table(3660, 300))
    assert ours.shape == (3660, 300) and ours.dtype == np.float32
    # the cos term of odd column j uses j's own exponent, not j - 1's
    pos, j = 7, 5
    np.testing.assert_allclose(ours[pos, j], np.cos(pos / 10000 ** (j / 300)),
                               rtol=1e-6)
    assert tl.positional_encoding_table(3660, 300) is ours   # made once


def test_positional_encode_with_offset_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 1, 16)).astype(np.float32)
    table = jl.positional_encoding_table(3660, 16)
    ref = jl.positional_encode(jnp.asarray(table), jnp.asarray(x), offset=9)
    ours = tl.positional_encode(torch.from_numpy(table.copy()),
                                torch.from_numpy(x), offset=9)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize('table_dim', [None, 12])
def test_vocabulary_embed_matches_jax(table_dim):
    '''Lookup, the GloVe adapter when the table width differs, x sqrt(d).'''
    rng = np.random.default_rng(3)
    glove = (None if table_dim is None
             else rng.normal(size=(23, table_dim)).astype(np.float32))
    params = jl.init_vocab_embedder(jax.random.PRNGKey(0), 23, 16,
                                    pretrained=glove)
    tokens = rng.integers(0, 23, size=(2, 6))
    ref = jl.vocabulary_embed(params, jnp.asarray(tokens), 16)
    emb = _load(tl.VocabularyEmbedder(23, 16, table_dim), params)
    ours = emb(torch.from_numpy(tokens))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def test_feature_embed_matches_jax():
    rng = np.random.default_rng(4)
    params = jl.init_feature_embedder(jax.random.PRNGKey(1), 20, 16)
    x = rng.normal(size=(2, 5, 20)).astype(np.float32)
    ref = jl.feature_embed(params, jnp.asarray(x), 16)
    ours = _load(tl.FeatureEmbedder(20, 16), params)(torch.from_numpy(x))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=ATOL)


def test_ffn_bridge_and_residual_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    ffn_p = jl.init_ffn(jax.random.PRNGKey(2), 16, 24)
    bridge_p = jl.init_bridge(jax.random.PRNGKey(3), 16, 8)
    ln_p = {'scale': rng.normal(size=16).astype(np.float32),
            'bias': rng.normal(size=16).astype(np.float32)}
    ffn = _load(tl.FeedForward(16, 24, dout_p=0.1), ffn_p)
    bridge = _load(tl.Bridge(16, 8, dout_p=0.1), bridge_p)
    ln = _load(tl.LayerNorm(16), ln_p)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        checks = [
            (ffn(tx), jl.feed_forward(ffn_p, jnp.asarray(x))),
            (bridge(tx), jl.bridge(bridge_p, jnp.asarray(x))),
            (tl.residual(ln, tx, ffn, torch.nn.Identity()),
             jl.residual(to_jax(ln_p), jnp.asarray(x),
                         lambda y: jl.feed_forward(ffn_p, y))),
        ]
    for ours, ref in checks:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)


# kept values against jl.dropout's: fp32, the same x / (1 - p) up to the
# rounding of the scale (1e-6 relative). bf16: both scales round to bf16
# (ours 1/(1-p), the JAX package's 1-p), 0.33% apart at p = 0.1, and each
# output rounds to bf16 (up to 2^-8 relative): within 2e-2
DROPOUT_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_dropout_matches_jax_inverted_scaling(dtype):
    '''In training each element is 0 or x / (1 - p) as ``jl.dropout`` makes
    it; the dropped share is p within 5 sigma; the same generator seed gives
    the same mask; the gradient is the mask; eval and p = 0 are the
    identity.'''
    p = 0.1
    x = np.random.default_rng(8).normal(size=(64, 256)).astype(np.float32) + 3
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jl.dropout(jnp.asarray(x, jdtype), p,
                                jax.random.PRNGKey(0), False), np.float32)
    drop = tl.Dropout(p).train()
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    with tl.dropout_generator(torch.Generator().manual_seed(0)):
        out = drop(tx)
    with tl.dropout_generator(torch.Generator().manual_seed(0)):
        again = drop(tx)
    assert out.dtype == dtype and torch.equal(out, again)
    kept = out.detach().float().numpy() != 0
    assert abs((~kept).mean() - p) < 5 * np.sqrt(p * (1 - p) / x.size)
    both = kept & (ref != 0)
    np.testing.assert_allclose(out.detach().float().numpy()[both], ref[both],
                               rtol=DROPOUT_RTOL[dtype])
    out.sum().backward()
    scale = torch.tensor(1 / (1 - p), dtype=dtype)
    assert torch.equal(tx.grad, torch.where(torch.from_numpy(kept), scale, 0))
    assert drop.eval()(tx) is tx and tl.Dropout(0.0).train()(tx) is tx


def test_masks_match_jax_including_channel0_quirk():
    rng = np.random.default_rng(6)
    jdims, _ = dims_pair()
    src = features(rng, 3, 6, 8, jdims, pad_rows={1: (4, 5), 2: (2, 8)})
    src['audio'][0, 3, 0] = PAD        # channel 0 == pad index -> masked
    caps = rng.integers(4, 23, size=(3, 7))
    caps[1, 5:] = PAD
    ref = jm.make_masks(to_jax(src), jnp.asarray(caps), 'audio_video', PAD)
    ours = tm.make_masks(to_torch(src), torch.from_numpy(caps), 'audio_video',
                         PAD)
    assert set(ours) == set(ref) == {'A_mask', 'V_mask', 'C_mask'}
    for key in ref:
        assert ours[key].dtype == torch.bool
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    assert not ours['A_mask'][0, 0, 3]
    ref = jm.make_masks(to_jax(src), None, 'audio_video', PAD)
    ours = tm.make_masks(to_torch(src), None, 'audio_video', PAD)
    assert set(ours) == {'A_mask', 'V_mask'}
    for key in ref:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    np.testing.assert_array_equal(tm.subsequent_mask(5).numpy(),
                                  np.asarray(jm.subsequent_mask(5)))
    for modality in ('video', 'audio'):
        ref = jm.make_masks(to_jax(src), None, modality, PAD)
        ours = tm.make_masks(to_torch(src), None, modality, PAD)
        assert set(ours) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(ours[key].numpy(),
                                          np.asarray(ref[key]))
    with pytest.raises(ValueError):
        tm.make_masks(to_torch(src), None, 'subs', PAD)


def test_model_tree_matches_jax_tree_and_round_trips():
    '''The torch model's parameter tree has the JAX tree's keys and shapes,
    and load -> to_jax_tree gives the JAX arrays back bit for bit.'''
    _, params, model = jax_and_torch_model()
    host = jax.tree.map(np.asarray, params)
    back = to_jax_tree(model)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, b)


def test_load_jax_params_rejects_wrong_trees():
    _, params, model = jax_and_torch_model()
    host = jax.tree.map(np.asarray, params)
    missing = dict(host)
    del missing['generator']
    with pytest.raises(KeyError):
        load_jax_params(model, missing)
    bad = jax.tree.map(lambda x: x, host)
    bad['generator'] = {'w': np.zeros((3, 3), np.float32),
                        'b': host['generator']['b']}
    with pytest.raises(ValueError):
        load_jax_params(model, bad)


def test_seeded_init_follows_the_jax_recipe():
    '''Same bounds as layers.py's init: xavier-uniform weights, fan-in
    biases, ones/zeros LayerNorms; the same seed gives the same model.'''
    from bmt_tpu_torch.models import BiModalTransformer
    _, tdims = dims_pair()
    a = BiModalTransformer(tdims, device='cpu',
                           generator=torch.Generator().manual_seed(3))
    b = BiModalTransformer(tdims, device='cpu',
                           generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    fc1 = a.encoder.layers[0].ff_M2.fc1
    bound = np.sqrt(6.0 / (fc1.in_features + fc1.out_features))
    assert fc1.weight.abs().max() <= bound
    assert fc1.weight.abs().max() > 0.9 * bound
    assert fc1.bias.abs().max() <= 1 / np.sqrt(fc1.in_features)
    ln = a.decoder.layers[1].res_ff
    assert torch.equal(ln.scale, torch.ones_like(ln.scale))
    assert torch.equal(ln.bias, torch.zeros_like(ln.bias))
    init_params(a, torch.Generator().manual_seed(4))
    assert not torch.equal(a.generator.weight, b.generator.weight)
