'''The port's Switch MoE feed-forward (``bmt_tpu_torch.ops.moe``) and the MoE
captioner against the JAX package (fp32, CPU, small widths, inputs made with
numpy from a seed).

Tolerances, fp32 with dropout 0: outputs, losses and gradients 1e-5; the
train step at ``test_torch_port_train.py``'s (loss and grad_norm 2e-5
relative, parameters 2e-6 absolute after two Adam steps).
'''
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.decode import greedy_decode_bimodal as j_greedy
from bmt_tpu.models import bimodal_transformer_forward
from bmt_tpu.ops import moe as jmoe
from bmt_tpu.ops.layers import feed_forward
from bmt_tpu.ops.quant import count_quantized as j_count_quantized
from bmt_tpu.ops.quant import quantize_tree_int8 as j_quantize_tree_int8
from bmt_tpu.train import checkpoint as jckpt
from bmt_tpu.train import optim as joptim
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch.decode.greedy import (greedy_decode_bimodal,
                                         greedy_decode_uncached)
from bmt_tpu_torch.models import BiModalTransformer
from bmt_tpu_torch.ops.layers import FeedForward
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.ops.moe import MoEFeedForward, ffn_or_moe
from bmt_tpu_torch.ops.quant import count_quantized, quantize_tree_int8
from bmt_tpu_torch.params import (load_jax_params, named_jax_parameters,
                                  to_jax_tree)
from bmt_tpu_torch.train import checkpoint as tckpt
from bmt_tpu_torch.train import optim as toptim
from bmt_tpu_torch.train import steps as tsteps
from tests.test_torch_port_train import SMOOTHING, STEP_CFG, _batch
from tests.torch_port_util import (END, PAD, START, assert_tree_close,
                                   dims_pair, features, jax_and_torch_model)

D, F_, S = 8, 16, 12


def _moe_pair(E, seed=0, router=None):
    '''JAX ``init_moe_ffn`` params and the port's MoEFeedForward holding
    them; ``router`` replaces the router's weight.'''
    p = jax.tree.map(np.asarray, jmoe.init_moe_ffn(jax.random.PRNGKey(seed),
                                                   D, F_, E))
    if router is not None:
        p['router']['w'] = router
    m = MoEFeedForward(D, F_, E, device='cpu')
    load_jax_params(m, p)
    return p, m


def _x(seed, B=2):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


MOE_CASES = {'lossless': (True, 1.25), 'capacity': (False, 1.25),
             'overflow': (False, 0.2)}


@pytest.mark.parametrize('E', [1, 4])
@pytest.mark.parametrize('case', list(MOE_CASES))
def test_moe_feed_forward_matches_jax(E, case):
    '''The lossless and the capacity forward, and a capacity of
    ceil(12 / E x 0.2) slots that drops tokens: the output and the
    load-balance loss equal ``moe_feed_forward``'s.'''
    deterministic, cf = MOE_CASES[case]
    p, m = _moe_pair(E)
    m.capacity_factor = cf
    x = _x(1)
    jaux, taux = [], []
    want = jmoe.moe_feed_forward(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), deterministic=deterministic,
                                 aux_out=jaux, capacity_factor=cf)
    got = m(torch.from_numpy(x), taux, deterministic)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(taux[0].item(), float(jaux[0]), atol=1e-5)
    if case == 'overflow':
        dropped = (got.abs().sum(-1) == 0).sum().item()
        assert dropped >= 2 * (S - E * -(-S * cf // E))     # past capacity


@pytest.mark.parametrize('router', ['uniform', 'collapsed'])
def test_moe_aux_matches_jax(router):
    '''A uniform router scores 1.0, one that sends every token to one
    expert about E; both as the JAX loss.'''
    w = np.zeros((D, 4), np.float32)
    if router == 'collapsed':
        w[:, 2] = 100.0
    p, m = _moe_pair(4, router=w)
    x = np.ones((2, S, D), np.float32) if router == 'collapsed' else _x(2)
    jaux, taux = [], []
    jmoe.moe_feed_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          aux_out=jaux)
    m(torch.from_numpy(x), taux)
    np.testing.assert_allclose(taux[0].item(), float(jaux[0]), atol=1e-6)
    assert (taux[0].item() > 3.5) if router == 'collapsed' else \
        abs(taux[0].item() - 1.0) < 1e-6


@pytest.mark.parametrize('deterministic', [True, False])
def test_moe_gradients_match_jax(deterministic):
    '''The gradient of sum(y r) + aux with respect to the router and the
    experts equals ``jax.grad``'s, in both forwards.'''
    p, m = _moe_pair(4, seed=3)
    x = _x(4)
    r = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(params):
        aux = []
        y = jmoe.moe_feed_forward(params, jnp.asarray(x),
                                  deterministic=deterministic, aux_out=aux)
        return jnp.sum(y * r) + aux[0]
    want = jax.grad(jloss)(jax.tree.map(jnp.asarray, p))
    aux = []
    y = m(torch.from_numpy(x), aux, deterministic)
    ((y * torch.from_numpy(r)).sum() + aux[0]).backward()
    assert np.abs(np.asarray(want['router']['w'])).max() > 0
    for path, t in named_jax_parameters(m):
        ref = want
        for k in path:
            ref = ref[k]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref),
                                   atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize('deterministic', [True, False])
def test_moe_with_one_expert_equals_the_dense_ffn(deterministic):
    '''E=1: the router's probability is 1 and every token fits, so both
    forwards equal the dense FFN on expert 0's weights, as the JAX
    package pins its own.'''
    p, m = _moe_pair(1, seed=6)
    dense = FeedForward(D, F_, device='cpu')
    load_jax_params(dense, {'fc1': {'w': p['experts']['w1'][0],
                                    'b': p['experts']['b1'][0]},
                            'fc2': {'w': p['experts']['w2'][0],
                                    'b': p['experts']['b2'][0]}})
    x = torch.from_numpy(_x(7))
    got = m(x, None, deterministic)
    np.testing.assert_allclose(got.detach().numpy(),
                               dense(x).detach().numpy(), atol=1e-6)
    want = feed_forward({'fc1': {'w': p['experts']['w1'][0],
                                 'b': p['experts']['b1'][0]},
                         'fc2': {'w': p['experts']['w2'][0],
                                 'b': p['experts']['b2'][0]}},
                        jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)


def test_seeded_moe_init_follows_the_dense_rule():
    '''A seeded MoE FFN draws its router and each expert as the dense FFN
    draws its layers: every leaf within the bound JAX's init uses.'''
    from bmt_tpu_torch.params import init_params
    m = ffn_or_moe(D, F_, 4, device='cpu')
    assert isinstance(m, MoEFeedForward)
    assert isinstance(ffn_or_moe(D, F_, 1, device='cpu'), FeedForward)
    init_params(m, torch.Generator().manual_seed(0))
    bounds = {'w': (6 / (D + 4)) ** 0.5, 'w1': (6 / (D + F_)) ** 0.5,
              'w2': (6 / (F_ + D)) ** 0.5, 'b1': D ** -0.5, 'b2': F_ ** -0.5}
    for path, t in named_jax_parameters(m):
        assert 0 < t.abs().max().item() <= bounds[path[-1]], path
    assert not torch.equal(m.experts.w1[0], m.experts.w1[1])


# ---------------------------------------------------------------------------
# the MoE captioner
# ---------------------------------------------------------------------------

def _moe_model(seed=0, **kw):
    return jax_and_torch_model(seed=seed, moe_experts=4, dout_p=0.0, **kw)


@pytest.mark.parametrize('deterministic', [True, False])
def test_moe_captioner_forward_and_aux_match_jax(deterministic):
    '''The teacher-forced forward of a MoE captioner (E=4 at every FFN
    site), eval (lossless) and train (capacity) mode: log-probs and the aux
    list (one entry per encoder layer, then one per decoder layer).'''
    jdims, params, model = _moe_model(seed=1)
    batch = _batch(40, dims=jdims, row_valid=False)
    src = {k: torch.from_numpy(v) for k, v in batch['src'].items()}
    trg = torch.from_numpy(batch['caption'][:, :-1]).long()
    masks = make_masks(src, trg, 'audio_video', PAD)
    jmasks = {k: jnp.asarray(v.numpy()) for k, v in masks.items()}
    jaux, taux = [], []
    want = bimodal_transformer_forward(
        params, jdims, jax.tree.map(jnp.asarray, batch['src']),
        jnp.asarray(trg.numpy()), jmasks, rng=jax.random.PRNGKey(0),
        deterministic=deterministic, aux_out=jaux)
    model.train(not deterministic)
    got = model(src, trg, masks, aux_out=taux)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    assert len(taux) == len(jaux) == 2 * jdims.N
    np.testing.assert_allclose([a.item() for a in taux],
                               [float(a) for a in jaux], atol=1e-5)


@pytest.mark.parametrize('accum_steps', [1, 2])
def test_moe_train_step_matches_jax(accum_steps):
    '''Two Adam steps of the MoE captioner with the Switch loss weighted by
    0.05 (dropout off, clip, weight decay; accum_steps 2 splits the batch):
    loss, grad_norm and the parameters after both steps.'''
    jdims, params, model = _moe_model(seed=3)
    jopt = joptim.build_optimizer(STEP_CFG)
    jstep = jax.jit(jsteps.make_cap_train_step(
        jdims, jopt, SMOOTHING, PAD, accum_steps=accum_steps,
        moe_aux_coeff=0.05))
    jstate = jsteps.init_train_state(params, jopt)
    opt = toptim.build_optimizer(STEP_CFG, model)
    step = tsteps.make_cap_train_step(model.dims, SMOOTHING, PAD,
                                      accum_steps=accum_steps,
                                      moe_aux_coeff=0.05)
    state = tsteps.init_train_state(model, opt)
    for i in range(2):
        batch = _batch(50 + i, dims=jdims)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=2e-5)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=2e-5)
    assert_tree_close(model, jstate.params, atol=2e-6)
    # the aux term is in the loss: without it the same step reads less
    plain = tsteps.make_cap_train_step(model.dims, SMOOTHING, PAD,
                                       accum_steps=accum_steps,
                                       moe_aux_coeff=0.0)
    assert plain(state, _batch(52, dims=jdims))[1]['loss'].item() < \
        m['loss'].item() + 0.05


def test_moe_cached_greedy_equals_uncached_and_jax():
    '''The KV-cached greedy decode of a MoE captioner (the lossless form
    one token at a time) equals the uncached loop's tokens and JAX's.'''
    jdims, params, model = _moe_model(seed=5)
    rng = np.random.default_rng(6)
    src = features(rng, 3, 7, 9, jdims, pad_rows={1: (4, 5)})
    tsrc = {k: torch.from_numpy(v) for k, v in src.items()}
    cached = greedy_decode_bimodal(model, tsrc, 6, START, END, PAD)
    uncached = greedy_decode_uncached(
        lambda s, t, m: model(s, t, m), tsrc, 6, START, END, PAD)
    np.testing.assert_array_equal(cached[:, :uncached.shape[1]].numpy(),
                                  uncached.numpy())
    want = j_greedy(params, jdims, jax.tree.map(jnp.asarray, src), 6, START,
                    END, PAD)
    np.testing.assert_array_equal(cached.numpy(), np.asarray(want))


def test_moe_tree_round_trips_bit_for_bit():
    '''A JAX-initialised MoE tree loads into the port and comes back
    unchanged, its leaves under JAX's paths (router and experts in JAX's
    layout); int8 quantization leaves the MoE leaves as they are in both
    packages.'''
    jdims, params, model = _moe_model(seed=7)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    got = to_jax_tree(model)
    for path, leaf in flat.items():
        keys = tuple(getattr(k, 'key', getattr(k, 'idx', None))
                     for k in path)
        node = got
        for k in keys:
            node = node[k]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert len(list(named_jax_parameters(model))) == len(flat)
    assert ('encoder', 'layers', 0, 'ff_M1', 'experts', 'w1') in {
        p for p, _ in named_jax_parameters(model)}
    quantize_tree_int8(model)
    assert count_quantized(model) == j_count_quantized(
        j_quantize_tree_int8(params))
    assert isinstance(model.decoder.layers[0].ff, MoEFeedForward)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_moe_checkpoint_saved_by_one_package_loads_in_the_other(tmp_path,
                                                                writer):
    '''npz directories both ways: the port's ``load_cap_checkpoint`` builds
    a MoE captioner from the config; a MoE model has no ``.pt`` export in
    either package, with the same message.'''
    from bmt_tpu.config import Config as JConfig
    from bmt_tpu.config import build_parser as jparser
    from bmt_tpu_torch.config import Config
    jdims, params, model = _moe_model(seed=8)
    argv = ['--procedure', 'train_cap', '--d_model', '16', '--H', '2',
            '--N', '2', '--d_model_caps', '16', '--d_vid', '20', '--d_aud',
            '6', '--use_linear_embedder', '--d_model_video', '16',
            '--d_model_audio', '8', '--d_ff_video', '24', '--d_ff_audio',
            '16', '--d_ff_caps', '20', '--moe_experts', '4']
    jcfg = JConfig(jparser().parse_args(argv))
    itos = ['<unk>', '<blank>', '<s>', '</s>'] + [f'w{i}' for i in
                                                  range(4, jdims.voc_size)]
    meta = {'config': jcfg.to_dict(), 'epoch': 0, 'vocab_itos': itos}
    if writer == 'port':
        tckpt.save_checkpoint(str(tmp_path), model, meta)
        template = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray,
                                                            params))
        loaded = jckpt.load_model_params(str(tmp_path), 'best_cap_model',
                                         template)
        jax.tree.map(np.testing.assert_array_equal, loaded,
                     jax.tree.map(np.asarray, params))
    else:
        jckpt.save_checkpoint(str(tmp_path), params, meta)
        cfg, dims, loaded, vocab = tckpt.load_cap_checkpoint(str(tmp_path),
                                                             device='cpu')
        assert dims.moe_experts == 4 and vocab.itos == itos
        assert isinstance(loaded.encoder.layers[1].ff_M2, MoEFeedForward)
        for a, b in zip(model.parameters(), loaded.parameters()):
            assert torch.equal(a, b)
        assert Config.from_dict(json.loads(json.dumps(cfg.to_dict()))
                                ).moe_experts == 4
    with pytest.raises(ValueError, match='cannot export a MoE model') as got:
        tckpt.export_cap_state_dict(model)
    with pytest.raises(ValueError, match='cannot export a MoE model') as want:
        jckpt.export_cap_state_dict(params)
    assert str(got.value).split('. ')[0] == str(want.value).split('. ')[0]


def test_moe_captioner_is_built_from_dims():
    '''``BiModalTransformer`` builds MoE FFNs at the three sites of each
    layer from ``moe_experts``/``moe_cf``, and dense ones at E <= 1.'''
    _, dims = dims_pair(moe_experts=3, moe_cf=2.0)
    model = BiModalTransformer(dims, device='cpu')
    layer = model.encoder.layers[0]
    assert isinstance(layer.ff_M1, MoEFeedForward)
    assert layer.ff_M2.experts.w1.shape == (3, dims.d_model_V, dims.d_ff_V)
    assert model.decoder.layers[1].ff.capacity_factor == 2.0
    _, dims = dims_pair(moe_experts=1)
    assert isinstance(BiModalTransformer(dims, device='cpu')
                      .decoder.layers[0].ff, FeedForward)
