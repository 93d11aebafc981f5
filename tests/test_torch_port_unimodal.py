'''The uni-modal (audio-only and video-only) captioner and proposal generator
of the PyTorch port against the JAX package, on the CPU at small widths
(d_model 32 for audio and 64 for video, H=4, N=2, a 50-word vocabulary),
inputs made with numpy from a seed and handed to both, fp32:
``make_masks``, the ``Encoder`` and ``Decoder``, ``UniModalTransformer``,
the cached greedy decode, beam search and sampling, the
``UnimodalProposalGenerator``, one train step of each model, the reference
``.pt`` import, native directories across the packages, and main.py's
procedures through ``python -m bmt_tpu_torch``. attention_impl 'kernel' (the
CUDA kernels' plain versions on the CPU) is held to JAX's 'pallas'
(interpret mode) and 'torch' to 'xla'.

Tolerances:
- masks and tokens exactly equal;
- encoder and decoder 1e-5 absolute (two layers of fp32 sums in another
  order); log-probs 1e-5 absolute plus 1e-5 relative: with random weights
  they reach -31 here, where one fp32 ulp is 1.9e-6;
- beam scores 1e-5, and 1e-3 with kv_int8: an int8 level can round the
  other way between the packages where the two fp32 memories differ by
  ~1e-7 at a rounding boundary (ROADMAP section 3);
- proposal predictions 1e-5 absolute plus 1e-4 relative (seconds up to
  ~40), the loss and its terms 1e-5 relative;
- train steps as ``tests/test_torch_port_train.py``: loss, grad_norm and
  each loss term 2e-5 relative, parameters 2e-6 absolute after two Adam
  steps.'''
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.decode.beam import beam_search_unimodal as j_beam
from bmt_tpu.decode.greedy import greedy_decode_unimodal as j_greedy
from bmt_tpu.models import CapModelDims as JaxCapDims
from bmt_tpu.models import (init_unimodal_transformer,
                            unimodal_transformer_forward)
from bmt_tpu.models import proposal as jprop
from bmt_tpu.models.decoders import decoder_forward
from bmt_tpu.models.encoders import encoder_forward
from bmt_tpu.ops.masks import make_masks as j_make_masks
from bmt_tpu.train import checkpoint as jckpt
from bmt_tpu.train import optim as joptim
from bmt_tpu.train import steps as jsteps
from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.decode import (beam_search_unimodal,
                                  greedy_decode_uncached,
                                  greedy_decode_unimodal,
                                  make_bimodal_beam_fn,
                                  make_bimodal_greedy_fn,
                                  make_bimodal_sample_fn,
                                  sample_decode_unimodal)
from bmt_tpu_torch.models import (CapModelDims, PropModelDims,
                                  UniModalTransformer,
                                  UnimodalProposalGenerator)
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.params import load_jax_params, to_jax_tree
from bmt_tpu_torch.train import checkpoint as tckpt
from bmt_tpu_torch.train import optim as toptim
from bmt_tpu_torch.train import steps as tsteps
from tests.torch_port_tree import mini_argv, mini_tree
from tests.torch_port_util import (END, PAD, START, assert_tree_close,
                                   to_jax, to_torch)

torch.set_num_threads(1)

MODALITIES = ['audio', 'video']
IMPLS = [('kernel', 'pallas'), ('torch', 'xla')]
CAP = dict(voc_size=50, d_model_A=32, d_model_V=64, d_model=16, H=4, N=2,
           d_ff_A=64, d_ff_V=128, d_model_C=16, d_ff_C=32, dout_p=0.0,
           d_vid=20, d_aud=6, use_linear_embedder=True)
PROP = dict(d_model_A=32, d_model_V=64, d_model=16, H=4, N=2, d_ff_A=64,
            d_ff_V=128, dout_p=0.0, d_vid=20, d_aud=6,
            use_linear_embedder=True, kernel_sizes_A=(3, 5),
            kernel_sizes_V=(1, 3), conv_layers_A=(8,), conv_layers_V=(8,),
            anchors_num_A=3, anchors_num_V=4)
ANCHORS = {'audio': [2.0, 6.0, 15.0], 'video': [3.0, 9.0, 20.0, 40.0]}
MAX_LEN = 6
STEP_CFG = types.SimpleNamespace(optimizer='adam', lr=1e-3, grad_clip=1.0,
                                 weight_decay=1e-4, beta1=0.9, beta2=0.999,
                                 eps=1e-4)
FWD_TOL = dict(atol=1e-5, rtol=1e-4)


def captioner(modality, seed=0, **kw):
    '''(JAX dims, JAX params, the port's captioner carrying them on the CPU
    in eval mode).'''
    fields = {**CAP, **kw, 'modality': modality}
    jdims = JaxCapDims(**fields)
    params = jax.tree.map(np.asarray, init_unimodal_transformer(
        jax.random.PRNGKey(seed), jdims))
    model = UniModalTransformer(CapModelDims(**fields), device='cpu')
    load_jax_params(model, params)
    return jdims, params, model.eval()


def generator(modality, seed=0, **kw):
    fields = {**PROP, **kw, 'modality': modality}
    jdims = jprop.PropModelDims(**fields)
    params = jax.tree.map(np.asarray, jprop.init_unimodal_proposal_generator(
        jax.random.PRNGKey(seed), jdims))
    params['anchors'] = np.asarray(ANCHORS[modality], np.float32)
    model = UnimodalProposalGenerator(PropModelDims(**fields), device='cpu')
    load_jax_params(model, params)
    return jdims, params, model.eval()


def features(seed, dims, B=3, Sv=6, Sa=9):
    '''Feature stacks with padded tails in rows 1 and 2 (rgb and audio
    with PAD, flow with 0, as the datasets pad them).'''
    rng = np.random.default_rng(seed)
    src = {'rgb': rng.normal(size=(B, Sv, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(B, Sv, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(B, Sa, dims.d_aud)).astype(np.float32)}
    for row, (nv, na) in {1: (4, 5), 2: (Sv - 1, 3)}.items():
        src['rgb'][row, nv:] = PAD
        src['flow'][row, nv:] = 0.0
        src['audio'][row, na:] = PAD
    return src


def only(src, modality):
    '''The stacks a uni-modal batch holds.'''
    keys = ('audio',) if modality == 'audio' else ('rgb', 'flow')
    return {k: src[k] for k in keys}


def captions(seed, voc, B=3, Sc=7):
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, voc, size=(B, Sc)).astype(np.int32)
    caps[:, 0] = START
    caps[1, 5:] = PAD
    caps[2, 4] = END
    caps[2, 5:] = PAD
    return caps


# ---------------------------------------------------------------------------
# masks, encoder, decoder, captioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('with_captions', [False, True])
@pytest.mark.parametrize('modality', ['audio', 'video', 'audio_video',
                                      'subs_audio_video'])
def test_make_masks_match_jax(modality, with_captions):
    jdims = JaxCapDims(**CAP)
    src = features(1, jdims)
    src['subs'] = np.random.default_rng(2).integers(
        0, 5, size=(3, 4)).astype(np.int32)
    caps = captions(1, 20) if with_captions else None
    want = j_make_masks(to_jax(src), None if caps is None else
                        jnp.asarray(caps), modality, PAD)
    got = make_masks(to_torch(src), None if caps is None else
                     torch.from_numpy(caps), modality, PAD)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    with pytest.raises(ValueError, match='Unknown modality'):
        make_masks(to_torch(src), None, 'subs', PAD)


@pytest.mark.parametrize('impl,jimpl', IMPLS)
@pytest.mark.parametrize('modality', MODALITIES)
def test_encoder_and_decoder_match_jax(modality, impl, jimpl):
    jdims, params, model = captioner(modality, seed=1)
    d = jdims.d_model_V if modality == 'video' else jdims.d_model_A
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 9, d)).astype(np.float32)
    t = rng.normal(size=(3, 7, d)).astype(np.float32)
    src = features(3, jdims, Sv=9, Sa=9)
    caps = captions(3, jdims.voc_size)
    jm = j_make_masks(to_jax(src), jnp.asarray(caps), modality, PAD)
    tm = make_masks(to_torch(src), torch.from_numpy(caps), modality, PAD)
    key = 'V_mask' if modality == 'video' else 'A_mask'
    mem = encoder_forward(params['encoder'], jnp.asarray(x), jm[key],
                          jdims.H, attention_impl=jimpl)
    want = decoder_forward(params['decoder'], jnp.asarray(t), mem, jm[key],
                           jm['C_mask'], jdims.H, attention_impl=jimpl)
    with torch.no_grad():
        got_mem = model.encoder(torch.from_numpy(x), tm[key], impl)
        got = model.decoder(torch.from_numpy(t), got_mem, tm[key],
                            tm['C_mask'], impl)
    np.testing.assert_allclose(got_mem.numpy(), np.asarray(mem), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('impl,jimpl', IMPLS)
@pytest.mark.parametrize('modality', MODALITIES)
def test_captioner_forward_matches_jax(modality, impl, jimpl):
    '''Teacher-forced log-probs, and the logits of ``return_logits``; the
    embedding and the positional table are the modality's width.'''
    jdims, params, model = captioner(modality, seed=2)
    assert model.trg_emb.table.shape[1] == (
        jdims.d_model_V if modality == 'video' else jdims.d_model_A)
    src = only(features(4, jdims), modality)
    caps = captions(4, jdims.voc_size)
    jm = j_make_masks(to_jax(src), jnp.asarray(caps), modality, PAD)
    want = unimodal_transformer_forward(params, jdims, to_jax(src),
                                        jnp.asarray(caps), jm,
                                        attention_impl=jimpl)
    tsrc, tcaps = to_torch(src), torch.from_numpy(caps).long()
    masks = make_masks(tsrc, tcaps, modality, PAD)
    with torch.no_grad():
        got = model(tsrc, tcaps, masks, impl)
        logits = model(tsrc, tcaps, masks, impl, return_logits=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(torch.log_softmax(logits, -1).numpy(),
                               got.numpy(), atol=1e-6)


def test_models_are_built_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for modality in MODALITIES:
        cap = CapModelDims(**{**CAP, 'modality': modality})
        prop = PropModelDims(**{**PROP, 'modality': modality})
        for cls, dims in ((UniModalTransformer, cap),
                          (UnimodalProposalGenerator, prop)):
            for device in ('cuda', 'cuda:0'):
                with pytest.raises(RuntimeError, match='no CUDA device'):
                    cls(dims)
                with pytest.raises(RuntimeError, match='no CUDA device'):
                    cls(dims, device=device)
            assert next(cls(dims, device='cpu').parameters()).device.type \
                == 'cpu'
    with pytest.raises(ValueError, match='audio or video'):
        UniModalTransformer(CapModelDims(**CAP), device='cpu')
    with pytest.raises(ValueError, match='audio or video'):
        UnimodalProposalGenerator(PropModelDims(**PROP), device='cpu')


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('modality', MODALITIES)
def test_cached_greedy_matches_jax_and_the_uncached_decoder(modality):
    '''The KV-cached greedy tokens equal JAX's greedy_decode_unimodal (for
    both attention paths), the port's uncached decoder, and what the
    dispatching binder returns.'''
    jdims, params, model = captioner(modality, seed=3)
    src = only(features(5, jdims), modality)
    want = np.asarray(j_greedy(params, jdims, to_jax(src), MAX_LEN, START,
                               END, PAD))
    for impl in ('kernel', 'torch'):
        got = greedy_decode_unimodal(model, to_torch(src), MAX_LEN, START,
                                     END, PAD, impl)
        np.testing.assert_array_equal(got.numpy(), want)
    slow = greedy_decode_uncached(lambda s, t, m: model(s, t, m),
                                  to_torch(src), MAX_LEN, START, END, PAD,
                                  modality).numpy()
    np.testing.assert_array_equal(slow, want[:, :slow.shape[1]])
    bound = make_bimodal_greedy_fn(model.dims, MAX_LEN, START, END, PAD)
    np.testing.assert_array_equal(bound(model, to_torch(src)).numpy(), want)


@pytest.mark.parametrize('kv_int8', [False, True])
@pytest.mark.parametrize('modality', MODALITIES)
def test_beam_search_matches_jax(modality, kv_int8):
    '''K=2, length penalty 0.6: the best beam's tokens and score.'''
    jdims, params, model = captioner(modality, seed=4)
    src = only(features(6, jdims), modality)
    toks, scores = beam_search_unimodal(model, to_torch(src), MAX_LEN, START,
                                        END, PAD, 2, 0.6, kv_int8=kv_int8)
    jt, js = j_beam(params, jdims, to_jax(src), MAX_LEN, START, END, PAD, 2,
                    0.6, kv_int8=kv_int8)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=0,
                               atol=1e-3 if kv_int8 else 1e-5)
    bound = make_bimodal_beam_fn(model.dims, MAX_LEN, START, END, PAD, 2, 0.6,
                                 kv_int8=kv_int8)
    np.testing.assert_array_equal(bound(model, to_torch(src)).numpy(),
                                  toks.numpy())


@pytest.mark.parametrize('modality', MODALITIES)
def test_sample_top_k_1_equals_greedy(modality):
    '''Top-k 1 sampling is greedy decoding, through the function and the
    dispatching binder; a seed reproduces its draws.'''
    _, _, model = captioner(modality, seed=5)
    src = to_torch(only(features(7, model.dims), modality))
    want = greedy_decode_unimodal(model, src, MAX_LEN, START, END, PAD)
    got = sample_decode_unimodal(model, src, 4, MAX_LEN, START, END, PAD,
                                 top_k=1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    bound = make_bimodal_sample_fn(model.dims, MAX_LEN, START, END, PAD,
                                   top_k=1)
    np.testing.assert_array_equal(bound(model, src).numpy(), want.numpy())
    a, b = (sample_decode_unimodal(model, src, 9, MAX_LEN, START, END, PAD,
                                   temperature=1.5) for _ in range(2))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# the proposal generator
# ---------------------------------------------------------------------------

def prop_batch(seed, modality, dims, B=4, S=24, E=5):
    rng = np.random.default_rng(seed)
    src = only(features(seed, dims, B=B, Sv=S, Sa=S), modality)
    stride = dims.stride_V if modality == 'video' else dims.stride_A
    centers = rng.uniform(-2, S * stride + 2, size=(B, E)).astype(np.float32)
    lengths = rng.uniform(0.5, 30, size=(B, E)).astype(np.float32)
    valid = np.arange(E)[None, :] < rng.integers(1, E + 1, size=(B, 1))
    return {'src': src, 'centers': centers, 'lengths': lengths,
            'valid': valid}


def _targets(batch, torch_side):
    keys = ('centers', 'lengths', 'valid')
    if torch_side:
        return tuple(torch.from_numpy(batch[k]) for k in keys)
    return tuple(jnp.asarray(batch[k]) for k in keys)


@pytest.mark.parametrize('case,impl,jimpl', [
    ('targets', 'kernel', 'pallas'), ('inference', 'torch', 'xla')])
@pytest.mark.parametrize('modality', MODALITIES)
def test_proposal_forward_matches_jax(modality, case, impl, jimpl):
    '''Predictions (each head anchor-major), the loss and its terms; one
    ``anchors`` leaf and the modality's stride, conv layers and kernel
    sizes.'''
    jdims, params, model = generator(modality, seed=6)
    assert {'anchors', 'heads', 'encoder', 'emb'} == set(to_jax_tree(model))
    batch = prop_batch(8, modality, jdims)
    with_targets = case == 'targets'
    jsrc = to_jax(batch['src'])
    want = jprop.unimodal_proposal_forward(
        params, jdims, jsrc, _targets(batch, False) if with_targets else None,
        j_make_masks(jsrc, None, modality, PAD), attention_impl=jimpl)
    tsrc = to_torch(batch['src'])
    with torch.no_grad():
        got = model(tsrc, _targets(batch, True) if with_targets else None,
                    make_masks(tsrc, None, modality, PAD), impl)
    A = len(ANCHORS[modality])
    assert got[0].shape == (4, 2 * A * 24, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **FWD_TOL)
    if not with_targets:
        assert got[1:] == (0.0, {})
        return
    np.testing.assert_allclose(got[1].item(), float(want[1]), rtol=1e-5)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k].item(), float(want[2][k]),
                                   rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _cap_batch(seed, modality, dims):
    src = only(features(seed, dims, B=4), modality)
    return {'src': src, 'caption': captions(seed, dims.voc_size, B=4),
            'row_valid': np.arange(4) < 3}


@pytest.mark.parametrize('modality,impl,jimpl,accum', [
    ('audio', 'kernel', 'pallas', 2), ('video', 'torch', 'xla', 1)])
def test_cap_train_step_matches_jax(modality, impl, jimpl, accum):
    '''Two Adam steps, dropout off, a repeat-padded tail row: loss,
    grad_norm and the parameters after both steps.'''
    jdims, params, model = captioner(modality, seed=7)
    jopt = joptim.build_optimizer(STEP_CFG)
    jstep = jax.jit(jsteps.make_cap_train_step(
        jdims, jopt, 0.7, PAD, attention_impl=jimpl, accum_steps=accum))
    jstate = jsteps.init_train_state(to_jax(params), jopt)
    opt = toptim.build_optimizer(STEP_CFG, model)
    step = tsteps.make_cap_train_step(model.dims, 0.7, PAD, impl,
                                      accum_steps=accum)
    state = tsteps.init_train_state(model, opt)
    for i in range(2):
        batch = _cap_batch(10 + i, modality, jdims)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, m = step(state, batch)
        np.testing.assert_allclose(m['loss'].item(), float(jm['loss']),
                                   rtol=2e-5)
        np.testing.assert_allclose(m['grad_norm'].item(),
                                   float(jm['grad_norm']), rtol=2e-5)
    assert_tree_close(model, jstate.params, atol=2e-6)


@pytest.mark.parametrize('modality,impl,jimpl,accum,freeze', [
    ('audio', 'kernel', 'pallas', 2, False),
    ('video', 'torch', 'xla', 1, True)])
def test_prop_train_step_matches_jax(modality, impl, jimpl, accum, freeze):
    '''Two Adam steps, dropout off: the loss and its terms filed under the
    modality's side (_A for audio, _V for video), the parameters after
    both steps; the anchors, and a frozen encoder, exactly as they were.'''
    jdims, params, model = generator(modality, seed=8)
    frozen = tsteps.prop_frozen(freeze)
    mask = joptim.freeze_mask(params, frozen)
    jopt = joptim.build_optimizer(STEP_CFG, frozen_mask=mask)
    jstep = jax.jit(jsteps.make_prop_train_step(
        jdims, jopt, PAD, attention_impl=jimpl, accum_steps=accum,
        frozen_mask=mask))
    jstate = jsteps.init_train_state(to_jax(params), jopt)
    opt = toptim.build_optimizer(STEP_CFG, model, frozen=frozen)
    step = tsteps.make_prop_train_step(model.dims, PAD, impl,
                                       accum_steps=accum)
    state = tsteps.init_train_state(model, opt)
    side = '_V' if modality == 'video' else '_A'
    for i in range(2):
        batch = prop_batch(20 + i, modality, jdims)
        jstate, jm = jstep(jstate, to_jax(batch))
        state, m = step(state, batch)
        assert set(m) == set(jm) | {'grad_norm'}
        assert all(k == 'loss' or k.endswith(side) for k in jm)
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=2e-5,
                                       err_msg=k)
    assert_tree_close(model, jstate.params, atol=2e-6)
    np.testing.assert_array_equal(model.anchors.numpy(), params['anchors'])
    if freeze:
        for a, b in zip(jax.tree.leaves(to_jax_tree(model.encoder)),
                        jax.tree.leaves(params['encoder'])):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _reference_cap_sd(params):
    '''A reference uni-modal Transformer's state dict (DataParallel
    ``module.`` keys) from a JAX-layout tree.'''
    sd = {'trg_emb.embedder.weight': params['trg_emb']['table']}
    jckpt._sd_put_lin(sd, 'src_emb.embedder', params['src_emb']['linear'])
    _reference_encoder(sd, params['encoder'])
    for i, L in enumerate(params['decoder']['layers']):
        b = f'decoder.dec_layers.{i}'
        jckpt._sd_put_mha(sd, f'{b}.self_att', L['self_att'])
        jckpt._sd_put_mha(sd, f'{b}.enc_att', L['enc_att'])
        jckpt._sd_put_ffn(sd, f'{b}.feed_forward', L['ff'])
        for j in range(3):
            jckpt._sd_put_ln(sd, f'{b}.res_layers.{j}.norm', L['res'][j])
    jckpt._sd_put_lin(sd, 'generator.linear', params['generator'])
    return {f'module.{k}': torch.from_numpy(np.asarray(v).copy())
            for k, v in sd.items()}


def _reference_encoder(sd, enc):
    for i, L in enumerate(enc['layers']):
        b = f'encoder.enc_layers.{i}'
        jckpt._sd_put_mha(sd, f'{b}.self_att', L['self_att'])
        jckpt._sd_put_ffn(sd, f'{b}.feed_forward', L['ff'])
        for j in range(2):
            jckpt._sd_put_ln(sd, f'{b}.res_layers.{j}.norm', L['res'][j])


def _reference_prop_sd(params):
    sd = {}
    jckpt._sd_put_lin(sd, 'emb.embedder', params['emb']['linear'])
    _reference_encoder(sd, params['encoder'])
    for i, head in enumerate(params['heads']):
        jckpt._conv_head_to_sd(sd, f'detection_layers.{i}', head)
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}


def _config(procedure, modality, tmp_path):
    from bmt_tpu_torch.config import Config, build_parser
    tree = tmp_path / 'tree'
    tree.mkdir(exist_ok=True)
    cfg = Config(build_parser().parse_args(mini_argv(
        tree, tmp_path / 'log', procedure, modality=modality, d_vid=20,
        d_aud=6, H=4, N=2, use_linear_embedder=None, d_model_audio=32,
        d_model_video=64, d_ff_audio=64, d_ff_video=128)))
    return cfg


def _assert_trees_equal(a, b):
    fa = {jax.tree_util.keystr(p): np.asarray(x)
          for p, x in jax.tree_util.tree_flatten_with_path(a)[0]}
    fb = {jax.tree_util.keystr(p): np.asarray(x)
          for p, x in jax.tree_util.tree_flatten_with_path(b)[0]}
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize('modality', MODALITIES)
def test_reference_pt_imports_equal_jax(modality, tmp_path):
    '''Reference-layout state dicts of both uni-modal models import into the
    JAX package's trees exactly; ``load_cap_checkpoint`` and
    ``load_prop_checkpoint`` build the uni-modal models from the ``.pt``
    files, and the captioner's vocabulary check reads ``trg_emb``.'''
    jdims, params, _ = captioner(modality, seed=9, voc_size=14)
    cfg = _config('train_cap', modality, tmp_path)
    cpt = {'model_state_dict': _reference_cap_sd(params),
           'config': types.SimpleNamespace(**cfg.to_dict()),
           'trg_voc_size': 14}
    pt = str(tmp_path / 'cap.pt')
    torch.save(cpt, pt)
    loaded = tckpt.load_torch_checkpoint(pt)
    got, _ = tckpt.import_unimodal_cap_model(loaded)
    want, _ = jckpt.import_unimodal_cap_model(jckpt.load_torch_checkpoint(pt))
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, params)
    # the mini tree's vocabulary has 14 tokens
    mini_tree(tmp_path / 'tree')
    _, dims, model, vocab = tckpt.load_cap_checkpoint(
        pt, str(tmp_path / 'tree' / 'train.csv'), device='cpu')
    assert isinstance(model, UniModalTransformer) and len(vocab) == 14
    _assert_trees_equal(to_jax_tree(model), params)
    torch.save({**cpt, 'trg_voc_size': 15}, pt)
    with pytest.raises(ValueError, match='rebuilt vocab size 14'):
        tckpt.load_cap_checkpoint(pt, str(tmp_path / 'tree' / 'train.csv'),
                                  device='cpu')
    seeded = UniModalTransformer(model.dims, device='cpu')
    tckpt.load_pretrained_cap_params(pt, seeded)
    _assert_trees_equal(to_jax_tree(seeded), params)

    pjdims, pparams, _ = generator(modality, seed=10)
    pcfg = _config('train_prop', modality, tmp_path)
    pt = str(tmp_path / 'prop.pt')
    torch.save({'model_state_dict': _reference_prop_sd(pparams),
                'config': types.SimpleNamespace(**pcfg.to_dict()),
                'anchors': {modality: ANCHORS[modality]}}, pt)
    got, _ = tckpt.import_unimodal_prop_model(
        tckpt.load_torch_checkpoint(pt), modality)
    want, _ = jckpt.import_unimodal_prop_model(
        jckpt.load_torch_checkpoint(pt), modality)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, pparams)
    _, _, prop = tckpt.load_prop_checkpoint(pt, device='cpu')
    assert isinstance(prop, UnimodalProposalGenerator)
    _assert_trees_equal(to_jax_tree(prop), pparams)


@pytest.mark.parametrize('modality', MODALITIES)
def test_native_dirs_load_across_the_packages(modality, tmp_path):
    '''A uni-modal captioner's and proposal generator's npz directories
    written by either package load in the other, equal leaf for leaf.'''
    _, params, model = captioner(modality, seed=11)
    cfg = _config('train_cap', modality, tmp_path).to_dict()
    itos = ['<unk>', '<blank>', '<s>', '</s>'] + [f'w{i}' for i in range(46)]
    meta = {'config': cfg, 'epoch': 0, 'vocab_itos': itos}
    jckpt.save_checkpoint(str(tmp_path / 'jcap'), to_jax(params), meta)
    _, _, got, _ = tckpt.load_cap_checkpoint(str(tmp_path / 'jcap'),
                                             device='cpu')
    assert isinstance(got, UniModalTransformer)
    _assert_trees_equal(to_jax_tree(got), params)
    tckpt.save_checkpoint(str(tmp_path / 'tcap'), model, meta)
    _, _, want, _ = jckpt.load_cap_checkpoint(str(tmp_path / 'tcap'))
    assert 'trg_emb' in want and 'emb_C' not in want
    _assert_trees_equal(want, params)

    _, pparams, prop = generator(modality, seed=12)
    pmeta = {'config': _config('train_prop', modality, tmp_path).to_dict(),
             'epoch': 0}
    pmeta['config'][f'anchors_num_{modality}'] = len(ANCHORS[modality])
    jckpt.save_checkpoint(str(tmp_path / 'jprop'), to_jax(pparams), pmeta,
                          name='best_prop_model')
    _, _, got = tckpt.load_prop_checkpoint(str(tmp_path / 'jprop'),
                                           device='cpu')
    _assert_trees_equal(to_jax_tree(got), pparams)
    tckpt.save_checkpoint(str(tmp_path / 'tprop'), prop, pmeta,
                          name='best_prop_model')
    _, _, want = jckpt.load_prop_checkpoint(str(tmp_path / 'tprop'))
    _assert_trees_equal(want, pparams)


# ---------------------------------------------------------------------------
# main.py's procedures
# ---------------------------------------------------------------------------

def _npz(path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def test_cli_runs_the_unimodal_procedures(tmp_path, monkeypatch):
    '''python -m bmt_tpu_torch: train_cap --modality audio, train_prop
    --modality audio with that captioner's encoder (frozen), evaluate of the
    audio captioner on its proposals (greedy, and beam with the int8 cross
    K/V and int8 weights), train_prop --modality video, and train_cap
    --modality video with that generator's encoder (frozen); the
    checkpoints hold the uni-modal trees and load back.'''
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'tree').mkdir()
    tree = mini_tree(tmp_path / 'tree')
    log = tmp_path / 'log'

    def run(procedure, **flags):
        return cli.main(mini_argv(tree, log, procedure, device='cpu',
                                  **flags))

    best = run('train_cap', modality='audio', exper_name='cap')
    cap_dir = log / 'train_cap' / 'cap'
    cap = _npz(cap_dir / 'best_cap_model.params.npz')
    assert 'trg_emb/table' in cap and not any(k.startswith('emb_C')
                                                 for k in cap)
    meta = json.loads((cap_dir / 'best_cap_model.meta.json').read_text())
    assert best == meta['best_metric']
    assert meta['config']['modality'] == 'audio'

    f1 = run('train_prop', modality='audio', exper_name='prop',
             pretrained_cap_model_path=cap_dir)
    prop = _npz(log / 'train_prop' / 'prop' / 'best_prop_model.params.npz')
    enc = [k for k in prop if k.startswith('encoder/')]
    assert enc and all(np.array_equal(prop[k], cap[k]) for k in enc)
    assert prop['anchors'].shape == (3,) and 0 <= f1 <= 1

    metrics = run('evaluate', pretrained_cap_model_path=cap_dir,
                  prop_pred_path=str(log / 'train_prop' / 'prop'
                                     / 'submissions'
                                     / 'prop_results_val_1_e0_maxprop10'
                                       '.json'))
    assert list(metrics) == [0.3, 0.5, 0.7, 0.9, 'Average across tIoUs']
    assert all(np.isfinite(v) for v in metrics['Average across tIoUs']
               .values())

    metrics = run('evaluate', pretrained_cap_model_path=cap_dir,
                  prop_pred_path=str(log / 'train_prop' / 'prop'
                                     / 'submissions'
                                     / 'prop_results_val_1_e0_maxprop10'
                                       '.json'),
                  decode_strategy='beam', kv_cache_int8=None,
                  weights_int8=None)
    assert all(np.isfinite(v) for v in metrics['Average across tIoUs']
               .values())

    run('train_prop', modality='video', exper_name='vprop')
    vprop_dir = log / 'train_prop' / 'vprop'
    _, dims, vprop = tckpt.load_prop_checkpoint(str(vprop_dir), device='cpu')
    assert isinstance(vprop, UnimodalProposalGenerator)
    assert dims.modality == 'video' and vprop.anchors.shape == (4,)
    # a video captioner seeded from that generator's encoder, frozen
    run('train_cap', modality='video', exper_name='vcap',
        pretrained_prop_model_path=vprop_dir)
    vcap = _npz(log / 'train_cap' / 'vcap' / 'last_cap_model.params.npz')
    vp = _npz(vprop_dir / 'best_prop_model.params.npz')
    enc = [k for k in vp if k.startswith('encoder/')]
    assert enc and all(np.array_equal(vcap[k], vp[k]) for k in enc)
    _, _, cap_model, _ = tckpt.load_cap_checkpoint(str(cap_dir),
                                                   device='cpu')
    assert isinstance(cap_model, UniModalTransformer)
    assert dataclasses.asdict(cap_model.dims)['modality'] == 'audio'
