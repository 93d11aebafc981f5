'''The port's checkpoints (``bmt_tpu_torch.train.checkpoint``) against the JAX
package's (``bmt_tpu.train.checkpoint``): native npz directories written by
either package load in the other (equal params; log-probs and proposals
equal to JAX's forward), the reference ``.pt`` bridge in both directions
(import against the reference-layout torch modules' own forward, exports key
for key, strict loads into the reference layout), the optimizer resume, the
async writer and the errors.

Tolerance: 1e-5 absolute / 1e-4 relative on log-probs and proposals (two
fp32 forwards whose sums run in another order); params are bit-exact.'''
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu import config as jax_config
from bmt_tpu.models import CapModelDims as JaxCapDims
from bmt_tpu.models import PropModelDims as JaxPropDims
from bmt_tpu.models import (bimodal_transformer_forward,
                            init_bimodal_transformer,
                            init_multimodal_proposal_generator,
                            multimodal_proposal_forward)
from bmt_tpu.ops.lora import add_lora
from bmt_tpu.ops.masks import make_masks as j_make_masks
from bmt_tpu.train import checkpoint as jckpt
from bmt_tpu_torch import config as port_config
from bmt_tpu_torch.data.vocab import build_vocab_from_meta
from bmt_tpu_torch.models import (BiModalTransformer, CapModelDims,
                                  MultimodalProposalGenerator, PropModelDims)
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.params import load_jax_params, to_jax_tree
from bmt_tpu_torch.ops import lora as port_lora
from bmt_tpu_torch.train import build_optimizer
from bmt_tpu_torch.train.options import check_model_ported
from bmt_tpu_torch.train import checkpoint as tckpt
from test_torch_import_real import DIMS as REF_DIMS
from test_torch_import_real import BiModalTransformer as RefCaptioner
from test_torch_import_real import _make_inputs as ref_inputs
from test_torch_import_real import \
    _save_reference_style_checkpoint as save_reference_style
from test_torch_prop_export import MultimodalPropMirror
from tests.torch_port_util import PAD, assert_tree_close, to_jax, to_torch

TOL = dict(atol=1e-5, rtol=1e-4)
CAP_ARGV = ['--procedure', 'train_cap', '--dont_log', '--d_vid', '20',
            '--d_aud', '6', '--use_linear_embedder', '--d_model_audio', '8',
            '--d_model_video', '16', '--d_model', '16', '--d_model_caps',
            '12', '--H', '2', '--N', '2']
PROP_ARGV = ['--procedure', 'train_prop', '--dont_log', '--d_vid', '20',
             '--d_aud', '6', '--use_linear_embedder', '--d_model_audio', '8',
             '--d_model_video', '12', '--d_model', '16', '--H', '2', '--N',
             '1', '--anchors_num_audio', '2', '--anchors_num_video', '3',
             '--kernel_sizes_audio', '3', '5', '--kernel_sizes_video', '3',
             '--conv_layers_audio', '8', '8', '--conv_layers_video', '8',
             '--pad_audio_feats_up_to', '24', '--pad_video_feats_up_to',
             '12']
ANCHORS_A, ANCHORS_V = [2.0, 6.0], [3.0, 9.0, 20.0]
WORDS = ['man', 'woman', 'dog', 'runs', 'jumps', 'the', 'a', 'ball', 'high',
         'into', 'water', 'field', 'long', 'track']
ADAM = types.SimpleNamespace(optimizer='adam', lr=1e-2, grad_clip=0.5,
                             weight_decay=1e-3, beta1=0.9, beta2=0.99,
                             eps=1e-6)
SGD = types.SimpleNamespace(optimizer='sgd', lr=1e-2, grad_clip=None,
                            weight_decay=0.0, momentum=0.9)


def jax_cfg(argv):
    return jax_config.Config(jax_config.build_parser().parse_args(argv))


def write_meta_csv(path, n=12, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, 'w') as f:
        f.write('video_id\tcaption\tstart\tend\tduration\tphase\tidx\n')
        for i in range(n):
            cap = ' '.join(rng.choice(WORDS, size=rng.integers(3, 8)))
            f.write(f'v_{i}\t{cap}\t0.0\t5.0\t10.0\ttrain\t{i}\n')
    return build_vocab_from_meta(path)


@pytest.fixture
def vocab_csv(tmp_path):
    path = str(tmp_path / 'train.csv')
    return path, write_meta_csv(path)


def cap_inputs(dims, seed=0, B=2, Sv=7, Sa=9, Sc=6):
    rng = np.random.default_rng(seed)
    src = {'rgb': rng.normal(size=(B, Sv, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(B, Sv, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(B, Sa, dims.d_aud)).astype(np.float32)}
    src['rgb'][1, 5:] = PAD
    src['flow'][1, 5:] = 0.0
    src['audio'][1, 6:] = PAD
    caps = rng.integers(4, dims.voc_size, size=(B, Sc))
    caps[:, 0] = 2
    caps[1, 4:] = PAD
    return src, caps


def jax_log_probs(params, jdims, src, caps):
    jsrc, jcaps = to_jax(src), jnp.asarray(caps)
    return np.asarray(bimodal_transformer_forward(
        params, jdims, jsrc, jcaps,
        j_make_masks(jsrc, jcaps, 'audio_video', PAD), deterministic=True))


def port_log_probs(model, src, caps):
    tsrc, tcaps = to_torch(src), torch.from_numpy(caps)
    with torch.no_grad():
        return model(tsrc, tcaps,
                     make_masks(tsrc, tcaps, 'audio_video', PAD)).numpy()


def glove_table(n, width=6):
    return np.random.default_rng(3).normal(size=(n, width)).astype(np.float32)


def jax_cap_checkpoint(path, itos, glove=False, seed=0):
    '''A JAX-written native captioner directory; returns (cfg, dims,
    params).'''
    cfg = jax_cfg(CAP_ARGV)
    jdims = JaxCapDims.from_config(cfg, len(itos))
    params = init_bimodal_transformer(
        jax.random.PRNGKey(seed), jdims,
        glove=glove_table(len(itos)) if glove else None)
    jckpt.save_checkpoint(path, params, {'config': cfg.to_dict(), 'epoch': 1,
                                         'vocab_itos': itos,
                                         'trg_voc_size': len(itos)})
    return cfg, jdims, params


def port_captioner(n_words, glove=False, seed=0):
    cfg = port_config.Config(port_config.build_parser().parse_args(CAP_ARGV))
    dims = CapModelDims.from_config(cfg, n_words)
    model = BiModalTransformer(
        dims, device='cpu', generator=torch.Generator().manual_seed(seed),
        table_dim=6 if glove else None).eval()
    return cfg, dims, model


def port_proposal_generator(seed=0, argv=PROP_ARGV):
    cfg = port_config.Config(port_config.build_parser().parse_args(argv))
    dims = PropModelDims.from_config(cfg)
    model = MultimodalProposalGenerator(
        dims, device='cpu', generator=torch.Generator().manual_seed(seed))
    model.set_anchors(ANCHORS_A, ANCHORS_V)
    return cfg, dims, model.eval()


def jax_prop_params(seed=0, argv=PROP_ARGV):
    cfg = jax_cfg(argv)
    jdims = JaxPropDims.from_config(cfg)
    params = init_multimodal_proposal_generator(jax.random.PRNGKey(seed),
                                                jdims)
    params['anchors_A'] = jnp.asarray(ANCHORS_A)
    params['anchors_V'] = jnp.asarray(ANCHORS_V)
    return cfg, jdims, params


def prop_inputs(dims, seed=0):
    rng = np.random.default_rng(seed)
    src = {'rgb': rng.normal(size=(1, 12, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(1, 12, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(1, 24, dims.d_aud)).astype(np.float32)}
    src['rgb'][0, 9:] = PAD
    src['flow'][0, 9:] = 0.0
    src['audio'][0, 18:] = PAD
    return src


def assert_params_equal(model, tree):
    assert_tree_close(model, jax.tree.map(np.asarray, tree), atol=0)


# ---------------------------------------------------------------------------
# native directories, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('glove', [False, True])
def test_jax_written_cap_dir_loads_in_port_with_equal_log_probs(
        tmp_path, vocab_csv, glove):
    itos = vocab_csv[1].itos
    _, jdims, params = jax_cap_checkpoint(str(tmp_path / 'ckpt'), itos, glove)
    cfg, dims, model, vocab = tckpt.load_cap_checkpoint(
        str(tmp_path / 'ckpt'), device='cpu')
    assert vocab.itos == itos and not model.training
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    assert (model.emb_C.adapter is not None) == glove
    src, caps = cap_inputs(dims)
    np.testing.assert_allclose(port_log_probs(model, src, caps),
                               jax_log_probs(params, jdims, src, caps), **TOL)


@pytest.mark.parametrize('glove', [False, True])
def test_port_written_cap_dir_loads_in_jax_with_equal_params(
        tmp_path, vocab_csv, glove):
    itos = vocab_csv[1].itos
    cfg, _, model = port_captioner(len(itos), glove, seed=1)
    tckpt.save_checkpoint(str(tmp_path), model,
                          {'config': cfg.to_dict(), 'epoch': 2,
                           'vocab_itos': itos})
    jcfg, jdims, params, vocab = jckpt.load_cap_checkpoint(str(tmp_path))
    assert vocab.itos == itos and jcfg.device == 'cuda'
    assert ('adapter' in params['emb_C']) == glove
    assert_params_equal(model, params)


def test_jax_written_prop_dir_loads_in_port_with_equal_proposals(tmp_path):
    cfg, jdims, params = jax_prop_params(seed=2)
    jckpt.save_checkpoint(str(tmp_path), params,
                          {'config': cfg.to_dict(), 'epoch': 0},
                          name='best_prop_model')
    pcfg, dims, model = tckpt.load_prop_checkpoint(
        str(tmp_path), max_prop_per_vid=7, device='cpu')
    assert pcfg.max_prop_per_vid == 7 and not model.training
    np.testing.assert_array_equal(model.anchors_A.numpy(), ANCHORS_A)
    np.testing.assert_array_equal(model.anchors_V.numpy(), ANCHORS_V)
    src = prop_inputs(dims)
    jsrc = to_jax(src)
    want = multimodal_proposal_forward(
        params, jdims, jsrc, None, j_make_masks(jsrc, None, 'audio_video',
                                                PAD))[0]
    tsrc = to_torch(src)
    with torch.no_grad():
        got = model(tsrc, None, make_masks(tsrc, None, 'audio_video', PAD))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('layer_norm', [False, True])
def test_port_written_prop_dir_loads_in_jax_with_equal_params(tmp_path,
                                                              layer_norm):
    argv = PROP_ARGV + (['--layer_norm'] if layer_norm else [])
    cfg, _, model = port_proposal_generator(seed=3, argv=argv)
    tckpt.save_checkpoint(str(tmp_path), model,
                          {'config': cfg.to_dict(), 'epoch': 0},
                          name='best_prop_model')
    _, _, params = jckpt.load_prop_checkpoint(str(tmp_path))
    assert_params_equal(model, params)
    np.testing.assert_array_equal(np.asarray(params['anchors_V']), ANCHORS_V)


def test_load_errors_name_the_fault(tmp_path, vocab_csv):
    '''A shape that does not fit, arrays the template lacks, and a template
    key the archive lacks all raise at load time.'''
    itos = vocab_csv[1].itos
    cfg, _, model = port_captioner(len(itos))
    tckpt.save_checkpoint(str(tmp_path), model, {'config': cfg.to_dict()})
    wider = BiModalTransformer(
        dataclasses.replace(model.dims, d_model_C=14, d_ff_C=56),
        device='cpu')
    with pytest.raises(ValueError, match='does not fit'):
        tckpt.load_checkpoint(str(tmp_path), wider)
    plain = BiModalTransformer(
        dataclasses.replace(model.dims, use_linear_embedder=False),
        device='cpu')
    with pytest.raises(KeyError, match='emb_A'):       # extra arrays
        tckpt.load_model_params(str(tmp_path), 'best_cap_model', plain)
    npz = str(tmp_path / 'best_cap_model.params.npz')
    tree = to_jax_tree(model)
    with pytest.raises(KeyError, match='absent from the restore template'):
        tckpt.load_pytree_npz(npz, {'emb_C': tree['emb_C']})
    with pytest.raises(ValueError, match="'generator/w'"):
        bad = dict(tree, generator={'w': np.zeros((2, 2)), 'b': tree[
            'generator']['b']})
        tckpt.load_pytree_npz(npz, bad)
    with pytest.raises(KeyError):                        # missing arrays
        tckpt.load_pytree_npz(npz, dict(tree, extra=np.zeros(3)))
    got = tckpt.load_pytree_npz(npz, tree)
    np.testing.assert_array_equal(got['generator']['w'],
                                  tree['generator']['w'])


def test_load_subtree_and_pretrained_encoder_match_jax(tmp_path):
    '''The encoder of a full archive, as a bare npz and from both stages'
    directories, and of a LoRA-finetuned JAX archive (the adapters folded
    into the base weights), equals what the JAX package restores.'''
    jdims = JaxCapDims(voc_size=11, d_model_A=8, d_model_V=12, d_model_C=10,
                       d_model=16, H=2, N=2, d_ff_A=16, d_ff_V=24, d_ff_C=20)
    params = init_bimodal_transformer(jax.random.PRNGKey(7), jdims)
    cap_dir = tmp_path / 'cap'
    jckpt.save_checkpoint(str(cap_dir), params, {'config': {}})
    jckpt.save_checkpoint(str(cap_dir), params, {'config': {}},
                          name='best_prop_model')
    tpl = jax.tree.map(np.zeros_like, params['encoder'])
    forms = [(str(cap_dir), 'cap'), (str(cap_dir), 'prop'),
             (str(cap_dir / 'best_cap_model.params.npz'), 'cap')]
    for path, stage in forms:
        got = tckpt.load_pretrained_encoder_native(path, tpl, stage)
        want = jckpt.load_pretrained_encoder_native(path, tpl, stage)
        jax.tree.map(np.testing.assert_array_equal, got,
                     jax.tree.map(np.asarray, want))
    with pytest.raises(KeyError, match='no arrays under'):
        tckpt.load_subtree_npz(forms[2][0], tpl, subtree='nonexistent')

    lora = add_lora(params, 2, jax.random.PRNGKey(1), targets='attn_ffn')
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 if getattr(p[-1], 'key', None) == 'lora_b'
                      else x), lora)
    npz = str(tmp_path / 'lora.npz')
    jckpt.save_pytree_npz(npz, lora)
    got = tckpt.load_subtree_npz(npz, tpl)
    want = jckpt.load_subtree_npz(npz, tpl)
    jax.tree.map(np.testing.assert_array_equal, got,
                 jax.tree.map(np.asarray, want))
    assert not np.array_equal(
        got['layers'][0]['self_att_M1']['q2d']['w'],
        np.asarray(params['encoder']['layers'][0]['self_att_M1']['q2d']['w']))


def test_orbax_only_directory_raises_naming_npz(tmp_path):
    (tmp_path / 'best_cap_model.orbax').mkdir()
    (tmp_path / 'best_cap_model.orbax.meta.json').write_text('{}')
    (tmp_path / 'best_prop_model.orbax').mkdir()
    for call in (lambda: tckpt.load_cap_checkpoint(str(tmp_path),
                                                   device='cpu'),
                 lambda: tckpt.load_prop_checkpoint(str(tmp_path),
                                                    device='cpu'),
                 lambda: tckpt.load_checkpoint(str(tmp_path), None),
                 lambda: tckpt.load_pretrained_encoder_native(
                     str(tmp_path), {}, 'prop')):
        with pytest.raises(ValueError, match='npz'):
            call()
    assert not tckpt.checkpoint_exists(str(tmp_path), 'best_cap_model')
    with pytest.raises(FileNotFoundError):
        tckpt.read_checkpoint_meta(str(tmp_path), 'last_cap_model')


# ---------------------------------------------------------------------------
# optimizer resume, async writer, meta
# ---------------------------------------------------------------------------

def _train(model, opt, steps, src, caps):
    tsrc, tcaps = to_torch(src), torch.from_numpy(caps)
    masks = make_masks(tsrc, tcaps, 'audio_video', PAD)
    for _ in range(steps):
        opt.zero_grad()
        model(tsrc, tcaps, masks).mean().neg().backward()
        opt.step()


@pytest.mark.parametrize('cfg', [ADAM, SGD], ids=['adam', 'sgd'])
def test_optimizer_resume_is_bit_exact(tmp_path, cfg):
    '''2 steps, save, load into fresh objects, 1 step == 3 straight steps,
    bit for bit (parameters, optimizer state and counters).'''
    def fresh(seed):
        _, dims, model = port_captioner(23, seed=seed)
        frozen = (lambda path: path[0] == 'generator')   # a frozen part
        return model, build_optimizer(cfg, model, frozen=frozen)
    src, caps = cap_inputs(port_captioner(23)[1], seed=4)
    straight, opt = fresh(0)
    _train(straight, opt, 3, src, caps)

    model, opt = fresh(0)
    _train(model, opt, 2, src, caps)
    tckpt.save_checkpoint(str(tmp_path), model, {'step': 2}, opt,
                          name='last_cap_model')
    assert os.path.exists(tmp_path / 'last_cap_model.torch_opt.npz')
    resumed, opt2 = fresh(5)
    _, meta, got = tckpt.load_checkpoint(str(tmp_path), resumed, opt2,
                                         name='last_cap_model')
    assert got is opt2 and meta == {'step': 2} and opt2.count == 2
    _train(resumed, opt2, 1, src, caps)
    for (name, a), b in zip(straight.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), name
    assert opt2.count == opt.count + 1 == 3
    # the frozen generator carries no state, the others all of it
    flat = tckpt.optimizer_state_tree(resumed, opt2)
    assert not any('generator' in k for k in flat)
    keys = {'adam': ('exp_avg', 'exp_avg_sq', 'step'),
            'sgd': ('momentum_buffer',)}[cfg.optimizer]
    assert {k.split('/')[1] for k in flat if k.startswith('state/')} == set(
        keys)


def test_optimizer_state_of_no_parameter_raises(tmp_path):
    _, _, model = port_captioner(23)
    opt = build_optimizer(ADAM, model)
    flat = {'count': 0, 'lr': 0.1, 'notfinite': 0,
            'state/exp_avg/no/such/path': np.zeros(3)}
    with pytest.raises(KeyError, match='no trainable parameter'):
        tckpt.load_optimizer_state(model, opt, flat)


def test_bf16_module_saves_fp32_arrays(tmp_path):
    '''np.savez cannot write bf16: a bf16 module's arrays are saved fp32
    (lossless) and load back to the same bf16 values.'''
    _, dims, model = port_captioner(23)
    model = model.to(torch.bfloat16)
    tckpt.save_checkpoint(str(tmp_path), model, {})
    with np.load(tmp_path / 'best_cap_model.params.npz') as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float32)}
    back = BiModalTransformer(dims, device='cpu').to(torch.bfloat16)
    tckpt.load_checkpoint(str(tmp_path), back)
    for a, b in zip(model.parameters(), back.parameters()):
        assert torch.equal(a, b)


def test_async_writer_matches_sync(tmp_path):
    '''The background writer gives the same restore as the synchronous
    save; the snapshot is taken at submit, so changing the live model and
    optimizer afterwards does not leak into the file.'''
    _, _, model = port_captioner(23, seed=2)
    opt = build_optimizer(ADAM, model)
    src, caps = cap_inputs(model.dims, seed=1)
    _train(model, opt, 1, src, caps)
    meta = {'epoch': 3, 'step': 77}
    tckpt.save_checkpoint(str(tmp_path / 'sync'), model, meta, opt,
                          name='last_cap_model')
    w = tckpt.AsyncCheckpointWriter()
    w.save(str(tmp_path / 'async'), model, meta, opt, name='last_cap_model')
    _train(model, opt, 1, src, caps)          # moves params and state
    w.close()
    for name in ('last_cap_model.params.npz',
                 'last_cap_model.torch_opt.npz'):
        with np.load(tmp_path / 'sync' / name) as a, \
                np.load(tmp_path / 'async' / name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the meta records that the port's optimizer state sits beside it
    assert tckpt.read_checkpoint_meta(str(tmp_path / 'async'),
                                      'last_cap_model') == {**meta,
                                                            'torch_opt': True}


def test_async_writer_orders_saves(tmp_path):
    '''Two queued saves of one rolling name land in submit order.'''
    w = tckpt.AsyncCheckpointWriter()
    trees = [{'w': np.ones((4, 4))}, {'w': np.full((4, 4), 2.0)}]
    for i, tree in enumerate(trees):
        w.save(str(tmp_path), tree, {'epoch': i}, name='last_cap_model')
    w.close()
    p = tckpt.load_pytree_npz(str(tmp_path / 'last_cap_model.params.npz'),
                              trees[0])
    np.testing.assert_array_equal(p['w'], trees[1]['w'])
    assert tckpt.read_checkpoint_meta(str(tmp_path),
                                      'last_cap_model')['epoch'] == 1


def test_async_writer_propagates_errors(tmp_path):
    def broken_save(*a, **k):
        raise OSError('disk full')

    w = tckpt.AsyncCheckpointWriter(broken_save)
    w.save(str(tmp_path), {'w': np.ones(3)}, {}, name='x')
    with pytest.raises(OSError, match='disk full'):
        w.wait()


def test_meta_rejects_what_json_cannot_hold(tmp_path):
    assert tckpt._json_meta_default(np.arange(3)) == [0, 1, 2]
    assert tckpt._json_meta_default(np.float32(1.5)) == 1.5
    assert tckpt._json_meta_default(torch.tensor([1.0, 2.0])) == [1.0, 2.0]
    assert tckpt._json_meta_default(torch.tensor(3)) == 3
    with pytest.raises(TypeError):
        tckpt._json_meta_default(object())
    with pytest.raises(TypeError, match='not JSON-serializable'):
        tckpt.save_checkpoint(str(tmp_path), {'w': np.ones(2)},
                              {'bad': object()})
    assert not os.path.exists(tmp_path / 'best_cap_model.meta.json')


# ---------------------------------------------------------------------------
# the reference .pt bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('with_config_pickle', [True, False])
def test_reference_pt_imports_with_the_torch_modules_own_log_probs(
        tmp_path, with_config_pickle):
    '''A checkpoint that real torch code wrote in the reference's key
    layout (DataParallel prefix, pickled Config) imports into the port's
    module with the reference modules' own log-probs.'''
    torch.manual_seed(11)
    ref = RefCaptioner(REF_DIMS, d_aud=4, d_vid=5).eval()
    path = str(tmp_path / 'best_cap_model.pt')
    save_reference_style(path, ref, with_config_pickle)
    cpt = tckpt.load_torch_checkpoint(path)
    assert cpt['epoch'] == 26 and cpt['trg_voc_size'] == REF_DIMS.voc_size
    if with_config_pickle:
        assert cpt['config'] == {'d_model': REF_DIMS.d_model,
                                 'modality': 'audio_video'}
    params, _ = tckpt.import_cap_model(cpt)
    model = BiModalTransformer(CapModelDims(**dataclasses.asdict(REF_DIMS)),
                               device='cpu').eval()
    load_jax_params(model, params)
    src, trg = ref_inputs(np.random.default_rng(0))
    masks = j_make_masks(to_jax(src), jnp.asarray(trg), 'audio_video', 1)
    with torch.no_grad():
        want = ref(src, trg, masks).numpy()
    np.testing.assert_allclose(port_log_probs(model, src, trg), want, **TOL)


@pytest.mark.parametrize('glove', [False, True])
def test_cap_export_equals_jax_key_for_key(glove):
    _, dims, model = port_captioner(19, glove, seed=6)
    got = tckpt.export_cap_state_dict(model)
    want = jckpt.export_cap_state_dict(to_jax_tree(model))
    assert got.keys() == want.keys()
    assert all(k.startswith('module.') for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tckpt.export_cap_state_dict(model, data_parallel=False).keys() == \
        jckpt.export_cap_state_dict(to_jax_tree(model),
                                    data_parallel=False).keys()


@pytest.mark.parametrize('layer_norm', [False, True])
@pytest.mark.parametrize('dout_p', [0.1, 0.0])
def test_prop_export_equals_jax_and_loads_strict(layer_norm, dout_p):
    '''The export equals JAX's key for key, bit-exact, and loads strictly
    into the reference-layout modules (Sequential indices around
    Transpose/Dropout/ReLU).'''
    argv = PROP_ARGV + (['--layer_norm'] if layer_norm else [])
    _, dims, model = port_proposal_generator(seed=4, argv=argv)
    got = tckpt.export_prop_state_dict(model, dout_p=dout_p > 0)
    want = jckpt.export_prop_state_dict(to_jax_tree(model),
                                        dout_p=dout_p > 0)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mirror = MultimodalPropMirror(JaxPropDims(**{
        f.name: getattr(dims, f.name)
        for f in dataclasses.fields(JaxPropDims)}), dout_p)
    mirror.load_state_dict({k: torch.from_numpy(v) for k, v in got.items()},
                           strict=True)


def test_pt_vocab_drift_raises(tmp_path, vocab_csv):
    meta_path, vocab = vocab_csv
    cfg, _, model = port_captioner(len(vocab) + 3)
    pt = str(tmp_path / 'best_cap_model.pt')
    tckpt.save_torch_checkpoint(pt, model, {'config': cfg.to_dict(),
                                            'trg_voc_size': len(vocab) + 3})
    with pytest.raises(ValueError, match='allow_vocab_drift'):
        tckpt.load_cap_checkpoint(pt, meta_path, device='cpu')
    _, dims, _, _ = tckpt.load_cap_checkpoint(pt, meta_path, True,
                                              device='cpu')
    assert dims.voc_size == len(vocab) + 3
    with pytest.raises(ValueError, match='train_meta_path'):
        tckpt.load_cap_checkpoint(pt, device='cpu')


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('glove', [False, True])
def test_cap_pt_saved_by_one_package_loads_in_the_other(tmp_path, vocab_csv,
                                                        writer, glove):
    '''Both packages install a shim for the pickled Config in one process:
    each save and load installs its own right before, so the order does not
    matter.'''
    meta_path, vocab = vocab_csv
    cfg, dims, model = port_captioner(len(vocab), glove, seed=8)
    meta = {'config': cfg.to_dict(), 'epoch': 4, 'trg_voc_size': len(vocab)}
    pt = str(tmp_path / 'best_cap_model.pt')
    if writer == 'port':
        tckpt.save_torch_checkpoint(pt, model, meta)
        jcfg, _, params, jvocab = jckpt.load_cap_checkpoint(pt, meta_path)
        assert jvocab.itos == vocab.itos and jcfg.d_model == cfg.d_model
        assert_params_equal(model, params)
    else:
        jckpt.save_torch_checkpoint(pt, to_jax_tree(model), meta)
        pcfg, pdims, loaded, pvocab = tckpt.load_cap_checkpoint(
            pt, meta_path, device='cpu')
        assert pvocab.itos == vocab.itos and pdims == dims
        for a, b in zip(model.parameters(), loaded.parameters()):
            assert torch.equal(a, b)
    assert tckpt.load_torch_checkpoint(pt)['epoch'] == 4


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_prop_pt_saved_by_one_package_loads_in_the_other(tmp_path, writer):
    cfg, _, model = port_proposal_generator(seed=9)
    meta = {'config': cfg.to_dict(), 'epoch': 7, 'best_metric': 0.5}
    pt = str(tmp_path / 'best_prop_model.pt')
    if writer == 'port':
        tckpt.save_torch_prop_checkpoint(pt, model, meta)
        jcfg, _, params = jckpt.load_prop_checkpoint(pt, 9)
        assert jcfg.max_prop_per_vid == 9
        assert_params_equal(model, params)
    else:
        jckpt.save_torch_prop_checkpoint(pt, to_jax_tree(model), meta)
        pcfg, _, loaded = tckpt.load_prop_checkpoint(pt, 9, device='cpu')
        assert pcfg.max_prop_per_vid == 9
        for a, b in zip(model.parameters(), loaded.parameters()):
            assert torch.equal(a, b)
    cpt = tckpt.load_torch_checkpoint(pt)
    assert cpt['anchors'] == {'audio': ANCHORS_A, 'video': ANCHORS_V}


def test_lora_trees_and_configs_raise(tmp_path, vocab_csv):
    '''LoRA archives: an export of a tree with adapters folds them into the
    weights, as the JAX export does; a native checkpoint of a LoRA finetune
    (config lora_rank) loads with its adapters; as the seed of a new run
    (``load_pretrained_cap_params``) it gives the JAX package's seed, its
    adapters folded into the weights; and a trainer config with lora_rank
    passes the port's model check.'''
    jdims = JaxCapDims(voc_size=11, d_model_A=8, d_model_V=12, d_model_C=10,
                       d_model=16, H=2, N=1, d_ff_A=16, d_ff_V=24, d_ff_C=20)
    lora = add_lora(init_bimodal_transformer(jax.random.PRNGKey(0), jdims), 2,
                    jax.random.PRNGKey(1))
    lora = jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 if getattr(p[-1], 'key', None) == 'lora_b'
                      else x), lora))
    got = tckpt.export_cap_state_dict(lora)
    want = jckpt.export_cap_state_dict(lora)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-6, rtol=0, err_msg=key)
    cfg, _, model = port_captioner(len(vocab_csv[1]))
    port_lora.add_lora(model, 2, torch.Generator().manual_seed(3))
    d = dict(cfg.to_dict(), lora_rank=2)
    tckpt.save_checkpoint(str(tmp_path), model,
                          {'config': d, 'vocab_itos': vocab_csv[1].itos})
    _, _, loaded, _ = tckpt.load_cap_checkpoint(str(tmp_path), device='cpu')
    assert port_lora.count_lora(loaded) == port_lora.count_lora(model)
    jax.tree.map(np.testing.assert_array_equal, to_jax_tree(loaded),
                 to_jax_tree(model))
    seeded = port_captioner(len(vocab_csv[1]))[2]
    tckpt.load_pretrained_cap_params(str(tmp_path), seeded)
    assert port_lora.count_lora(seeded) == (0, 0)
    want = jckpt.load_pretrained_cap_params(str(tmp_path),
                                            to_jax_tree(seeded))
    jax.tree.map(np.testing.assert_array_equal, to_jax_tree(seeded),
                 jax.tree.map(np.asarray, want))
    merged = to_jax_tree(port_lora.merge_lora(loaded))
    jax.tree.map(np.testing.assert_array_equal, to_jax_tree(seeded), merged)
    check_model_ported(port_config.Config.from_dict(d))


def test_unimodal_checkpoints_raise(tmp_path, vocab_csv):
    '''The uni-modal checkpoints load: a native directory of either
    modality builds the uni-modal model of its config (the reference .pt
    import is held to JAX's in tests/test_torch_port_unimodal.py). What no
    model is built for still raises: an unknown modality, and the .pt
    export of a uni-modal captioner (bi-modal only, as in JAX).'''
    from bmt_tpu_torch.models import UniModalTransformer
    cfg, _, _ = port_captioner(len(vocab_csv[1]))
    for modality in ('audio', 'video'):
        d = dict(cfg.to_dict(), modality=modality)
        dims = CapModelDims.from_config(
            port_config.Config.from_dict(d), len(vocab_csv[1]))
        uni = UniModalTransformer(dims, device='cpu',
                                  generator=torch.Generator().manual_seed(1))
        tckpt.save_checkpoint(str(tmp_path / modality), uni, {
            'config': d, 'vocab_itos': vocab_csv[1].itos})
        _, got_dims, got, _ = tckpt.load_cap_checkpoint(
            str(tmp_path / modality), device='cpu')
        assert isinstance(got, UniModalTransformer)
        assert got_dims == dims
        jax.tree.map(np.testing.assert_array_equal, to_jax_tree(got),
                     to_jax_tree(uni))
        with pytest.raises(ValueError, match='bi-modal'):
            tckpt.save_torch_checkpoint(str(tmp_path / 'uni.pt'), got, {})
    with pytest.raises(ValueError, match='modality'):
        check_model_ported(port_config.Config.from_dict(
            dict(cfg.to_dict(), modality='subs_audio_video')))


def test_loaders_build_on_the_card_unless_asked(tmp_path, vocab_csv,
                                                monkeypatch):
    cfg, _, model = port_captioner(len(vocab_csv[1]))
    tckpt.save_checkpoint(str(tmp_path), model,
                          {'config': cfg.to_dict(),
                           'vocab_itos': vocab_csv[1].itos})
    pcfg, _, prop = port_proposal_generator()
    tckpt.save_checkpoint(str(tmp_path), prop, {'config': pcfg.to_dict()},
                          name='best_prop_model')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tckpt.load_cap_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tckpt.load_prop_checkpoint(str(tmp_path))
    _, _, loaded, _ = tckpt.load_cap_checkpoint(str(tmp_path), device='cpu')
    assert next(loaded.parameters()).device.type == 'cpu'
