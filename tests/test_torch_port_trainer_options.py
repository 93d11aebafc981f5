'''main.py's model and decode options in the port's trainer and evaluation,
held to the JAX package on the CPU at tiny widths (``tests/torch_port_tree``):
the bf16 Adam first moment against optax; train_cap through both packages
from one npz checkpoint with LoRA adapters (``--lora_rank 2 --lora_targets
attn_ffn``) and with MoE FFNs and a bf16 first moment (``--moe_experts 4
--optim_mu_dtype bfloat16``); evaluate through both packages with beam
search, the int8 cross K/V and int8 weights; sampling with top-k 1 against
greedy decoding.

Tolerances: the optimizer's parameters 1e-6 and its first moment one bf16
ulp; the two trainers' validation losses 1e-4 and their weights 4 lr, as in
``test_torch_port_trainers.py``; captions equal.
'''
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.config import Config, build_parser
from bmt_tpu_torch.params import named_jax_parameters
from bmt_tpu_torch.train import optim as toptim
from bmt_tpu_torch.train.checkpoint import load_lora_sites, save_checkpoint
from tests.torch_port_tree import mini_argv, mini_tree

torch.set_num_threads(1)

LR = 5e-5                      # build_parser()'s --lr


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return mini_tree(tmp_path_factory.mktemp('optiontree'))


def _npz(path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def _meta(path):
    with open(path) as f:
        return json.load(f)


def _jax_cfg(argv):
    from bmt_tpu.config import Config as JConfig
    from bmt_tpu.config import build_parser as j_build_parser
    return JConfig(j_build_parser().parse_args(argv))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('weight_decay,grad_clip', [(0.0, None), (0.1, 0.5)])
def test_bf16_first_moment_adam_matches_optax(weight_decay, grad_clip):
    '''Three updates with the same gradients through ``build_optimizer``
    with ``optim_mu_dtype='bfloat16'`` in both packages: the parameters
    within 1e-6, the stored first moment bf16 and within one bf16 ulp of
    optax's, the second moment fp32.'''
    import optax

    from bmt_tpu.train import optim as joptim
    from tests.test_torch_port_train import _cfg, _Toy
    rng = np.random.default_rng(0)
    model = _Toy(rng)
    cfg = _cfg(optim_mu_dtype='bfloat16', weight_decay=weight_decay,
               grad_clip=grad_clip)
    tree = {'emb': {'table': jnp.asarray(model.emb.table.detach().numpy())},
            'lin': {'w': jnp.asarray(model.lin.weight.detach().numpy().T),
                    'b': jnp.asarray(model.lin.bias.detach().numpy())}}
    jopt = joptim.build_optimizer(cfg)
    jstate = jopt.init(tree)
    opt = toptim.build_optimizer(cfg, model)
    assert isinstance(opt.inner, toptim.OptaxAdam)
    for _ in range(3):
        grads = {path: rng.normal(size=p.shape).astype(np.float32) * 2
                 for path, p in named_jax_parameters(model)}
        jgrads = {'emb': {'table': grads[('emb', 'table')]},
                  'lin': {'w': grads[('lin', 'w')].T,
                          'b': grads[('lin', 'b')]}}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, jgrads),
                                      jstate, tree)
        tree = jax.tree.map(lambda p, u: p + u, tree, updates)
        for path, p in named_jax_parameters(model):
            p.grad = torch.from_numpy(grads[path])
        opt.step()
    mu = optax.tree_utils.tree_get(jstate, 'mu')
    for path, p in named_jax_parameters(model):
        want_p, want_mu = tree, mu
        for k in path:
            want_p, want_mu = want_p[k], want_mu[k]
        state = opt.inner.state[p]
        assert state['exp_avg'].dtype == torch.bfloat16
        assert state['exp_avg_sq'].dtype == torch.float32
        got_p = p.detach().numpy()
        got_mu = state['exp_avg'].float().numpy()
        if path[-1] == 'w':
            got_p, got_mu = got_p.T, got_mu.T
        np.testing.assert_allclose(got_p, np.asarray(want_p), atol=1e-6,
                                   err_msg=str(path))
        want_mu = np.asarray(want_mu.astype(jnp.float32))
        ulp = np.spacing(np.abs(want_mu).astype(np.float32)) * 2 ** 16
        assert (np.abs(got_mu - want_mu) <= ulp).all(), path


def test_lora_optimizer_keeps_state_for_the_adapters_only():
    '''With the LoRA freeze predicate the optimizer holds the adapters'
    A and B alone; after a step only they have Adam state and moved.'''
    from bmt_tpu_torch.models import BiModalTransformer
    from bmt_tpu_torch.ops.lora import add_lora, lora_frozen_predicate
    from tests.torch_port_util import dims_pair
    _, dims = dims_pair()
    g = torch.Generator().manual_seed(0)
    model = BiModalTransformer(dims, device='cpu', generator=g)
    add_lora(model, 2, g, targets='attn_ffn')
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = toptim.build_optimizer(types.SimpleNamespace(
        optimizer='adam', lr=1e-2, grad_clip=1.0), model,
        frozen=lora_frozen_predicate)
    adapters = [p for path, p in named_jax_parameters(model)
                if path[-1] in ('lora_a', 'lora_b')]
    # a layer's attn_ffn sites: encoder 4 x 4 attention + 2 x 2 FFN,
    # decoder 3 x 4 + 2
    assert len(adapters) == 2 * (20 + 14) * dims.N
    assert {id(p) for p in opt.params} == {id(p) for p in adapters}
    for p in adapters:
        p.grad = torch.ones_like(p)
    opt.step()
    assert set(opt.inner.state) == set(adapters)
    for n, p in model.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved == n.endswith(('lora_a', 'lora_b')), n


@pytest.mark.parametrize('flags,what', [
    ({'sp_devices': 2, 'fsdp': None, 'modality': 'audio_video'}, None),
    ({'fsdp': None, 'ep_devices': 2}, None),
    ({'ckpt_format': 'orbax'}, 'item 12')])
def test_only_unimodal_parallelism_and_orbax_still_raise(tree, tmp_path,
                                                         flags, what):
    '''The options this port runs pass ``check_ported``, the uni-modal
    models and the data, sequence and expert parallelism and --fsdp among
    them, alone and together (--fsdp with the procedure's sequence or
    expert axis); orbax raises, naming its ROADMAP item.'''
    from bmt_tpu_torch.train.options import check_ported
    ported = dict(lora_rank=2, moe_experts=4, kv_cache_int8=None,
                  weights_int8=None, decode_strategy='beam',
                  optim_mu_dtype='bfloat16', modality='audio', dp_devices=2,
                  ep_devices=2, sp_devices=2)
    check_ported(Config(build_parser().parse_args(
        mini_argv(tree, tmp_path, 'train_cap', **ported))))
    check_ported(Config(build_parser().parse_args(
        mini_argv(tree, tmp_path, 'train_prop', fsdp=None, dp_devices=2))))
    procedure = 'train_prop' if 'sp_devices' in flags else 'train_cap'
    cfg = Config(build_parser().parse_args(
        mini_argv(tree, tmp_path, procedure, **flags)))
    if what is None:
        check_ported(cfg)
    else:
        with pytest.raises(NotImplementedError, match=what):
            check_ported(cfg)


# ---------------------------------------------------------------------------
# the two packages' train_cap from one checkpoint
# ---------------------------------------------------------------------------

RUNS = {
    'lora': dict(lora_rank=2, lora_targets='attn_ffn'),
    'moe': dict(moe_experts=4, optim_mu_dtype='bfloat16'),
}


def _seed_tree(kind, jcfg, vocab):
    '''JAX-initialised weights for the run: with LoRA, adapters added by
    the JAX package and their B moved off zero (so that A and B both
    train).'''
    from bmt_tpu.models import CapModelDims, init_bimodal_transformer
    from bmt_tpu.ops.lora import add_lora
    params = init_bimodal_transformer(
        jax.random.PRNGKey(1), CapModelDims.from_config(jcfg, len(vocab)))
    if kind == 'lora':
        params = add_lora(params, 2, jax.random.PRNGKey(2), None, 'attn_ffn')
    tree_np = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.05 * rng.standard_normal(x.shape).astype(
            np.float32) if getattr(p[-1], 'key', None) == 'lora_b' else x),
        tree_np)


@pytest.fixture(scope='module', params=list(RUNS))
def two_runs(request, tree, tmp_path_factory):
    '''One epoch of each package's train_cap with the run's options (fp32,
    dropout 0), both resumed from one npz checkpoint of JAX-initialised
    weights. Returns (kind, {package: run directory}, the seed's flat
    arrays).'''
    from bmt_tpu.data.captioning import CaptioningDataset
    from bmt_tpu.train.cap_trainer import train_cap as j_train_cap
    from bmt_tpu_torch.params import _flatten
    from bmt_tpu_torch.train.cap_trainer import train_cap

    kind = request.param
    root = tmp_path_factory.mktemp(f'two_runs_{kind}')
    cwd = os.getcwd()
    os.chdir(root)
    try:
        argv = {pkg: mini_argv(tree, root / pkg, 'train_cap', dout_p=0,
                               exper_name='run', **RUNS[kind])
                for pkg in ('jax', 'port')}
        jcfg = _jax_cfg(argv['jax'])
        vocab = CaptioningDataset(jcfg, 'train').train_vocab
        seed = _seed_tree(kind, jcfg, vocab)
        meta = {'epoch': -1, 'step': 0, 'vocab_itos': vocab.itos}
        for pkg in ('jax', 'port'):
            save_checkpoint(str(root / pkg / 'train_cap' / 'run'), seed,
                            meta, None, 'last_cap_model')
        j_train_cap(jcfg)
        train_cap(Config(build_parser().parse_args(argv['port'])), 'cpu')
    finally:
        os.chdir(cwd)
    return kind, {pkg: root / pkg / 'train_cap' / 'run'
                  for pkg in ('jax', 'port')}, _flatten(seed)


def test_both_packages_train_cap_alike_with_the_option(two_runs):
    '''The checks of ``test_both_packages_train_cap_alike_from_one_
    checkpoint``: 4 steps, the same validation losses within 1e-4, the
    same captions, the weights within 4 lr (4 Adam steps).'''
    kind, runs, _ = two_runs
    jax_meta = _meta(runs['jax'] / 'last_cap_model.meta.json')
    port_meta = _meta(runs['port'] / 'last_cap_model.meta.json')
    assert jax_meta['step'] == port_meta['step'] == 4
    for flag, value in RUNS[kind].items():
        assert port_meta['config'][flag] == jax_meta['config'][flag] == value
    for key in ('val_1_loss', 'val_2_loss'):
        assert abs(port_meta[key] - jax_meta[key]) <= 1e-4, key
    for phase in ('val_1', 'val_2'):
        name = f'captioning_results_{phase}_e0.json'
        assert _meta(runs['port'] / name) == _meta(runs['jax'] / name)
    jw = _npz(runs['jax'] / 'last_cap_model.params.npz')
    pw = _npz(runs['port'] / 'last_cap_model.params.npz')
    assert jw.keys() == pw.keys()
    for k in jw:
        np.testing.assert_allclose(pw[k], jw[k], atol=4 * LR, err_msg=k)


def test_lora_run_trains_the_adapters_alone(two_runs):
    '''LoRA: in both packages every base leaf is bit for bit the seed's and
    every adapter's A and B moved; each package's best_cap_model.lora.npz
    holds the adapters and loads in the other; the port's optimizer state
    is the adapters'. MoE: the experts and routers moved, the first moment
    was saved in bf16 and reads back so.'''
    kind, runs, seed = two_runs
    for pkg, run in runs.items():
        got = _npz(run / 'last_cap_model.params.npz')
        assert got.keys() == seed.keys()
        for k, v in seed.items():
            leaf = k.rsplit('/', 1)[-1]
            if kind == 'lora' and leaf not in ('lora_a', 'lora_b'):
                np.testing.assert_array_equal(got[k], v, err_msg=(pkg, k))
            elif leaf in ('lora_a', 'lora_b', 'w1', 'w2') or \
                    k.endswith('router/w'):
                assert not np.array_equal(got[k], v), (pkg, k)
    # one optimizer file for both packages: the port's has the JAX run's
    # arrays (key, shape, dtype)
    opt = _npz(runs['port'] / 'last_cap_model.opt.npz')
    jopt = _npz(runs['jax'] / 'last_cap_model.opt.npz')
    assert {k: (v.shape, v.dtype) for k, v in opt.items()} == {
        k: (v.shape, v.dtype) for k, v in jopt.items()}
    adam = [k[:-2] for k, v in opt.items() if k.endswith('/0')
            and v.ndim == 0 and any(j.startswith(k[:-2] + '/1/')
                                    for j in opt)]
    assert len(adam) == 1
    state = [k for k in opt if k.startswith(adam[0] + '/')
             and opt[k].ndim]
    if kind == 'lora':
        assert state and all(k.rsplit('/', 1)[-1] in ('lora_a', 'lora_b')
                             for k in state)
        from bmt_tpu.train.checkpoint import load_lora_sites as j_sites
        for pkg, run in runs.items():
            path = str(run / 'best_cap_model.lora.npz')
            mine = load_lora_sites(path)
            theirs = j_sites(path)
            assert mine.keys() == theirs.keys() and len(mine) == 20 + 14
            for site in mine:
                for leaf in ('lora_a', 'lora_b', 'lora_s'):
                    np.testing.assert_array_equal(mine[site][leaf],
                                                  theirs[site][leaf])
    else:
        mu = [k for k in state if k.startswith(adam[0] + '/1/')]
        bf16 = {k: opt[k] for k in mu}
        assert bf16 and all(np.array_equal(
            v, v.astype(jnp.bfloat16).astype(np.float32))
            for v in bf16.values())


def test_port_lora_run_resumes_with_its_adapters(two_runs, tree, tmp_path,
                                                 monkeypatch):
    '''The port's LoRA (or MoE) run directory resumes in the port for a
    second epoch: the adapters and the optimizer state load back, and the
    base weights stay the seed's.'''
    kind, runs, seed = two_runs
    monkeypatch.chdir(tmp_path)
    run = tmp_path / 'log' / 'train_cap' / 'run'
    shutil.copytree(runs['port'], run)
    cli.main(mini_argv(tree, tmp_path / 'log', 'train_cap', dout_p=0,
                       exper_name='run', epoch_num=2, device='cpu',
                       **RUNS[kind]))
    meta = _meta(run / 'last_cap_model.meta.json')
    assert meta['epoch'] == 1 and meta['step'] == 8
    with np.load(run / 'last_cap_model.opt.npz') as z:
        assert int(z['0']) == 8           # the update count, resumed at 4
    first = _npz(runs['port'] / 'last_cap_model.params.npz')
    got = _npz(run / 'last_cap_model.params.npz')
    for k, v in seed.items():
        if kind == 'lora' and k.rsplit('/', 1)[-1] not in ('lora_a',
                                                           'lora_b'):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        elif k.endswith(('lora_b', 'experts/w1')):
            assert not np.array_equal(got[k], first[k]), k


# ---------------------------------------------------------------------------
# evaluate through both packages
# ---------------------------------------------------------------------------

def _proposals(tree, path):
    '''A learned-proposals JSON over val_1's videos: each event's span and
    one shifted by a second.'''
    with open(tree / 'val_1.json') as f:
        val = json.load(f)
    results = {vid: [{'timestamp': [s + d, e + d], 'score': 1.0}
                     for s, e in v['timestamps'] for d in (0.0, 1.0)]
               for vid, v in val.items()}
    with open(path, 'w') as f:
        json.dump({'results': results}, f)
    return path


@pytest.fixture(scope='module')
def moe_checkpoint(tree, tmp_path_factory):
    '''A best_cap_model npz directory of a JAX-initialised MoE captioner
    (E=4) with its config, and a proposals JSON.'''
    from bmt_tpu.data.captioning import CaptioningDataset
    from bmt_tpu.models import CapModelDims, init_bimodal_transformer
    root = tmp_path_factory.mktemp('moe_ckpt')
    jcfg = _jax_cfg(mini_argv(tree, root, 'train_cap', moe_experts=4))
    vocab = CaptioningDataset(jcfg, 'train').train_vocab
    params = init_bimodal_transformer(
        jax.random.PRNGKey(4), CapModelDims.from_config(jcfg, len(vocab)))
    save_checkpoint(str(root / 'ckpt'), jax.tree.map(np.asarray, params),
                    {'config': jcfg.to_dict(), 'epoch': 0,
                     'vocab_itos': vocab.itos})
    return root / 'ckpt', _proposals(tree, root / 'props.json')


def _evaluate(pkg, tree, ckpt, props, tmp_path, **flags):
    '''The package's evaluate on a copy of ``ckpt``; returns its
    submission's results.'''
    dst = tmp_path / f'{pkg}_ckpt'
    shutil.copytree(ckpt, dst)
    argv = mini_argv(tree, tmp_path / 'log', 'evaluate',
                     pretrained_cap_model_path=dst, prop_pred_path=props,
                     **flags)
    if pkg == 'jax':
        from bmt_tpu.scripts.eval_on_learned_props import \
            eval_on_learned_props
        metrics = eval_on_learned_props(_jax_cfg(argv))
    else:
        metrics = cli.main(argv + ['--device', 'cpu'])
    assert list(metrics) == [0.3, 0.5, 0.7, 0.9, 'Average across tIoUs']
    return _meta(dst / 'captioning_results_learned_props_e0.json')['results']


EVAL_CASES = {
    'beam2': dict(decode_strategy='beam', beam_size=2),
    'kv_int8': dict(kv_cache_int8=None),
    'weights_int8': dict(weights_int8=None),
}


@pytest.mark.parametrize('case', list(EVAL_CASES))
def test_both_packages_evaluate_alike_with_the_option(moe_checkpoint, tree,
                                                      tmp_path, monkeypatch,
                                                      case):
    '''evaluate of one MoE checkpoint through both packages with beam
    search (K=2), the int8 cross K/V or int8 weights: the same captions of
    every proposal.'''
    monkeypatch.chdir(tmp_path)
    ckpt, props = moe_checkpoint
    got = {pkg: _evaluate(pkg, tree, ckpt, props, tmp_path,
                          **EVAL_CASES[case]) for pkg in ('jax', 'port')}
    assert got['port'] == got['jax']
    assert sum(len(v) for v in got['port'].values()) >= 16


def test_sampling_with_top_k_1_equals_greedy(moe_checkpoint, tree, tmp_path,
                                             monkeypatch):
    '''``--decode_strategy sample --sample_top_k 1`` draws the argmax at
    every step: the port's captions equal its greedy ones and the JAX
    package's greedy ones. (Other draws come from a torch.Generator, not
    JAX's PRNG.)'''
    monkeypatch.chdir(tmp_path)
    ckpt, props = moe_checkpoint
    sampled = _evaluate('port', tree, ckpt, props, tmp_path / 's',
                        decode_strategy='sample', sample_top_k=1)
    greedy = _evaluate('port', tree, ckpt, props, tmp_path / 'g')
    assert sampled == greedy
    assert greedy == _evaluate('jax', tree, ckpt, props, tmp_path / 'j')
