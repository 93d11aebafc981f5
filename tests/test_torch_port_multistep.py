'''Multi-step dispatch in the PyTorch port (``train.steps.make_multistep``,
the twin of tests/test_multistep.py) on the CPU, at small widths with
inputs made with numpy from a seed: K steps bundled equal K single steps
bit for bit (parameters, Adam's moments and count, the EMA, the stacked
losses), with and without gradient accumulation and EMA, for the captioner
and the proposal generator; the same bundle equals JAX's
``jax.jit(make_multistep(step))`` in fp32 with dropout off; the epoch loops
bundle with a single-step tail and poll the guard between bundles as JAX's
do; the optimizer's device-held count, learning rate and bias corrections
are the host values they replace; and ``--steps_per_dispatch 2`` drives
both trainers on the CPU.

Tolerances against JAX are those of the CPU train-step parity
(tests/test_torch_port_train.py, tests/test_torch_port_proposal.py):
losses 2e-5 relative, parameters and EMA 2e-6 absolute (each port step
against each JAX step; a bundle adds no arithmetic of its own).'''
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.train import optim as joptim
from bmt_tpu.train import steps as jsteps
from bmt_tpu.train.loops import train_epoch_cap as j_train_epoch_cap
from bmt_tpu.train.loops import train_epoch_prop as j_train_epoch_prop
from bmt_tpu_torch import __main__ as cli
from bmt_tpu_torch.params import named_jax_parameters
from bmt_tpu_torch.train import optim as toptim
from bmt_tpu_torch.train import steps as tsteps
from bmt_tpu_torch.train.loops import train_epoch_cap, train_epoch_prop
from tests.test_torch_port_proposal import (jax_and_torch_generator,
                                            prop_batch, to_jax)
from tests.test_torch_port_train import STEP_CFG, _batch
from tests.torch_port_tree import mini_argv, mini_tree
from tests.torch_port_util import PAD, assert_tree_close, jax_and_torch_model

SMOOTHING = 0.7
K = 3
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-6


def _state_arrays(state) -> dict:
    '''Every tensor a step changes, as numpy: parameters, Adam's moments,
    the optimizer's counters, the EMA.'''
    out = {f'param/{n}': p.detach().numpy().copy()
           for n, p in state.model.named_parameters()}
    opt = state.optimizer
    for i, p in enumerate(opt.params):
        for k, v in opt.inner.state.get(p, {}).items():
            out[f'moment/{i}/{k}'] = v.float().numpy().copy()
    for i, t in enumerate(opt.device_state()):
        out[f'counter/{i}'] = t.numpy().copy()
    for n, e in (state.ema or {}).items():
        out[f'ema/{n}'] = e.numpy().copy()
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _cap(seed=3, dout_p=0.1, accum_steps=1, ema_decay=0.0):
    jdims, params, model = jax_and_torch_model(seed=seed, dout_p=dout_p)
    step = tsteps.make_cap_train_step(model.dims, SMOOTHING, PAD,
                                      accum_steps=accum_steps,
                                      ema_decay=ema_decay)
    state = tsteps.init_train_state(model, toptim.build_optimizer(STEP_CFG,
                                                                  model),
                                    seed=5, ema=bool(ema_decay))
    return jdims, params, state, step


CAP_CASES = {'plain': {}, 'accum2_ema': dict(accum_steps=2, ema_decay=0.9)}


def _stacked(batches):
    return jax.tree.map(lambda *xs: np.stack(xs), *batches)


@pytest.mark.parametrize('case', list(CAP_CASES))
@pytest.mark.parametrize('stacked', [False, True], ids=['list', 'stacked'])
def test_cap_multistep_equals_single_steps_bitwise(case, stacked):
    '''K single steps against one bundle from the same state, dropout on:
    the stacked losses and grad norms, and every tensor of the state.'''
    kw = CAP_CASES[case]
    jdims, _, state1, step = _cap(**kw)
    _, _, state2, _ = _cap(**kw)
    batches = [_batch(40 + i, dims=jdims) for i in range(K)]
    losses = []
    for b in batches:
        state1, m = step(state1, b)
        losses.append(m['loss'].item())
    multistep = tsteps.make_multistep(step)
    state2, metrics = multistep(state2, _stacked(batches) if stacked
                                else batches)
    assert metrics['loss'].shape == (K,) and metrics['grad_norm'].shape \
        == (K,)
    np.testing.assert_array_equal(metrics['loss'].numpy(),
                                  np.asarray(losses, np.float32))
    assert state1.step == state2.step == K
    assert state1.optimizer.count == state2.optimizer.count == K
    assert state1.optimizer.calls == state2.optimizer.calls == K
    _assert_same(_state_arrays(state1), _state_arrays(state2))


@pytest.mark.parametrize('case', list(CAP_CASES))
def test_cap_multistep_matches_jax_multistep(case):
    '''The port's bundle against ``jax.jit(make_multistep(step))`` over the
    same K batches, fp32, dropout off.'''
    kw = CAP_CASES[case]
    accum, ema_decay = kw.get('accum_steps', 1), kw.get('ema_decay', 0.0)
    jdims, params, state, step = _cap(dout_p=0.0, **kw)
    jopt = joptim.build_optimizer(STEP_CFG)
    jmulti = jax.jit(jsteps.make_multistep(jsteps.make_cap_train_step(
        jdims, jopt, SMOOTHING, PAD, accum_steps=accum,
        ema_decay=ema_decay)))
    jstate = jsteps.init_train_state(params, jopt, ema=bool(ema_decay))
    batches = [_batch(50 + i, dims=jdims) for i in range(K)]
    jstate, jm = jmulti(jstate, jax.tree.map(jnp.asarray,
                                             _stacked(batches)))
    state, m = tsteps.make_multistep(step)(state, batches)
    for key in ('loss', 'grad_norm'):
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert state.step == int(jstate.step) == K
    assert_tree_close(state.model, jstate.params, atol=PARAM_ATOL)
    if ema_decay:
        inv = {id(p): n for n, p in state.model.named_parameters()}
        assert_tree_close(((path, state.ema[inv[id(p)]]) for path, p in
                           named_jax_parameters(state.model)),
                          jstate.ema, atol=PARAM_ATOL)


PROP_CASES = {'plain': {}, 'accum2_ema': dict(accum_steps=2, ema_decay=0.9)}


def _prop(dout_p, accum_steps=1, ema_decay=0.0, **dims):
    jdims, params, model = jax_and_torch_generator(seed=7, dout_p=dout_p,
                                                   **dims)
    frozen = tsteps.prop_frozen(False)
    state = tsteps.init_train_state(
        model, toptim.build_optimizer(STEP_CFG, model, frozen=frozen),
        seed=2, ema=bool(ema_decay))
    step = tsteps.make_prop_train_step(model.dims, PAD,
                                       accum_steps=accum_steps,
                                       ema_decay=ema_decay)
    return jdims, params, frozen, state, step


@pytest.mark.parametrize('case', list(PROP_CASES))
def test_prop_multistep_equals_single_steps_bitwise(case):
    '''The proposal step, remat on and dropout on: the recompute draws the
    first run's masks in both.'''
    kw = PROP_CASES[case]
    jdims, _, _, state1, step = _prop(0.1, remat=True, **kw)
    _, _, _, state2, _ = _prop(0.1, remat=True, **kw)
    batches = [prop_batch(60 + i, jdims) for i in range(K)]
    per = []
    for b in batches:
        state1, m = step(state1, b)
        per.append(m)
    state2, metrics = tsteps.make_multistep(step)(state2, batches)
    assert set(metrics) == set(per[0])
    for k, v in metrics.items():
        np.testing.assert_array_equal(
            v.numpy(), np.asarray([m[k].item() for m in per], np.float32),
            err_msg=k)
    _assert_same(_state_arrays(state1), _state_arrays(state2))


@pytest.mark.parametrize('case', list(PROP_CASES))
def test_prop_multistep_matches_jax_multistep(case):
    kw = PROP_CASES[case]
    accum, ema_decay = kw.get('accum_steps', 1), kw.get('ema_decay', 0.0)
    jdims, params, frozen, state, step = _prop(0.0, **kw)
    mask = joptim.freeze_mask(params, frozen)
    jopt = joptim.build_optimizer(STEP_CFG, frozen_mask=mask)
    jmulti = jax.jit(jsteps.make_multistep(jsteps.make_prop_train_step(
        jdims, jopt, PAD, accum_steps=accum, ema_decay=ema_decay,
        frozen_mask=mask)))
    jstate = jsteps.init_train_state(params, jopt, ema=bool(ema_decay))
    batches = [prop_batch(70 + i, jdims) for i in range(K)]
    jstate, jm = jmulti(jstate, to_jax(_stacked(batches)))
    state, m = tsteps.make_multistep(step)(state, batches)
    for key in jm:
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                   rtol=LOSS_RTOL, err_msg=key)
    assert_tree_close(state.model, jstate.params, atol=PARAM_ATOL)
    if ema_decay:
        inv = {id(p): n for n, p in state.model.named_parameters()}
        assert_tree_close(((path, state.ema[inv[id(p)]]) for path, p in
                           named_jax_parameters(state.model)),
                          jstate.ema, atol=PARAM_ATOL)


# ---------------------------------------------------------------------------
# the epoch loops
# ---------------------------------------------------------------------------

class _CapData:
    '''Six full batches of 4, in a fixed order.'''
    batch_size = 4

    def __init__(self, dims, n=6, on_batch=None):
        self.batches_ = [_batch(80 + i, dims=dims, row_valid=False)
                         for i in range(n)]
        self.on_batch = on_batch

    def batches(self, epoch=0, seed=0, shuffle=True, start_batch=0, **_):
        for i, b in enumerate(self.batches_[start_batch:], start_batch):
            if self.on_batch is not None:
                self.on_batch(i)
            yield dict(b, video_ids=[f'v{i}_{r}' for r in range(4)])


class _PropData(_CapData):
    def __init__(self, dims, n=6, on_batch=None):
        self.batches_ = [prop_batch(90 + i, dims) for i in range(n)]
        self.on_batch = on_batch


def test_train_epoch_cap_bundles_with_a_single_step_tail():
    '''K = 4 over 6 batches: one bundle and a 2-step tail reach the
    unbundled loop's state bit for bit; the epoch loss agrees to 1e-6.'''
    jdims, _, plain, step = _cap(seed=6)
    _, _, bundled, _ = _cap(seed=6)
    data = _CapData(jdims)
    plain, plain_loss = train_epoch_cap(step, plain, data, epoch=0)
    stats = {}
    bundled, bun_loss = train_epoch_cap(
        step, bundled, data, epoch=0, stats=stats,
        multistep=tsteps.make_multistep(step), steps_per_dispatch=4)
    assert plain.step == bundled.step == 6
    np.testing.assert_allclose(bun_loss, plain_loss, rtol=1e-6)
    _assert_same(_state_arrays(plain), _state_arrays(bundled))
    # a bundle's seconds are spread over its four batches
    assert len(stats['step_s']) == 6 and len(set(stats['step_s'][:4])) == 1


def test_train_epoch_prop_bundles_with_a_single_step_tail():
    jdims, _, _, plain, step = _prop(0.1)
    _, _, _, bundled, _ = _prop(0.1)
    data = _PropData(jdims)
    plain, plain_loss = train_epoch_prop(step, plain, data, epoch=0)
    bundled, bun_loss = train_epoch_prop(
        step, bundled, data, epoch=0,
        multistep=tsteps.make_multistep(step), steps_per_dispatch=4)
    assert plain.step == bundled.step == 6
    np.testing.assert_allclose(bun_loss, plain_loss, rtol=1e-6)
    _assert_same(_state_arrays(plain), _state_arrays(bundled))


class _Guard:
    requested = False
    batch_in_epoch = None


@pytest.mark.parametrize("fire_at,want", [(1, 4), (4, 5), (5, 5)])
def test_guard_mid_bundle_stops_where_jax_stops(fire_at, want):
    '''A preemption asked for while batch ``fire_at`` is drawn: both loops
    stop after the bundle (or tail step) that holds it, at the same
    ``batch_in_epoch``.'''
    jdims, params, state, step = _cap(seed=8, dout_p=0.0)
    jopt = joptim.build_optimizer(STEP_CFG)
    jstep = jsteps.make_cap_train_step(jdims, jopt, SMOOTHING, PAD)
    jstate = jsteps.init_train_state(params, jopt)
    got = {}
    for name in ('jax', 'port'):
        guard = _Guard()

        def fire(i, guard=guard):
            if i == fire_at:
                guard.requested = True
        data = _CapData(jdims, on_batch=fire)
        if name == 'jax':
            j_train_epoch_cap(jax.jit(jstep), jstate, data, epoch=0,
                              guard=guard,
                              multistep=jax.jit(jsteps.make_multistep(jstep)),
                              steps_per_dispatch=4)
        else:
            train_epoch_cap(step, state, data, epoch=0, guard=guard,
                            multistep=tsteps.make_multistep(step),
                            steps_per_dispatch=4)
        got[name] = guard.batch_in_epoch
    assert got['port'] == got['jax'] == want


def test_prop_guard_mid_bundle_stops_where_jax_stops():
    jdims, params, frozen, state, step = _prop(0.0)
    mask = joptim.freeze_mask(params, frozen)
    jopt = joptim.build_optimizer(STEP_CFG, frozen_mask=mask)
    jstep = jsteps.make_prop_train_step(jdims, jopt, PAD, frozen_mask=mask)
    got = {}
    for name in ('jax', 'port'):
        guard = _Guard()

        def fire(i, guard=guard):
            if i == 2:
                guard.requested = True
        data = _PropData(jdims, on_batch=fire)
        if name == 'jax':
            j_train_epoch_prop(jax.jit(jstep),
                               jsteps.init_train_state(params, jopt), data,
                               epoch=0, guard=guard,
                               multistep=jax.jit(jsteps.make_multistep(
                                   jstep)), steps_per_dispatch=4)
        else:
            train_epoch_prop(step, state, data, epoch=0, guard=guard,
                             multistep=tsteps.make_multistep(step),
                             steps_per_dispatch=4)
        got[name] = guard.batch_in_epoch
    assert got['port'] == got['jax'] == 4


# ---------------------------------------------------------------------------
# the optimizer's device-held values
# ---------------------------------------------------------------------------

def test_device_held_count_rate_and_bias_corrections_equal_host_values():
    '''Over 5 steps of warmup_cosine: the device count is the number of
    updates, the rate of each step is base x multiplier(count) rounded to
    fp32 (the host value the previous optimizer handed torch), and the bias
    corrections are 1 - b^t in fp32 as the host computed them; a new base
    rate rewrites the table in place.'''
    cfg = types.SimpleNamespace(**{**vars(STEP_CFG),
                                   'scheduler': 'warmup_cosine',
                                   'warmup_steps': 2, 'lr_final_ratio': 0.1,
                                   'lr_total_steps': 6})
    _, _, model = jax_and_torch_model(seed=1, dout_p=0.0)
    opt = toptim.build_optimizer(cfg, model)
    mult = toptim.schedule_multiplier(cfg)
    table = opt.lr_table
    group = opt.inner.param_groups[0]
    rng = np.random.default_rng(0)
    for t in range(5):
        assert opt.count == t and opt.calls == t
        for p in opt.params:
            p.grad = torch.from_numpy(
                rng.normal(size=p.shape).astype(np.float32))
        opt.step()
        assert group['lr'].item() == np.float32(cfg.lr * mult(t))
        bc = opt.inner.bias_corrections(group, opt._count - 1)
        for b, got in zip(group['betas'], bc):
            want = 1 - torch.tensor(b, dtype=torch.float32) ** (t + 1)
            assert got.dtype == torch.float32 and got.item() == want.item()
    assert opt.count == 5
    toptim.set_learning_rate(opt, cfg.lr / 10)
    assert opt.lr_table is table
    assert table[3].item() == np.float32(cfg.lr / 10 * mult(3))


def test_nonfinite_guard_counters_live_on_the_device():
    '''The guard's verdict gates the update on the device: a NaN gradient
    leaves parameters, moments and count as they were, and the counters
    read back as optax.apply_if_finite's.'''
    cfg = types.SimpleNamespace(**{**vars(STEP_CFG),
                                   'skip_nonfinite_grads': 1})
    _, _, model = jax_and_torch_model(seed=1, dout_p=0.0)
    opt = toptim.build_optimizer(cfg, model)
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.step()
    before = [p.detach().clone() for p in opt.params]
    moments = [v.clone() for p in opt.params
               for v in opt.inner.state[p].values()]
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.params[0].grad[0] = math.nan
    opt.step()
    assert (opt.count, opt.notfinite, opt.total_notfinite,
            opt.last_finite, opt.calls) == (1, 1, 1, False, 2)
    for a, b in zip(before, opt.params):
        assert torch.equal(a, b.detach())
    assert all(torch.equal(a, b) for a, b in zip(moments, (
        v for p in opt.params for v in opt.inner.state[p].values())))
    opt.step()                      # past the limit of 1: passes through
    assert opt.count == 2 and opt.notfinite == 2
    assert torch.isnan(opt.params[0].detach()).any()


def test_checkpoint_load_copies_into_the_states_tensors(tmp_path):
    '''A load after the optimizer holds state copies into its tensors (a
    CUDA graph of the step holds their addresses) and resumes bit for bit:
    2 steps, save; 1 more; load the save; 1 step == 3 straight steps.'''
    from bmt_tpu_torch.train.checkpoint import (load_optimizer_state,
                                                optimizer_state_tree)
    jdims, _, state, step = _cap(seed=2, dout_p=0.0)
    _, _, straight, _ = _cap(seed=2, dout_p=0.0)
    batches = [_batch(100 + i, dims=jdims) for i in range(3)]
    for b in batches:
        straight, _ = step(straight, b)
    for b in batches[:2]:
        state, _ = step(state, b)
    saved = optimizer_state_tree(state.model, state.optimizer)
    params = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    state, _ = step(state, batches[2])
    moments = {id(v): v for p in state.optimizer.params
               for v in state.optimizer.inner.state[p].values()}
    load_optimizer_state(state.model, state.optimizer, saved)
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(params[n])
    state.step = 2
    assert {id(v) for p in state.optimizer.params
            for v in state.optimizer.inner.state[p].values()} == set(moments)
    state, _ = step(state, batches[2])
    _assert_same(_state_arrays(straight), _state_arrays(state))


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return mini_tree(tmp_path_factory.mktemp('multisteptree'))


@pytest.mark.parametrize('procedure', ['train_cap', 'train_prop'])
def test_cli_steps_per_dispatch_runs_on_the_cpu(tree, tmp_path, procedure,
                                                monkeypatch, capsys):
    '''``python -m bmt_tpu_torch --procedure ... --steps_per_dispatch 2
    --device cpu``: the bundles run (their steps in order on the CPU) and
    the run ends with its scores; no step-by-step notice is printed.'''
    monkeypatch.chdir(tmp_path)
    log = tmp_path / 'log'
    cap_dir = log / 'train_cap' / 'cap'
    flags = {}
    if procedure == 'train_prop':
        cli.main(mini_argv(tree, log, 'train_cap', device='cpu',
                           exper_name='cap'))
        flags['pretrained_cap_model_path'] = cap_dir
    out = cli.main(mini_argv(tree, log, procedure, device='cpu',
                             steps_per_dispatch=2, exper_name='k2', **flags))
    assert out is not None
    captured = capsys.readouterr()
    assert '[time] train epoch 0:' in captured.out
    assert 'step by step' not in captured.err
