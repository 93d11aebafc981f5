'''Work for the ranks of a sharded group in the port's CPU tests
(``parallel.launch.spawn`` runs it in each spawned process; nothing here
imports JAX, so the workers start fast): train steps under ``--fsdp``,
expert and sequence parallelism, what each rank holds, and the whole state
written and read back under ``DataParallel.whole``.'''
import copy
import os
import pickle

import numpy as np
import torch

SMOOTHING = 0.7
PAD = 1


def _model(run, device):
    from bmt_tpu_torch.models import (BiModalTransformer, CapModelDims,
                                      PropModelDims, proposal_class)
    from bmt_tpu_torch.params import load_jax_params
    if run['kind'] == 'cap':
        dims = CapModelDims(**run['dims'])
        model = BiModalTransformer(dims, device=device)
    else:
        dims = PropModelDims(**run['dims'])
        model = proposal_class(dims)(dims, device=device)
    load_jax_params(model, run['tree'])
    return dims, model


def _step(run, dims, dp):
    from bmt_tpu_torch.train import steps
    if run['kind'] == 'cap':
        return steps.make_cap_train_step(dims, SMOOTHING, PAD, dp=dp,
                                         **run.get('step_kw', {}))
    return steps.make_prop_train_step(dims, PAD, dp=dp,
                                      **run.get('step_kw', {}))


def _state(run, model, job, dp):
    '''The run's train state, its shards cut under ``dp`` (``--fsdp`` as the
    run or else the job asks).'''
    from bmt_tpu_torch.train import optim, steps
    opt = optim.build_optimizer(run['cfg'], model, frozen=run['frozen'])
    state = steps.init_train_state(model, opt, ema=run.get('ema', False))
    if dp is None:
        return state, None
    dp.fsdp = run.get('fsdp', job['fsdp'])
    return state, dp.shard_params(state, job['min_elems'])


def _bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def shard_steps(job_path, device):
    '''Each run of the job (a captioner or a proposal generator from a JAX
    tree, its optimizer config, frozen predicate and global batches) on the
    job's (dp, sp, ep) grid with ``--fsdp`` as asked. Returns, from every
    rank, its coordinates, its bytes and experts, the encoder's output
    rows; from rank 0, the losses by step, the whole parameters (JAX
    layout) and optimizer state after the last step, the decode or the
    predictions asked for, and the step after a resume of an unsharded
    run's directory.'''
    from bmt_tpu_torch.models.encoders import BiModalEncoder, Encoder
    from bmt_tpu_torch.ops.moe import MoEFeedForward
    from bmt_tpu_torch.parallel import DataParallel
    from bmt_tpu_torch.params import to_jax_tree
    from bmt_tpu_torch.train import checkpoint, steps

    torch.set_num_threads(1)
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    n_dp, n_sp, n_ep = job['grid']
    dp = DataParallel(n_dp, device, sp=n_sp, ep=n_ep, fsdp=job['fsdp'])
    out = {'rank': dp.rank, 'backend': dp.backend,
           'coords': (dp.dp_rank, dp.sp_rank, dp.ep_rank)}
    if n_ep > 1:
        out['ep_sum'] = ep_sum_gradients(dp.ep_group)
    for run in job['runs']:
        name = run['name']
        dims, model = _model(run, device)
        whole_bytes = _bytes(model)
        state, shards = _state(run, model, job, dp)
        rows = []
        enc = next(m for m in model.modules()
                   if isinstance(m, (BiModalEncoder, Encoder)))
        hook = enc.register_forward_hook(lambda m, a, o: rows.append(
            [t.shape[1] for t in (o if isinstance(o, tuple) else (o,))]))
        step = _step(run, dims, dp)
        losses = []
        for batch in run['batches']:
            state, metrics = step(state, dp.shard(batch))
            losses.append({k: v.item() for k, v in metrics.items()})
        hook.remove()
        mine = {'bytes': _bytes(model), 'whole_bytes': whole_bytes,
                'held': None if shards is None else shards.bytes(),
                'experts': [m.experts.w1.shape[0] for m in model.modules()
                            if isinstance(m, MoEFeedForward)],
                'encoder_rows': rows[0]}
        res = {}
        if 'predict' in run:
            infer = steps.make_prop_inference_step(dims, PAD, dp=dp)
            with dp.whole():
                res['predictions'] = dp.gather_rows(infer(
                    model, dp.shard({'src': run['predict']}))).numpy()
        if 'decode' in run:
            from bmt_tpu_torch.decode import make_bimodal_greedy_fn
            greedy = make_bimodal_greedy_fn(dims, 6, 2, 3, PAD)
            stacks = {k: torch.from_numpy(v) for k, v in
                      run['decode'].items()}
            model.eval()
            with dp.whole():
                res['decode'] = dp.decode(greedy, model, stacks).numpy()
        with dp.whole(everything=True):
            if dp.is_main:
                res.update(losses=losses, tree=to_jax_tree(model),
                           opt=checkpoint.optimizer_state_tree(
                               model, state.optimizer))
                if job.get('save_dir'):
                    checkpoint.save_checkpoint(
                        os.path.join(job['save_dir'], name), model,
                        {'epoch': 0, 'step': state.step}, state.optimizer,
                        'last')
        if run.get('resume_from'):
            # an unsharded run's directory into a sharded state, one more
            # step
            _, again = _model(run, device)
            state, _ = _state(run, again, job, dp)
            with dp.whole(everything=True):
                checkpoint.load_checkpoint(run['resume_from'], again,
                                           state.optimizer, 'last')
            state.step = len(run['batches'])
            state, _ = _step(run, dims, dp)(state, dp.shard(run['next']))
            with dp.whole(everything=True):
                if dp.is_main:
                    res['resumed'] = to_jax_tree(again)
        out[name] = {'rank': mine, **res}
    return out


def ep_sum_gradients(group):
    '''y = sum over the ep ranks of w_r * x (x the same on every rank,
    w_r = r + 1) through ``CopyToGroup`` and ``ReduceFromGroup``; L =
    sum(y * c). Returns (y, dL/dx, dL/dw_r): the right values are
    x sum_r w_r, c sum_r w_r (every rank) and c x.'''
    from bmt_tpu_torch.parallel.mesh import CopyToGroup, ReduceFromGroup
    x = torch.arange(1.0, 7.0).view(2, 3).requires_grad_()
    w = torch.tensor(float(group.rank + 1), requires_grad=True)
    c = torch.tensor([[1.0, -2.0, 3.0], [0.5, 4.0, -1.0]])
    y = ReduceFromGroup.apply(CopyToGroup.apply(x, group) * w, group)
    (y * c).sum().backward()
    return y.detach().numpy(), x.grad.numpy(), w.grad.item()


def unsharded(job, device='cpu'):
    '''Rank 0's work of ``shard_steps`` in this process, without a group:
    the losses, the whole parameters and optimizer state; written to
    ``job['save_dir']`` when set, and the resume's next step taken from
    that directory.'''
    from bmt_tpu_torch.params import to_jax_tree
    from bmt_tpu_torch.train import checkpoint
    out = {}
    for run in job['runs']:
        dims, model = _model(run, device)
        state, _ = _state(run, model, job, None)
        step = _step(run, dims, None)
        losses = []
        for batch in run['batches']:
            state, metrics = step(state, batch)
            losses.append({k: v.item() for k, v in metrics.items()})
        res = {'losses': losses, 'tree': copy.deepcopy(to_jax_tree(model)),
               'opt': checkpoint.optimizer_state_tree(model,
                                                      state.optimizer)}
        if 'predict' in run:
            from bmt_tpu_torch.train import steps
            infer = steps.make_prop_inference_step(dims, PAD)
            res['predictions'] = infer(model, {'src': run['predict']}
                                       ).numpy()
        if job.get('save_dir'):
            path = os.path.join(job['save_dir'], run['name'] + '_plain')
            checkpoint.save_checkpoint(path, model,
                                       {'epoch': 0, 'step': state.step},
                                       state.optimizer, 'last')
            if 'next' in run:
                state, _ = step(state, run['next'])
                res['next'] = to_jax_tree(model)
        out[run['name']] = res
    return out


def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_numpy(v) for v in tree]
    return np.asarray(tree)
