'''Shared fixtures for the parity tests of the PyTorch port against the JAX
package: small dims, JAX parameter trees carried into torch modules, and
inputs made with numpy from a seed and handed to both.'''
import numpy as np
import torch

import jax
import jax.numpy as jnp

from bmt_tpu.models import CapModelDims as JaxDims
from bmt_tpu.models import init_bimodal_transformer
from bmt_tpu_torch.models import BiModalTransformer, CapModelDims
from bmt_tpu_torch.params import load_jax_params, named_jax_parameters

# tier-1 runs six pytest workers; one torch thread each avoids
# oversubscribing the CPU
torch.set_num_threads(1)

# small widths with the linear feature embedders (d_vid/d_aud != d_model_*)
SMALL = dict(voc_size=23, d_model_A=8, d_model_V=16, d_model_C=16,
             d_model=16, H=2, N=2, d_ff_A=16, d_ff_V=24, d_ff_C=20,
             dout_p=0.1, d_vid=20, d_aud=6, use_linear_embedder=True)
PAD, START, END = 1, 2, 3


def dims_pair(**kw):
    '''(JAX dims, torch dims) with the same fields.'''
    fields = {**SMALL, **kw}
    return JaxDims(**fields), CapModelDims(**fields)


def jax_and_torch_model(seed=0, **kw):
    '''JAX params from init_bimodal_transformer and the torch model carrying
    them; fp32 on the CPU, eval mode.'''
    jdims, tdims = dims_pair(**kw)
    params = init_bimodal_transformer(jax.random.PRNGKey(seed), jdims)
    model = BiModalTransformer(tdims, device='cpu')
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jdims, params, model.eval()


def features(rng, B, Sv, Sa, dims, pad_rows=None):
    '''Numpy feature stacks; ``pad_rows`` maps a row to its valid
    (video, audio) lengths, the rest padded as the engine pads them
    (rgb/audio with PAD, flow with 0).'''
    src = {'rgb': rng.normal(size=(B, Sv, dims.d_vid)).astype(np.float32),
           'flow': rng.normal(size=(B, Sv, dims.d_vid)).astype(np.float32),
           'audio': rng.normal(size=(B, Sa, dims.d_aud)).astype(np.float32)}
    for row, (nv, na) in (pad_rows or {}).items():
        src['rgb'][row, nv:] = PAD
        src['flow'][row, nv:] = 0.0
        src['audio'][row, na:] = PAD
    return src


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def assert_close_nan(ours, ref, atol, rtol=0.0):
    '''allclose with NaN required at exactly the same places.'''
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol)


def tree_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def assert_tree_close(model_or_named, tree, atol):
    '''Every parameter of a module (or every (JAX path, tensor) pair) is
    within ``atol`` of the JAX tree's leaf at that path.'''
    named = (named_jax_parameters(model_or_named)
             if isinstance(model_or_named, torch.nn.Module)
             else model_or_named)
    for path, p in named:
        want = tree_leaf(tree, path)
        got = p.detach().numpy()
        if path[-1] == 'w' and path[-2] != 'router':
            got = got.T       # a Linear's or Conv1d's weight: axes reversed
        np.testing.assert_allclose(got, want, atol=atol, err_msg=str(path))


def jax_sharded_steps(make_step, params, cfg, frozen, batches, mesh_dp,
                      place=False):
    '''The JAX package's train steps over ``mesh_dp`` (its
    ``DataParallel``): ``make_step(optimizer, frozen_mask)`` gives the step;
    ``place``: the parameters placed by ``place_params`` (fsdp with
    ``fsdp_min_elems=0``, the experts over ep), else replicated. Returns
    (losses by step, the parameters after the last step as numpy).'''
    from bmt_tpu.parallel import place_params
    from bmt_tpu.train import optim as joptim
    from bmt_tpu.train import steps as jsteps
    mask = joptim.freeze_mask(params, frozen)
    opt = joptim.build_optimizer(cfg, frozen_mask=mask)
    if place:
        params = place_params(params, mesh_dp.mesh, fsdp=mesh_dp.fsdp,
                              fsdp_min_elems=0)
    state = jsteps.init_train_state(params, opt)
    if place:
        state = mesh_dp.complete_on_mesh(state)
    else:
        state = state._replace(
            params=mesh_dp.replicate_tree(state.params),
            opt_state=mesh_dp.replicate_tree(state.opt_state))
    step = mesh_dp.jit_step(make_step(opt, mask))
    losses = []
    for batch in batches:
        state, m = step(state, mesh_dp.shard(batch))
        losses.append({k: float(v) for k, v in m.items()})
    return losses, jax.tree.map(np.asarray, state.params)


def assert_losses_close(got, want, rtol=2e-5):
    '''Every step's metrics of the JAX run within ``rtol`` of the port's.'''
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=rtol, err_msg=k)


def assert_jax_trees_close(got, want, atol=2e-6):
    '''Two trees in the JAX layout (the port's ``to_jax_tree`` and JAX's
    parameters), leaf for leaf.'''
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                                   err_msg=str(path))
