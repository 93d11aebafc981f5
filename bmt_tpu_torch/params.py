'''Parameters: seeded init, and carrying weights to and from the JAX package.

The JAX package keeps parameters as a tree of nested dicts and lists of
arrays, and checkpoints it as an npz whose keys are the tree paths joined by
``/`` (``bmt_tpu/train/checkpoint.py``). The port's modules use the tree's
keys as attribute names, so one walk maps a tree onto a module:

- a JAX linear ``{'w': (d_in, d_out), 'b': (d_out,)}`` computes ``x @ w + b``
  and becomes an ``nn.Linear`` whose ``weight`` is ``w.T``;
- a JAX conv ``{'w': (k, d_in, d_out), 'b': (d_out,)}`` becomes an
  ``nn.Conv1d`` whose ``weight`` (d_out, d_in, k) is ``w`` with its axes
  reversed;
- a list becomes an ``nn.ModuleList``;
- any other dict becomes a module whose parameters and children carry the
  dict's keys (LayerNorm ``scale``/``bias``, the embedding ``table``, the
  proposal generator's top-level ``anchors_A``/``anchors_V``, a MoE FFN's
  ``router/w`` and ``experts/{w1,b1,w2,b2}`` in their JAX layout);
- a LoRA-adapted linear's dict also holds ``lora_a`` (d_in, r), ``lora_b``
  (r, d_out) and ``lora_s``: the linear module carries them in that layout
  (``ops.lora.attach_lora``).

An adapter site is named by its linear's tree path joined by ``/`` (e.g.
``decoder/layers/0/self_att/q2d``) in both packages: ``jax_child`` takes one
step of such a path from a module, and ``jax_linear_paths`` maps a model's
linears back to their paths.

Everything here is numpy and torch; nothing imports JAX.
'''
from __future__ import annotations

import math
import os

import numpy as np
import torch
from torch import nn

from bmt_tpu_torch.ops.layers import LayerNorm, VocabularyEmbedder

SEP = '/'


# the axes of a JAX ``w`` in the order of the torch layer's ``weight``
# (each permutation is its own inverse)
_WEIGHT_AXES = ((nn.Linear, (1, 0)), (nn.Conv1d, (2, 1, 0)))


def _weight_axes(m: nn.Module):
    '''The permutation between a layer's ``weight`` and its JAX ``w``, or
    None for a module that is not such a layer.'''
    for cls, axes in _WEIGHT_AXES:
        if isinstance(m, cls):
            return axes
    return None


def _has_params(m: nn.Module) -> bool:
    return next(m.parameters(), None) is not None


LORA_LEAVES = ('lora_a', 'lora_b', 'lora_s')


def _lora_leaves(m: nn.Module) -> dict:
    '''A linear's adapter as JAX leaves (fp32 numpy), or {}.'''
    from bmt_tpu_torch.ops.lora import has_lora
    if not has_lora(m):
        return {}
    return {k: getattr(m, k).detach().float().cpu().numpy()
            for k in LORA_LEAVES}


def _xavier_(t: torch.Tensor, fan_in: int, fan_out: int, generator):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    '''Draw every parameter of ``module`` from ``generator`` with the JAX
    package's recipe (``bmt_tpu/ops/layers.py``,
    ``bmt_tpu/models/proposal.py``): xavier-uniform weight matrices,
    U(+-1/sqrt(fan_in)) linear biases, conv weights and biases from
    U(+-1/sqrt(d_in k)), ones/zeros LayerNorms, MoE routers and experts as
    ``init_moe_ffn``. Other parameters (the proposal anchors) keep their
    values.'''
    from bmt_tpu_torch.ops.moe import MoEFeedForward
    for m in module.modules():
        if isinstance(m, nn.Linear):
            _xavier_(m.weight, m.in_features, m.out_features, generator)
            bound = 1.0 / math.sqrt(m.in_features)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Conv1d):
            bound = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0])
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, VocabularyEmbedder):
            _xavier_(m.table, *m.table.shape, generator)
        elif isinstance(m, MoEFeedForward):
            m.init_from(generator)


def _copy(param: torch.Tensor, value, path: str) -> None:
    arr = np.asarray(value, dtype=np.float32)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f'{path}: array of shape {arr.shape} does not fit '
                         f'parameter of shape {tuple(param.shape)}')
    param.copy_(torch.tensor(arr))


def _tree_keys(m: nn.Module) -> set:
    return ({name for name, _ in m.named_parameters(recurse=False)}
            | {name for name, c in m.named_children() if _has_params(c)})


@torch.no_grad()
def load_jax_params(module: nn.Module, tree, path: str = '') -> None:
    '''Copy a JAX parameter tree (nested dicts/lists of arrays, keys as in
    ``init_bimodal_transformer``) into ``module``. Raises on a missing or
    extra key and on a shape that does not fit.'''
    axes = _weight_axes(module)
    if axes is not None:
        lora = isinstance(module, nn.Linear) and isinstance(tree, dict) \
            and set(tree) == {'w', 'b', *LORA_LEAVES}
        if not isinstance(tree, dict) or (set(tree) != {'w', 'b'}
                                          and not lora):
            raise KeyError(f'{path}: expected a layer {{w, b}}, got '
                           f'{sorted(tree) if isinstance(tree, dict) else type(tree)}')
        _copy(module.weight, np.asarray(tree['w']).transpose(axes),
              f'{path}/w')
        _copy(module.bias, tree['b'], f'{path}/b')
        if lora:
            from bmt_tpu_torch.ops.lora import attach_lora, has_lora
            if has_lora(module):
                # into the adapter in place: an optimizer holds its tensors
                for k in LORA_LEAVES:
                    _copy(getattr(module, k), tree[k], f'{path}/{k}')
            else:
                attach_lora(module, *(np.asarray(tree[k], np.float32)
                                      for k in LORA_LEAVES))
        return
    if isinstance(module, nn.ModuleList):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(module):
            raise KeyError(f'{path}: expected a list of {len(module)}')
        for i, (child, node) in enumerate(zip(module, tree)):
            load_jax_params(child, node, f'{path}/{i}')
        return
    if not isinstance(tree, dict):
        raise KeyError(f'{path}: expected a dict, got {type(tree).__name__}')
    want = _tree_keys(module)
    if set(tree) != want:
        raise KeyError(f'{path}: tree keys {sorted(tree)} != module keys '
                       f'{sorted(want)}')
    for key, node in tree.items():
        if key in module._parameters:
            _copy(module._parameters[key], node, f'{path}/{key}')
        else:
            load_jax_params(getattr(module, key), node, f'{path}/{key}')


def to_jax_tree(module: nn.Module):
    '''The inverse of ``load_jax_params``: the module's parameters as a JAX
    layout tree of fp32 numpy arrays.'''
    def arr(p):
        return p.detach().float().cpu().numpy()
    axes = _weight_axes(module)
    if axes is not None:
        return {'w': np.ascontiguousarray(arr(module.weight).transpose(axes)),
                'b': arr(module.bias), **_lora_leaves(module)}
    if isinstance(module, nn.ModuleList):
        return [to_jax_tree(c) for c in module]
    tree = {name: arr(p) for name, p in module.named_parameters(recurse=False)}
    tree.update({name: to_jax_tree(c) for name, c in module.named_children()
                 if _has_params(c)})
    return tree


def named_jax_parameters(module: nn.Module, prefix: tuple = ()):
    '''Yield (JAX tree path, parameter) for every parameter of ``module``:
    the path is the tuple of keys that ``jax.tree_util`` gives the same
    leaf (dict keys as str, list indices as int), e.g. ``('emb_C',
    'table')`` or ``('encoder', 'layers', 0, 'self_att_M1', 'q2d', 'w')``
    for a linear's weight.'''
    if _weight_axes(module) is not None:
        yield prefix + ('w',), module.weight
        yield prefix + ('b',), module.bias
        for name in LORA_LEAVES[:2]:
            if name in module._parameters:
                yield prefix + (name,), module._parameters[name]
        return
    if isinstance(module, nn.ModuleList):
        for i, child in enumerate(module):
            yield from named_jax_parameters(child, prefix + (i,))
        return
    for name, p in module.named_parameters(recurse=False):
        yield prefix + (name,), p
    for name, child in module.named_children():
        if _has_params(child):
            yield from named_jax_parameters(child, prefix + (name,))


def jax_child(node: nn.Module, key: str):
    '''One step of a JAX tree path from a module: a list's item by its
    index, or the child module or parameter named ``key``. Raises
    IndexError for an index past a list, KeyError for a key the module does
    not hold.'''
    if isinstance(node, nn.ModuleList):
        i = int(key)
        if not 0 <= i < len(node):
            raise IndexError(f'index {i} past a list of {len(node)}')
        return node[i]
    child = node._modules.get(key, node._parameters.get(key))
    if child is None:
        raise KeyError(key)
    return child


def jax_linear_paths(module: nn.Module, prefix: str = '') -> dict:
    '''{JAX tree path joined by '/': linear} for every ``nn.Linear`` and
    ``ops.quant.Int8Linear`` of ``module`` (the sites an adapter can
    name).'''
    from bmt_tpu_torch.ops.quant import Int8Linear
    out = {}
    for name, child in module.named_children():
        path = f'{prefix}{name}'
        if isinstance(child, (nn.Linear, Int8Linear)):
            out[path] = child
        else:
            out.update(jax_linear_paths(child, f'{path}{SEP}'))
    return out


def _flatten(tree, prefix: str = '') -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for key, node in items:
        out.update(_flatten(node, f'{prefix}{key}{SEP}'))
    return out


def save_params_npz(path: str, tree) -> None:
    '''Write a tree as the JAX package's ``*.params.npz`` (keys are the tree
    paths joined by '/'). Atomic: written to a temporary name, then
    renamed.'''
    tmp = f'{path}.tmp-{os.getpid()}'
    with open(tmp, 'wb') as f:
        np.savez(f, **_flatten(tree))
    os.replace(tmp, path)


def _unflatten_lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _unflatten_lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(int(k) for k in node) != list(range(len(node))):
            raise KeyError(f'list indices {sorted(node)} are not 0..n-1')
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten(flat: dict):
    '''The inverse of ``_flatten``: a dict of '/'-joined paths to arrays as
    a nested dict/list tree.'''
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split(SEP)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return _unflatten_lists(tree)


def load_params_npz(path: str):
    '''Read a ``*.params.npz`` written by either package into a nested
    dict/list tree of numpy arrays (numpy only).'''
    with np.load(path, allow_pickle=False) as data:
        return unflatten({key: data[key] for key in data.files})
