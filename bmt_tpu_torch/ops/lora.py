'''LoRA adapters (counterpart of ``bmt_tpu.ops.lora``).

A rank-r adapter adds ``(alpha / r) x A B`` to a linear's output: A
(d_in, r), B (r, d_out) and the scale s, in the JAX package's layout (its
leaves ``lora_a``, ``lora_b``, ``lora_s``). The JAX package keeps them
inside the linear's parameter dict, where its one ``linear`` dispatch adds
the delta. Here an adapter rides on the linear module as a forward hook,
which adds the delta to whatever the module computed, so it composes with
``ops.quant.Int8Linear`` as JAX's does: the delta on top of the quantized
base product. Two ways to carry adapters:

- ``add_lora`` / ``attach_lora``: the adapter is the linear's own
  parameters (``lora_a``, ``lora_b``, the buffer ``lora_s``), as in a
  finetuned tree; train_cap's ``--lora_rank`` trains them alone
  (``lora_frozen_predicate``). ``merge_lora`` folds them into the weights,
  ``count_lora`` counts them, ``params.to_jax_tree`` and
  ``train.checkpoint.save_lora_npz`` write them under the JAX tree's
  paths.
- ``apply_adapter``: one of several named adapters over a shared base
  model, as the serving engine holds them. Each adapter is only its
  (A, B, s) per site; for a batch that selects it, a hook on each of its
  linears adds its delta, and the hooks go when the batch is done. No
  base weight is copied.

The delta is computed in the adapter's dtype (x is upcast to it, as JAX
promotes a bf16 x against fp32 leaves) and cast to the output's. On a
tensor-parallel linear (``parallel.tensor``) the adapter follows the JAX
layout: ``lora_b`` holds this rank's columns at a column site, ``lora_a``
its rows at a row site, and the linear's ``adapter_delta`` adds the
collectives (``site_delta``). The JAX
package joins the A-side products of linears that share an input
(``shared_lora_deltas``, a TPU-lane optimisation); the hooks here apply
each site's delta alone, which is the same sum per column.
'''
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

# which linears get adapters, by their attribute name in the parent module
TARGET_SETS = {
    'attn': {'q2d', 'k2d', 'v2d', 'd2q'},
    'attn_ffn': {'q2d', 'k2d', 'v2d', 'd2q', 'fc1', 'fc2'},
    'all': None,   # every linear
}


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    '''((x @ A) @ B) * s in A's dtype.'''
    return ((x.to(a.dtype) @ a) @ b) * s


def has_lora(module: nn.Module) -> bool:
    '''Whether a linear carries an adapter of its own (``attach_lora``).'''
    return 'lora_a' in module._parameters


def site_delta(linear: nn.Module, x: torch.Tensor, a, b, s) -> torch.Tensor:
    '''The delta of the adapter (A, B, s) on ``linear`` for its input
    ``x``: ``lora_delta``, or on a tensor-parallel linear its
    ``adapter_delta`` (``parallel.tensor``: A and B may be this rank's
    blocks, joined by the linear's collectives).'''
    delta = getattr(linear, 'adapter_delta', None)
    return lora_delta(x, a, b, s) if delta is None else delta(x, a, b, s)


def _own_lora_hook(module, inputs, out):
    return out + site_delta(module, inputs[0], module.lora_a, module.lora_b,
                            module.lora_s).to(out.dtype)


def attach_lora(linear: nn.Module, a, b, s) -> None:
    '''Give ``linear`` the adapter (A (d_in, r), B (r, d_out), s) as its
    parameters ``lora_a``, ``lora_b`` and buffer ``lora_s`` (fp32, on the
    linear's device), replacing one it had.'''
    dev = linear.weight.device if hasattr(linear, 'weight') else \
        linear.w_q.device
    a, b, s = ((t if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.array(t, np.float32))).to(
                    device=dev, dtype=torch.float32) for t in (a, b, s))
    if a.shape[0] != linear.in_features or b.shape[1] != \
            linear.out_features or a.shape[1] != b.shape[0]:
        raise ValueError(f'LoRA deltas {tuple(a.shape)}x{tuple(b.shape)} '
                         f'do not fit a {linear.in_features} -> '
                         f'{linear.out_features} linear')
    linear.lora_a = nn.Parameter(a)
    linear.lora_b = nn.Parameter(b)
    linear.register_buffer('lora_s', s.reshape(()))
    if _own_lora_hook not in linear._forward_hooks.values():
        linear.register_forward_hook(_own_lora_hook)


def _targets(module: nn.Module, names, parent_name: str = ''):
    '''(linear, its key) for every ``nn.Linear`` whose key in its parent
    is one of ``names`` (all when None); an item of a list takes the list's
    key, as in the JAX tree walk.'''
    for name, child in module.named_children():
        key = parent_name if isinstance(module, nn.ModuleList) else name
        if isinstance(child, nn.Linear):
            if names is None or key in names:
                yield child
        else:
            yield from _targets(child, names, key)


@torch.no_grad()
def add_lora(model: nn.Module, rank: int, generator: torch.Generator,
             alpha: float | None = None, targets: str = 'attn') -> nn.Module:
    '''Give the target linears of ``model`` adapters, in place; returns the
    model. A is drawn xavier-uniform from ``generator`` (a
    ``torch.Generator`` on the model's device) site after site, B is zeros,
    so the adapted model computes the base model's outputs until B moves.
    ``alpha`` defaults to ``rank`` (scale 1). ``targets``: 'attn' (the
    attention projections), 'attn_ffn' or 'all'.'''
    if rank <= 0:
        return model
    if targets not in TARGET_SETS:
        raise ValueError(
            f'unknown --lora_targets {targets!r}; one of {sorted(TARGET_SETS)}')
    scale = float(alpha if alpha is not None else rank) / float(rank)
    for linear in list(_targets(model, TARGET_SETS[targets])):
        d_in, d_out = linear.in_features, linear.out_features
        bound = math.sqrt(6.0 / (d_in + rank))
        dev = linear.weight.device
        a = torch.empty(d_in, rank, device=dev).uniform_(
            -bound, bound, generator=generator)
        attach_lora(linear, a, torch.zeros(rank, d_out, device=dev),
                    torch.tensor(scale))
    return model


def shared_lora_deltas(sites, x: torch.Tensor) -> list:
    '''The deltas of several adapters ((A, B, s) each) over the same input
    ``x``, with one product of x by the concatenated A's.'''
    a_all = torch.cat([a for a, _, _ in sites], dim=1)
    u = x.to(a_all.dtype) @ a_all
    deltas, off = [], 0
    for a, b, s in sites:
        r = a.shape[1]
        deltas.append((u[..., off:off + r] @ b) * s)
        off += r
    return deltas


def apply_shared_lora(sites, x: torch.Tensor, ys) -> list:
    '''ys[i] + delta_i for adapters sharing the input ``x``, in each
    output's dtype.'''
    return [y + d.to(y.dtype)
            for y, d in zip(ys, shared_lora_deltas(sites, x))]


@torch.no_grad()
def merge_linear_lora(linear: nn.Linear) -> nn.Linear:
    '''Fold a linear's own adapter into its weight (fp32 sum, cast back to
    the weight's dtype) and drop the adapter.'''
    w = linear.weight
    delta = (linear.lora_a.float() @ linear.lora_b.float()) \
        * linear.lora_s.float()
    w.copy_((w.float() + delta.t()).to(w.dtype))
    del linear.lora_a, linear.lora_b, linear.lora_s
    for key, hook in list(linear._forward_hooks.items()):
        if hook is _own_lora_hook:       # found by identity: a deep copy's
            del linear._forward_hooks[key]   # handles point at the original
    return linear


def merge_lora(model: nn.Module) -> nn.Module:
    '''Fold every adapter of ``model`` into its base weight, in place;
    returns the model, a plain one.'''
    for m in model.modules():
        if has_lora(m):
            if not isinstance(m, nn.Linear):
                raise ValueError(
                    'cannot merge LoRA into a quantized linear — merge '
                    'before quantize_tree_int8, not after')
            merge_linear_lora(m)
    return model


def count_lora(model: nn.Module) -> tuple:
    '''(number of adapted linears, adapter parameters in all).'''
    sites = [m for m in model.modules() if has_lora(m)]
    return len(sites), sum(m.lora_a.numel() + m.lora_b.numel()
                           for m in sites)


def lora_frozen_predicate(path_keys) -> bool:
    '''Freeze predicate of LoRA finetuning on a JAX tree path: only the
    adapters' A and B train (``lora_s`` is a fixed scale, frozen like the
    base weights).'''
    return path_keys[-1] not in ('lora_a', 'lora_b')


@contextlib.contextmanager
def apply_adapter(sites: dict | None):
    '''Inside the block, each linear of ``sites`` ({linear: (A, B, s)}, as
    the serving engine holds an adapter; None or {} for the base) adds its
    delta through a forward hook; the hooks are removed on the way out, so
    the base runs without them. The caller serializes the blocks.'''
    handles = []
    try:
        for linear, site in (sites or {}).items():
            handles.append(linear.register_forward_hook(
                lambda module, inputs, out, site=site:
                out + site_delta(module, inputs[0], *site).to(out.dtype)))
        yield
    finally:
        for handle in handles:
            handle.remove()
