'''Checkpoints: the native npz format with resume, and the reference's
PyTorch ``.pt`` files (counterpart of ``bmt_tpu.train.checkpoint``).

Native format: a directory with ``{name}.params.npz`` (the JAX parameter
tree, keys its paths joined by ``/``), ``{name}.meta.json`` (config dict,
epoch, metrics, vocab itos) and, for resume, the optimizer state. The params
keep the JAX tree's keys and layouts (``params.py``), so a checkpoint that
either package writes loads in the other, in its trainers (resume) and its
evaluation. The optimizer state is one file for both packages,
``{name}.opt.npz``, in the layout of the JAX package's optax state
(``train.optim.optax_layout``: the keys, shapes and dtypes its
``save_pytree_npz`` writes, the moments in the JAX tree's layouts, a bf16
first moment stored as exact fp32), so a resume across the packages
continues Adam's moments and update count. The port reads a JAX-written file
and the JAX package reads the port's. A run directory that an earlier port
wrote (``{name}.torch_opt.npz``: per trainable parameter the torch state
tensors keyed ``state/<key>/<JAX tree path>`` in the torch layout, the
``count``, ``lr`` and ``notfinite`` scalars, and ``torch_opt`` in the meta)
still resumes; a save removes that older file. A save without optimizer
state removes a ``{name}.opt.npz`` left beside older weights, so no
checkpoint pairs state with weights newer than it. The
npz format is the only one: an orbax checkpoint (the JAX package's other
backend) raises, naming the npz format. Under data parallelism the trainers
save from rank 0 alone, as the JAX package saves from process 0.

Reference import: ``best_cap_model.pt`` / ``best_prop_model.pt`` (PyTorch
zip pickles holding a pickled Config object and a state_dict, DataParallel
``module.`` prefixes in the captioner's; reference:
scripts/eval_on_learned_props.py:80-95, sample/single_video_prediction.py:95)
become JAX-layout numpy trees by the key maps below, then modules through
``load_jax_params``: one mapping onto modules for both formats. The exports
invert the maps, so the port's models run in the reference implementation.

LoRA adapters: a finetuned archive loads with its adapters (the linears
carry them, ``ops.lora``), ``save_lora_npz`` writes the adapter leaves alone
and ``load_lora_sites`` reads them for serving, under the JAX tree's paths,
so an adapter saved by either package loads in the other; the exports fold
adapters into the weights first, and a LoRA finetune seeds a new run
(``load_pretrained_cap_params``) with its adapters folded in. A MoE
captioner saves and loads like any other (its router and experts keep their
JAX layout) but has no ``.pt`` export: the reference's FFNs are dense.

The uni-modal models (``--modality audio|video``) load from both formats:
their reference ``.pt`` files import through ``import_unimodal_cap_model``
(told apart by the ``trg_emb`` caption embedding) and
``import_unimodal_prop_model`` (by the pickled config's modality), and a
native directory builds the model of its config's modality. As in the JAX
package, they have no ``.pt`` export. Not ported: the orbax backend.
'''
from __future__ import annotations

import json
import os
import re
import sys
import types
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from bmt_tpu_torch.config import Config
from bmt_tpu_torch.data.vocab import Vocab, build_vocab_from_meta
from bmt_tpu_torch.models import (CapModelDims, PropModelDims,
                                  captioner_class, proposal_class)
from bmt_tpu_torch.params import (LORA_LEAVES, SEP, _flatten,
                                  jax_weight_axes, load_jax_params,
                                  load_params_npz, named_jax_parameters,
                                  save_params_npz, to_jax_tree, unflatten)
from bmt_tpu_torch.train.optim import Optimizer

# the scalars of the layout an earlier port wrote ({name}.torch_opt.npz)
OPT_SCALARS = ('count', 'lr', 'notfinite')
# the torch state tensor of each optax moment
MOMENTS = {'mu': 'exp_avg', 'nu': 'exp_avg_sq', 'trace': 'momentum_buffer'}


def _orbax_only(ckpt_dir: str, name: str):
    raise ValueError(
        f'{ckpt_dir} holds {name} in the orbax format only; the port reads '
        f'the npz format ({name}.params.npz with {name}.meta.json), not '
        f'orbax')


def _has_orbax(ckpt_dir: str, name: str) -> bool:
    return any(os.path.exists(os.path.join(ckpt_dir, f'{name}{suffix}'))
               for suffix in ('.orbax', '.orbax.stale', '.orbax.meta.json'))


# ---------------------------------------------------------------------------
# native npz checkpoints with resume
# ---------------------------------------------------------------------------

def _json_meta_default(obj):
    '''Meta values must survive a JSON round trip: numpy arrays/scalars and
    torch tensors convert losslessly; anything else fails AT SAVE TIME
    (``default=str`` would stringify e.g. a stray array into its elided
    repr, corrupting it far from the save that caused it).'''
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    raise TypeError(
        f'checkpoint meta value of type {type(obj).__name__} is not '
        f'JSON-serializable: {obj!r:.80}')


def _restore_into(data: Dict[str, np.ndarray], like, origin: str):
    '''Rebuild the structure of ``like`` from a flat key->array dict,
    validating that every restored array matches the template leaf's shape
    (a silent shape drift would surface as a CUDA error or wrong math far
    from the load). Returns (tree, used_keys).'''
    used = set()

    def rebuild(t, prefix=''):
        if isinstance(t, dict):
            return {k: rebuild(v, f'{prefix}{k}{SEP}') for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            seq = [rebuild(v, f'{prefix}{i}{SEP}') for i, v in enumerate(t)]
            return tuple(seq) if isinstance(t, tuple) else seq
        key = prefix[:-1]
        used.add(key)
        arr = data[key]
        tpl_shape = getattr(t, 'shape', None)
        if tpl_shape is not None and tuple(arr.shape) != tuple(tpl_shape):
            raise ValueError(
                f'{origin}: array {key!r} has shape {tuple(arr.shape)} but '
                f'the restore template expects {tuple(tpl_shape)} — the '
                f'checkpoint was written for a different architecture')
        return arr

    return rebuild(like), used


def load_pytree_npz(path: str, like):
    '''Restore arrays into the structure of ``like`` (nested dicts/lists of
    arrays). Raises if the archive holds keys the template lacks — a silent
    drop (e.g. a GloVe-adapter subtree missing from a hand-built template)
    would surface as a shape error or wrong math far from the load.'''
    data = dict(np.load(path, allow_pickle=False))
    tree, used = _restore_into(data, like, path)
    leftover = sorted(set(data) - used)
    if leftover:
        raise KeyError(
            f'{path} holds {len(leftover)} arrays absent from the restore '
            f'template (first few: {leftover[:4]}) — the template was '
            f'built for a different architecture/options')
    return tree


def _fold_lora_flat(data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    '''Fold every ``<site>/lora_{a,b,s}`` triple of a flat key->array dict
    into its ``<site>/w`` (fp32 accumulate, as the JAX package's
    ``merge_linear_lora``) and drop the adapter keys. No-op on plain
    archives.'''
    merged = dict(data)
    for k in data:
        site, leaf = k.rsplit(SEP, 1) if SEP in k else ('', k)
        if leaf != 'lora_a':
            continue
        for companion in ('lora_b', 'lora_s'):
            ck = f'{site}{SEP}{companion}'
            if ck not in data:
                raise ValueError(
                    f'archive holds {k!r} but not its companion {ck!r} — '
                    f'an incomplete LoRA adapter triple cannot be folded')
        w_key = f'{site}{SEP}w'
        if w_key not in data:
            hint = (' (the site is int8-quantized — merge LoRA before '
                    'quantize_tree_int8, not after)'
                    if f'{site}{SEP}w_q8' in data else '')
            raise ValueError(
                f'archive holds LoRA adapters for site {site!r} but no '
                f'{w_key!r} base weight to fold them into{hint}')
        a = data[k].astype(np.float32)
        b = data[f'{site}{SEP}lora_b'].astype(np.float32)
        s = float(data[f'{site}{SEP}lora_s'])
        merged[w_key] = (merged[w_key].astype(np.float32) + (a @ b) * s
                         ).astype(data[w_key].dtype)
    return {k: v for k, v in merged.items()
            if k.rsplit(SEP, 1)[-1] not in LORA_LEAVES}


def _fold_lora(tree):
    '''A JAX-layout tree with every adapter folded into its base weight
    (the JAX package's ``merge_lora``); a plain tree as it is.'''
    flat = _flatten(tree)
    if not any(k.rsplit(SEP, 1)[-1] in LORA_LEAVES for k in flat):
        return tree
    return unflatten(_fold_lora_flat(flat))


def save_lora_npz(path: str, params) -> int:
    '''Write only the adapter leaves of a LoRA-adapted model (module or
    JAX-layout tree), keyed by their tree paths: the shippable artifact of a
    finetune, loadable by ``load_lora_sites`` in either package. Atomic;
    returns the number of adapted linears.'''
    flat = {k: v for k, v in _flatten(_params_tree(params)).items()
            if k.rsplit(SEP, 1)[-1] in LORA_LEAVES}
    if not flat:
        raise ValueError('tree carries no LoRA adapter leaves')
    tmp = f'{path}.tmp-{os.getpid()}'
    with open(tmp, 'wb') as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return len(flat) // 3


def load_lora_sites(path) -> Dict[str, dict]:
    '''The LoRA adapter leaves of a finetune as ``{site path: {'lora_a',
    'lora_b', 'lora_s'}}`` (numpy), the site keyed by the '/'-joined tree
    path of the adapted linear: what ``CaptionEngine.add_adapter`` takes.
    ``path``: a bare npz (``save_lora_npz``'s or a whole params archive), a
    native checkpoint directory (its ``best_cap_model.params.npz``), an
    adapted module or a JAX-layout tree.'''
    if isinstance(path, (dict, nn.Module)):
        flat = _flatten(_params_tree(path))
    else:
        npz = path
        if os.path.isdir(path):
            npz = os.path.join(path, 'best_cap_model.params.npz')
            if not os.path.exists(npz) and _has_orbax(path, 'best_cap_model'):
                _orbax_only(path, 'best_cap_model')
        with np.load(npz, allow_pickle=False) as data:
            flat = {k: data[k] for k in data.files}
    sites: Dict[str, dict] = {}
    for k, v in flat.items():
        site, leaf = k.rsplit(SEP, 1) if SEP in k else ('', k)
        if leaf in LORA_LEAVES:
            sites.setdefault(site, {})[leaf] = np.asarray(v)
    if not sites:
        raise ValueError(
            f'{path}: no LoRA adapter leaves found — not a '
            f'--lora_rank finetune checkpoint')
    for site, leaves in sites.items():
        missing = set(LORA_LEAVES) - set(leaves)
        if missing:
            raise ValueError(f'{path}: site {site!r} lacks {missing}')
    return sites


def load_subtree_npz(path: str, like, subtree: str = 'encoder'):
    '''Restore only the ``subtree`` branch of a FULL-checkpoint archive into
    the structure of ``like`` (the subtree itself, not the whole model): the
    native analog of the reference's encoder-weights filter (reference:
    model/proposal_generator.py:244-246 keeps ``'encoder' in k`` keys), so
    archive keys outside the subtree are ignored by design; template keys
    missing from the archive raise, and shapes are validated.

    A LoRA-finetuned archive (written by the JAX package) is a valid donor:
    its adapter deltas are folded into the base weights first, so the
    transplant carries the finetune's effective weights. Any other subtree
    key the template lacks raises.'''
    data = dict(np.load(path, allow_pickle=False))
    prefix = subtree + SEP
    sub = {k[len(prefix):]: v for k, v in data.items()
           if k.startswith(prefix)}
    if not sub:
        raise KeyError(
            f'{path} holds no arrays under {subtree!r}/ — not a checkpoint '
            f'of a model with that submodule (keys start with: '
            f'{sorted({k.split(SEP)[0] for k in data})})')
    sub = _fold_lora_flat(sub)
    tree, used = _restore_into(sub, like, f'{path}[{subtree}]')
    leftover = sorted(set(sub) - used)
    if leftover:
        raise KeyError(
            f'{path}[{subtree}] holds {len(leftover)} arrays absent from '
            f'the restore template even after folding LoRA adapters '
            f'(first few: {leftover[:4]}) — written for a different '
            f'architecture/options than this run configures')
    return tree


def _jax_moments(model: nn.Module, optimizer: Optimizer):
    '''Yield (moment, JAX path, parameter, its axes or None, trainable) for
    every moment that the optax layout holds.'''
    layout = optimizer.layout
    axes = jax_weight_axes(model)
    trainable = {id(p) for p in optimizer.params}
    for moment in MOMENTS:
        if moment not in layout:
            continue
        for path, p in named_jax_parameters(model):
            if id(p) in trainable or layout['all_moments']:
                yield (moment, SEP.join(map(str, path)), p, axes.get(id(p)),
                       id(p) in trainable)


def optimizer_state_tree(model: nn.Module, optimizer: Optimizer) -> dict:
    '''The optimizer's state as a flat {key: numpy array} dict (copies) in
    the layout of the JAX package's optax state for the same config and
    frozen mask (``train.optim.optax_layout``): the moments in the JAX
    tree's layouts, fp32 (frozen leaves carry zeros, as optax's do, unless
    Adam is masked), the counts int32, the learning rate fp32.'''
    layout = optimizer.layout
    scalars = {'count': np.int32(optimizer.calls),
               'learning_rate': np.float32(optimizer.lr),
               'notfinite_count': np.int32(optimizer.notfinite),
               'last_finite': np.bool_(optimizer.last_finite),
               'total_notfinite': np.int32(optimizer.total_notfinite),
               'adam_count': np.int32(optimizer.count),
               'schedule_count': np.int32(optimizer.count)}
    out = {layout[k]: np.asarray(v) for k, v in scalars.items()
           if k in layout}
    for moment, path, p, axes, trainable in _jax_moments(model, optimizer):
        value = (optimizer.inner.state.get(p, {}).get(MOMENTS[moment])
                 if trainable else None)
        if value is None:
            shape = p.shape if axes is None else [p.shape[a] for a in axes]
            arr = np.zeros(tuple(shape), np.float32)
        else:
            arr = value.detach().to('cpu', torch.float32, copy=True).numpy()
            arr = np.ascontiguousarray(arr if axes is None
                                       else arr.transpose(axes))
        out[f'{layout[moment]}{SEP}{path}'] = arr
    return out


@torch.no_grad()
def load_optimizer_state(model: nn.Module, optimizer: Optimizer,
                         flat: dict) -> None:
    '''Restore an optimizer state dict (``optimizer_state_tree``'s, or the
    one a JAX package's save of the same config writes) into
    ``optimizer`` (built over ``model``'s trainable parameters). The layout
    an earlier port wrote (``state/<key>/<path>`` keys) loads too. Raises
    on a missing or extra key and on a shape that does not fit.'''
    if 'count' in flat and 'notfinite' in flat:
        return _load_torch_layout(model, optimizer, flat)
    layout = optimizer.layout
    used = set()

    def take(key):
        if key not in flat:
            raise KeyError(f'optimizer state lacks {key!r}: written for '
                           f'another optimizer configuration (its keys '
                           f'start: {sorted(flat)[:4]})')
        used.add(key)
        return np.asarray(flat[key])

    def scalar(part, default):
        return take(layout[part]).item() if part in layout else default

    calls = int(take(layout['count']))
    count = int(scalar('adam_count', scalar('schedule_count', calls)))
    lr = take(layout['learning_rate'])
    states = {}
    for moment, path, p, axes, trainable in _jax_moments(model, optimizer):
        arr = take(f'{layout[moment]}{SEP}{path}')
        shape = p.shape if axes is None else [p.shape[a] for a in axes]
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f'optimizer state {moment!r} of {path!r} has '
                             f'shape {tuple(arr.shape)}, the parameter\'s '
                             f'JAX layout {tuple(shape)}')
        if not trainable or (moment != 'trace' and count == 0):
            continue
        arr = arr if axes is None else arr.transpose(axes)
        # a bf16 first moment (OptaxAdam) is stored as exact fp32
        dtype = (getattr(optimizer.inner, 'mu_dtype', p.dtype)
                 if moment == 'mu' else p.dtype)
        state = states.setdefault(p, {})
        state[MOMENTS[moment]] = torch.from_numpy(
            np.ascontiguousarray(arr)).to(p.device, dtype)
    leftover = sorted(set(flat) - used)
    if leftover:
        raise KeyError(f'optimizer state holds {len(leftover)} arrays that '
                       f'this optimizer has no place for (first: '
                       f'{leftover[0]!r}): written for another '
                       f'configuration or another model')
    _install_states(optimizer, states)
    optimizer.count, optimizer.calls = count, calls
    # the file holds the rate in fp32; a base rate that rounds to it stays
    if np.float32(optimizer.lr) != lr:
        optimizer.lr = float(lr)
    optimizer.notfinite = int(scalar('notfinite_count', 0))
    optimizer.total_notfinite = int(scalar('total_notfinite', 0))
    optimizer.last_finite = bool(scalar('last_finite', True))


@torch.no_grad()
def _install_states(optimizer: Optimizer, states: dict) -> None:
    '''Put {parameter: {key: tensor}} into the optimizer's state: copied
    into the tensors it holds where they have the same keys, shapes and
    dtypes (a CUDA graph of the train step holds their addresses,
    ``train.graphs``), else in their place. A parameter without a loaded
    state gets zero moments in place, which is a fresh optimizer's state
    (its moments start at zero), or none if it had none.'''
    for p in optimizer.params:
        old, new = optimizer.inner.state.get(p), states.get(p)
        if old and new is None:
            for t in old.values():
                t.zero_()
        elif old and old.keys() == new.keys() and all(
                old[k].shape == t.shape and old[k].dtype == t.dtype
                for k, t in new.items()):
            for k, t in new.items():
                old[k].copy_(t)
        elif new is not None:
            optimizer.inner.state[p] = new


def _param_paths(model: nn.Module) -> dict:
    '''{id(parameter): its JAX tree path joined by SEP}.'''
    return {id(p): SEP.join(map(str, path))
            for path, p in named_jax_parameters(model)}


def _load_torch_layout(model: nn.Module, optimizer: Optimizer,
                       flat: dict) -> None:
    '''The layout an earlier port wrote (``{name}.torch_opt.npz``): per
    trainable parameter its torch state tensors keyed
    ``state/<key>/<path>`` in the torch layout, and the ``count``, ``lr``
    and ``notfinite`` scalars.'''
    paths = _param_paths(model)
    by_path: dict = {}
    for k, arr in flat.items():
        if k in OPT_SCALARS:
            continue
        _, key, path = k.split(SEP, 2)
        by_path.setdefault(path, {})[key] = arr
    states = {}
    for p in optimizer.params:
        entries = by_path.pop(paths[id(p)], None)
        if entries is None:
            continue
        state = {}
        for key, arr in entries.items():
            if key == 'step':        # the optimizer's count stands for it
                continue
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f'optimizer state {key!r} of {paths[id(p)]!r} has shape '
                    f'{tuple(arr.shape)}, the parameter {tuple(p.shape)}')
            # a bf16 first moment (OptaxAdam) is saved as exact fp32
            dtype = (getattr(optimizer.inner, 'mu_dtype', p.dtype)
                     if key == 'exp_avg' else p.dtype)
            state[key] = torch.from_numpy(np.array(arr)).to(p.device, dtype)
        states[p] = state
    if by_path:
        raise KeyError(f'optimizer state for {len(by_path)} paths that are '
                       f'no trainable parameter (first: '
                       f'{sorted(by_path)[0]!r})')
    _install_states(optimizer, states)
    optimizer.count = optimizer.calls = int(flat['count'])
    optimizer.lr = float(flat['lr'])
    optimizer.notfinite = int(flat['notfinite'])


def _params_tree(params):
    return to_jax_tree(params) if isinstance(params, nn.Module) else params


def _opt_tree(params, opt_state):
    if isinstance(opt_state, Optimizer):
        if not isinstance(params, nn.Module):
            raise TypeError('an Optimizer is saved beside its model (an '
                            'nn.Module), which names its parameters')
        return optimizer_state_tree(params, opt_state)
    return opt_state


def save_checkpoint(ckpt_dir: str, params, meta: dict, opt_state=None,
                    name: str = 'best_cap_model'):
    '''``params``: an ``nn.Module`` (saved as its JAX-layout fp32 tree) or
    such a tree; ``meta``: JSON-serializable dict (config, epoch, metrics,
    vocab itos...); ``opt_state``: the model's ``Optimizer`` or the dict of
    ``optimizer_state_tree``. Every file is written atomically, meta last:
    on a crash mid-save the previous meta still pairs with the previous
    arrays.'''
    os.makedirs(ckpt_dir, exist_ok=True)
    opt_tree = None if opt_state is None else _opt_tree(params, opt_state)
    save_params_npz(os.path.join(ckpt_dir, f'{name}.params.npz'),
                    _params_tree(params))
    opt_path = os.path.join(ckpt_dir, f'{name}.opt.npz')
    if opt_tree is not None:
        save_params_npz(opt_path, opt_tree)
    elif os.path.exists(opt_path):
        os.remove(opt_path)                 # it belongs to older weights
    legacy = os.path.join(ckpt_dir, f'{name}.torch_opt.npz')
    if os.path.exists(legacy):
        os.remove(legacy)                   # an earlier port's, older too
    meta_path = os.path.join(ckpt_dir, f'{name}.meta.json')
    tmp = f'{meta_path}.tmp-{os.getpid()}'
    with open(tmp, 'w') as f:
        json.dump(meta, f, default=_json_meta_default)
    os.replace(tmp, meta_path)


def load_checkpoint(ckpt_dir: str, model: nn.Module,
                    optimizer: Optimizer = None,
                    name: str = 'best_cap_model'):
    '''Load the checkpoint ``name`` into ``model`` and, when given and the
    checkpoint holds its state, ``optimizer`` (both in place; missing,
    extra and misshapen arrays raise): ``{name}.opt.npz``, written by
    either package, or an earlier port's ``{name}.torch_opt.npz`` when the
    meta says that the port saved it with these weights. Returns (model,
    meta, optimizer), the last None when no optimizer state was restored:
    none asked for, or none saved (module docstring).'''
    load_model_params(ckpt_dir, name, model)
    with open(os.path.join(ckpt_dir, f'{name}.meta.json')) as f:
        meta = json.load(f)
    legacy = meta.pop('torch_opt', False)
    opt_path = os.path.join(ckpt_dir, f'{name}.opt.npz')
    if not os.path.exists(opt_path) and legacy:
        opt_path = os.path.join(ckpt_dir, f'{name}.torch_opt.npz')
    if optimizer is None or not os.path.exists(opt_path):
        return model, meta, None
    with np.load(opt_path, allow_pickle=False) as z:
        load_optimizer_state(model, optimizer, dict(z))
    return model, meta, optimizer


def read_checkpoint_meta(ckpt_dir: str, name: str) -> dict:
    '''The meta sidecar of the npz checkpoint ``name``.'''
    path = os.path.join(ckpt_dir, f'{name}.meta.json')
    if not os.path.exists(path):
        if _has_orbax(ckpt_dir, name):
            _orbax_only(ckpt_dir, name)
        raise FileNotFoundError(f'no {name} meta sidecar under {ckpt_dir}')
    with open(path) as f:
        return json.load(f)


def checkpoint_exists(ckpt_dir: str, name: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, f'{name}.params.npz'))


def load_model_params(ckpt_dir: str, name: str, model: nn.Module):
    '''The params of the npz checkpoint ``name`` into ``model``, in place
    (missing, extra and misshapen arrays raise); returns the model.'''
    if not checkpoint_exists(ckpt_dir, name):
        if _has_orbax(ckpt_dir, name):
            _orbax_only(ckpt_dir, name)
        raise FileNotFoundError(f'no {name} npz checkpoint under {ckpt_dir}')
    load_jax_params(model, load_params_npz(
        os.path.join(ckpt_dir, f'{name}.params.npz')))
    return model


class AsyncCheckpointWriter:
    '''Overlap checkpoint file IO with training.

    ``save()`` copies params and optimizer state to host arrays
    SYNCHRONOUSLY (the next step updates them in place), then hands
    serialization and file writes to a single worker thread and returns.
    The single worker keeps saves strictly ordered, so an older pending
    write can never clobber a newer rolling ``last_*`` checkpoint, and the
    atomic write-then-rename of ``save_checkpoint`` still holds.

    Worker errors are NOT swallowed: they re-raise on the next ``save()``
    or on ``wait()``, so a full disk cannot silently discard every epoch's
    checkpoint and let the process exit 0.'''

    def __init__(self, save_fn=save_checkpoint):
        import concurrent.futures as cf
        self._save_fn = save_fn
        self._pool = cf.ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix='bmt-ckpt')
        self._pending = []

    @staticmethod
    def _snapshot(tree):
        return {k: np.array(v, copy=True) for k, v in _flatten(tree).items()}

    def save(self, ckpt_dir: str, params, meta: dict, opt_state=None,
             name: str = 'best_cap_model'):
        self._reap()
        host_opt = (None if opt_state is None
                    else self._snapshot(_opt_tree(params, opt_state)))
        host_params = self._snapshot(_params_tree(params))
        self._pending.append(self._pool.submit(
            self._save_fn, ckpt_dir, host_params, meta, host_opt, name))

    def _reap(self):
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()  # re-raise worker errors at the call site

    def wait(self):
        '''Block until every submitted save is durably on disk.'''
        while self._pending:
            self._pending.pop(0).result()

    def close(self):
        self.wait()
        self._pool.shutdown()


def load_pretrained_encoder_native(path: str, encoder_like, stage: str):
    '''Encoder subtree from a native checkpoint of the other training stage
    (the reference's two-stage recipe: scripts/train_proposal_generator.py:15
    reuses the captioning encoder, model/captioning_module.py:147-162 the
    proposal encoder).

    ``path``: a bare ``*.npz`` params archive, or a native checkpoint
    directory holding ``best_{stage}_model.params.npz``. ``encoder_like``:
    the destination's encoder subtree as a template tree
    (``to_jax_tree(model.encoder)``). ``stage``: 'cap' or 'prop', the stage
    that wrote the checkpoint. Shapes are validated against the template.'''
    if stage not in ('cap', 'prop'):
        raise ValueError(f'stage {stage!r}: cap or prop')
    if not os.path.isdir(path):
        return load_subtree_npz(path, encoder_like)
    name = f'best_{stage}_model'
    if not checkpoint_exists(path, name) and _has_orbax(path, name):
        _orbax_only(path, name)
    return load_subtree_npz(os.path.join(path, f'{name}.params.npz'),
                            encoder_like)


# ---------------------------------------------------------------------------
# reference torch .pt import
# ---------------------------------------------------------------------------

class _ConfigShim:
    '''Stands in for the reference's pickled Config object
    (reference: eval_on_learned_props.py:80-83).'''

    def __init__(self, *a, **k):
        pass


def _install_config_shims():
    '''Unpickling reference checkpoints needs
    utilities.config_constructor.Config importable. Installed right before
    each load and save: another package in the process may have installed
    its own shim class there since.'''
    for mod_name in ('utilities', 'utilities.config_constructor'):
        if mod_name not in sys.modules:
            sys.modules[mod_name] = types.ModuleType(mod_name)
    sys.modules['utilities.config_constructor'].Config = _ConfigShim


def load_torch_checkpoint(path: str) -> dict:
    '''Load a reference .pt checkpoint; tensors -> numpy, pickled Config ->
    plain attribute dict. ``weights_only=False``: the file pickles a Config
    object, which torch's weights-only loader refuses; read only files of
    a source you trust.'''
    _install_config_shims()
    cpt = torch.load(path, map_location='cpu', weights_only=False)
    out = {}
    for k, v in cpt.items():
        if k == 'model_state_dict':
            out[k] = {name: t.detach().cpu().numpy()
                      for name, t in v.items()}
        elif k == 'config':
            out[k] = dict(getattr(v, '__dict__', {}))
        else:
            out[k] = v  # the optimizer/scheduler states stay opaque
    return out


def _strip_module(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    '''DataParallel wrap leaves a 'module.' key prefix
    (reference consequence of train_captioning_module.py:61).'''
    return {re.sub(r'^module\.', '', k): v for k, v in sd.items()}


def _lin(sd, base) -> dict:
    '''torch Linear (out,in) -> JAX layout (in,out).'''
    return {'w': np.ascontiguousarray(sd[f'{base}.weight'].T),
            'b': sd[f'{base}.bias']}


def _ln(sd, base) -> dict:
    return {'scale': sd[f'{base}.weight'], 'bias': sd[f'{base}.bias']}


def _mha(sd, base) -> dict:
    return {'q2d': _lin(sd, f'{base}.linear_Q2d'),
            'k2d': _lin(sd, f'{base}.linear_K2d'),
            'v2d': _lin(sd, f'{base}.linear_V2d'),
            'd2q': _lin(sd, f'{base}.linear_d2Q')}


def _ffn(sd, base) -> dict:
    return {'fc1': _lin(sd, f'{base}.fc1'), 'fc2': _lin(sd, f'{base}.fc2')}


def _vocab_embedder(sd, base) -> dict:
    '''Embedding table (plus optional adapter when GloVe width != d_model;
    reference: model/blocks.py:53-63).'''
    if f'{base}.embedder.weight' in sd:
        return {'table': sd[f'{base}.embedder.weight']}
    return {'table': sd[f'{base}.embedder.0.weight'],
            'adapter': _lin(sd, f'{base}.embedder.1')}


def _count_layers(sd, pattern: str) -> int:
    rx = re.compile(pattern)
    idxs = {int(m.group(1)) for k in sd if (m := rx.match(k))}
    return max(idxs) + 1 if idxs else 0


def _bimodal_encoder_from_sd(sd, prefix='encoder.encoder_AV.layers') -> dict:
    N = _count_layers(sd, rf'{re.escape(prefix)}\.(\d+)\.')
    layers = []
    for i in range(N):
        b = f'{prefix}.{i}'
        layers.append({
            'self_att_M1': _mha(sd, f'{b}.self_att_M1'),
            'self_att_M2': _mha(sd, f'{b}.self_att_M2'),
            'cross_att_M1': _mha(sd, f'{b}.bi_modal_att_M1'),
            'cross_att_M2': _mha(sd, f'{b}.bi_modal_att_M2'),
            'ff_M1': _ffn(sd, f'{b}.feed_forward_M1'),
            'ff_M2': _ffn(sd, f'{b}.feed_forward_M2'),
            'res_M1': [_ln(sd, f'{b}.res_layers_M1.{j}.norm') for j in range(3)],
            'res_M2': [_ln(sd, f'{b}.res_layers_M2.{j}.norm') for j in range(3)],
        })
    return {'layers': layers}


def _encoder_from_sd(sd, prefix='encoder.enc_layers') -> dict:
    '''The reference's uni-modal Encoder (self-attention, feed-forward, two
    residual norms a layer).'''
    N = _count_layers(sd, rf'{re.escape(prefix)}\.(\d+)\.')
    return {'layers': [{
        'self_att': _mha(sd, f'{prefix}.{i}.self_att'),
        'ff': _ffn(sd, f'{prefix}.{i}.feed_forward'),
        'res': [_ln(sd, f'{prefix}.{i}.res_layers.{j}.norm')
                for j in range(2)]} for i in range(N)]}


def import_cap_model(cpt: dict) -> Tuple[dict, dict]:
    '''Reference BiModalTransformer checkpoint -> (JAX-layout params tree,
    config dict). Key layout per model/captioning_module.py:101-187.'''
    sd = _strip_module(cpt['model_state_dict'])
    cfg = cpt.get('config', {})

    params = {
        'emb_C': _vocab_embedder(sd, 'emb_C'),
        'encoder': _bimodal_encoder_from_sd(sd),
        'generator': _lin(sd, 'generator.linear'),
    }
    if 'emb_A.embedder.weight' in sd:
        params['emb_A'] = {'linear': _lin(sd, 'emb_A.embedder')}
        params['emb_V'] = {'linear': _lin(sd, 'emb_V.embedder')}

    # decoder: decoder.decoder.layers.{i}
    N = _count_layers(sd, r'decoder\.decoder\.layers\.(\d+)\.')
    layers = []
    for i in range(N):
        b = f'decoder.decoder.layers.{i}'
        layers.append({
            'self_att': _mha(sd, f'{b}.self_att'),
            'enc_att_A': _mha(sd, f'{b}.enc_att_A'),
            'enc_att_V': _mha(sd, f'{b}.enc_att_V'),
            'bridge': {'norm': _ln(sd, f'{b}.bridge.norm'),
                       'linear': _lin(sd, f'{b}.bridge.linear')},
            'ff': _ffn(sd, f'{b}.feed_forward'),
            'res_self': _ln(sd, f'{b}.res_layer_self_att.norm'),
            'res_enc_A': _ln(sd, f'{b}.res_layer_enc_att_A.norm'),
            'res_enc_V': _ln(sd, f'{b}.res_layer_enc_att_V.norm'),
            'res_ff': _ln(sd, f'{b}.res_layer_ff.norm'),
        })
    params['decoder'] = {'layers': layers}
    return params, cfg


def _conv_head_from_sd(sd, base: str) -> dict:
    '''Detection head Sequential: classify entries by tensor rank
    (3-dim = Conv1d, pairs of 1-dim = LayerNorm).'''
    rx = re.compile(rf'{re.escape(base)}\.conv_layers\.(\d+)\.(weight|bias)')
    by_idx: Dict[int, dict] = {}
    for k, v in sd.items():
        m = rx.match(k)
        if m:
            by_idx.setdefault(int(m.group(1)), {})[m.group(2)] = v

    convs, lns = [], []
    for idx in sorted(by_idx):
        entry = by_idx[idx]
        w = entry['weight']
        if w.ndim == 3:  # torch Conv1d (out, in, k) -> (k, in, out)
            convs.append({'w': np.ascontiguousarray(w.transpose(2, 1, 0)),
                          'b': entry['bias']})
        else:            # LayerNorm
            lns.append({'scale': w, 'bias': entry['bias']})
    head = {'convs': convs}
    if lns:
        head['lns'] = lns
    return head


def import_prop_model(cpt: dict) -> Tuple[dict, dict]:
    '''Reference MultimodalProposalGenerator checkpoint -> (params, config).
    Key layout per model/proposal_generator.py:215-270. Anchors ride along
    in params as 'anchors_A'/'anchors_V'.'''
    sd = _strip_module(cpt['model_state_dict'])
    cfg = cpt.get('config', {})

    params = {'encoder': _bimodal_encoder_from_sd(sd)}
    if 'emb_A.embedder.weight' in sd:
        params['emb_A'] = {'linear': _lin(sd, 'emb_A.embedder')}
        params['emb_V'] = {'linear': _lin(sd, 'emb_V.embedder')}

    for mod, key in (('A', 'heads_A'), ('V', 'heads_V')):
        n = _count_layers(sd, rf'detection_layers_{mod}\.(\d+)\.')
        params[key] = [
            _conv_head_from_sd(sd, f'detection_layers_{mod}.{i}')
            for i in range(n)]

    anchors = cpt.get('anchors', {})
    if 'audio' in anchors:
        params['anchors_A'] = np.asarray(anchors['audio'], np.float32)
    if 'video' in anchors:
        params['anchors_V'] = np.asarray(anchors['video'], np.float32)
    return params, cfg


def import_unimodal_prop_model(cpt: dict, modality: str) -> Tuple[dict, dict]:
    '''Reference uni-modal ProposalGenerator checkpoint -> (params,
    config); the anchors of ``modality`` ride along as 'anchors'
    (reference: model/proposal_generator.py:50-120).'''
    sd = _strip_module(cpt['model_state_dict'])
    cfg = cpt.get('config', {})
    params = {'encoder': _encoder_from_sd(sd)}
    if 'emb.embedder.weight' in sd:
        params['emb'] = {'linear': _lin(sd, 'emb.embedder')}
    n = _count_layers(sd, r'detection_layers\.(\d+)\.')
    params['heads'] = [_conv_head_from_sd(sd, f'detection_layers.{i}')
                       for i in range(n)]
    anchors = cpt.get('anchors', {})
    if modality in anchors:
        params['anchors'] = np.asarray(anchors[modality], np.float32)
    return params, cfg


def import_unimodal_cap_model(cpt: dict) -> Tuple[dict, dict]:
    '''Reference uni-modal Transformer checkpoint -> (params, config)
    (reference: model/captioning_module.py:16-98).'''
    sd = _strip_module(cpt['model_state_dict'])
    cfg = cpt.get('config', {})
    params = {
        'trg_emb': _vocab_embedder(sd, 'trg_emb'),
        'encoder': _encoder_from_sd(sd),
        'generator': _lin(sd, 'generator.linear'),
    }
    if 'src_emb.embedder.weight' in sd:
        params['src_emb'] = {'linear': _lin(sd, 'src_emb.embedder')}
    N = _count_layers(sd, r'decoder\.dec_layers\.(\d+)\.')
    params['decoder'] = {'layers': [{
        'self_att': _mha(sd, f'decoder.dec_layers.{i}.self_att'),
        'enc_att': _mha(sd, f'decoder.dec_layers.{i}.enc_att'),
        'ff': _ffn(sd, f'decoder.dec_layers.{i}.feed_forward'),
        'res': [_ln(sd, f'decoder.dec_layers.{i}.res_layers.{j}.norm')
                for j in range(3)]} for i in range(N)]}
    return params, cfg


def import_any_cap_model(cpt: dict) -> Tuple[dict, dict]:
    '''``import_unimodal_cap_model`` or ``import_cap_model``, by the
    state dict's layout: the uni-modal captioners embed captions as
    'trg_emb', the bi-modal one as 'emb_C'.'''
    unimodal = any(k.startswith('trg_emb.')
                   for k in _strip_module(cpt['model_state_dict']))
    return (import_unimodal_cap_model(cpt) if unimodal
            else import_cap_model(cpt))


def cap_embedding_key(modality: str) -> str:
    '''The caption embedding's key: 'emb_C' in the bi-modal captioner,
    'trg_emb' in the uni-modal ones.'''
    return 'emb_C' if modality == 'audio_video' else 'trg_emb'


# ---------------------------------------------------------------------------
# export: reference-compatible state_dict naming
# ---------------------------------------------------------------------------

def _sd_put_lin(sd, base, p):
    sd[f'{base}.weight'] = np.ascontiguousarray(np.asarray(p['w']).T)
    sd[f'{base}.bias'] = np.asarray(p['b'])


def _sd_put_ln(sd, base, p):
    sd[f'{base}.weight'] = np.asarray(p['scale'])
    sd[f'{base}.bias'] = np.asarray(p['bias'])


def _sd_put_mha(sd, base, p):
    _sd_put_lin(sd, f'{base}.linear_Q2d', p['q2d'])
    _sd_put_lin(sd, f'{base}.linear_K2d', p['k2d'])
    _sd_put_lin(sd, f'{base}.linear_V2d', p['v2d'])
    _sd_put_lin(sd, f'{base}.linear_d2Q', p['d2q'])


def _sd_put_ffn(sd, base, p):
    if 'router' in p:
        raise ValueError(
            'cannot export a MoE model (--moe_experts > 1) to a '
            'reference-keyed state_dict: the reference architecture '
            'has dense FFNs only. Use the native npz checkpoint format for '
            'MoE models.')
    _sd_put_lin(sd, f'{base}.fc1', p['fc1'])
    _sd_put_lin(sd, f'{base}.fc2', p['fc2'])


def _sd_put_bimodal_encoder(sd, enc):
    '''BiModalEncoder subtree under the reference's shared attribute name
    (both the captioner and the proposal generator call it ``encoder``).'''
    for i, L in enumerate(enc['layers']):
        b = f'encoder.encoder_AV.layers.{i}'
        _sd_put_mha(sd, f'{b}.self_att_M1', L['self_att_M1'])
        _sd_put_mha(sd, f'{b}.self_att_M2', L['self_att_M2'])
        _sd_put_mha(sd, f'{b}.bi_modal_att_M1', L['cross_att_M1'])
        _sd_put_mha(sd, f'{b}.bi_modal_att_M2', L['cross_att_M2'])
        _sd_put_ffn(sd, f'{b}.feed_forward_M1', L['ff_M1'])
        _sd_put_ffn(sd, f'{b}.feed_forward_M2', L['ff_M2'])
        for j in range(3):
            _sd_put_ln(sd, f'{b}.res_layers_M1.{j}.norm', L['res_M1'][j])
            _sd_put_ln(sd, f'{b}.res_layers_M2.{j}.norm', L['res_M2'][j])


def export_cap_state_dict(params, data_parallel: bool = True) -> dict:
    '''Inverse of import_cap_model: a reference-keyed state_dict of numpy
    arrays from a captioner (module or JAX-layout tree). LoRA adapters are
    folded into the base weights first: the reference model has no adapter
    slots, and dropping a finetune's deltas would export another model.'''
    params = _fold_lora(_params_tree(params))
    sd = {}

    emb = params['emb_C']
    if 'adapter' in emb:
        sd['emb_C.embedder.0.weight'] = np.asarray(emb['table'])
        _sd_put_lin(sd, 'emb_C.embedder.1', emb['adapter'])
    else:
        sd['emb_C.embedder.weight'] = np.asarray(emb['table'])

    if 'emb_A' in params:
        _sd_put_lin(sd, 'emb_A.embedder', params['emb_A']['linear'])
        _sd_put_lin(sd, 'emb_V.embedder', params['emb_V']['linear'])

    _sd_put_bimodal_encoder(sd, params['encoder'])

    for i, L in enumerate(params['decoder']['layers']):
        b = f'decoder.decoder.layers.{i}'
        _sd_put_mha(sd, f'{b}.self_att', L['self_att'])
        _sd_put_mha(sd, f'{b}.enc_att_A', L['enc_att_A'])
        _sd_put_mha(sd, f'{b}.enc_att_V', L['enc_att_V'])
        _sd_put_ln(sd, f'{b}.bridge.norm', L['bridge']['norm'])
        _sd_put_lin(sd, f'{b}.bridge.linear', L['bridge']['linear'])
        _sd_put_ffn(sd, f'{b}.feed_forward', L['ff'])
        _sd_put_ln(sd, f'{b}.res_layer_self_att.norm', L['res_self'])
        _sd_put_ln(sd, f'{b}.res_layer_enc_att_A.norm', L['res_enc_A'])
        _sd_put_ln(sd, f'{b}.res_layer_enc_att_V.norm', L['res_enc_V'])
        _sd_put_ln(sd, f'{b}.res_layer_ff.norm', L['res_ff'])

    _sd_put_lin(sd, 'generator.linear', params['generator'])

    if data_parallel:
        sd = {f'module.{k}': v for k, v in sd.items()}
    return sd


def _conv_head_to_sd(sd, base: str, head: dict, dout_p: bool = True):
    '''Inverse of _conv_head_from_sd, reconstructing the EXACT Sequential
    indices of the reference head (model/proposal_generator.py:11-38):
    per block n — [Transpose, LayerNorm, Transpose] when layer_norm, then
    Conv1d, then [Dropout (when dout_p>0), ReLU] for every block but the
    last. Only LayerNorm/Conv1d carry parameters, so the index arithmetic
    must skip the parameter-free modules for torch load_state_dict
    (strict=True) to accept the result.'''
    convs = head['convs']
    lns = head.get('lns')
    idx = 0
    for n, conv in enumerate(convs):
        if lns is not None:
            _sd_put_ln(sd, f'{base}.conv_layers.{idx + 1}', lns[n])
            idx += 3
        w = np.asarray(conv['w'])   # (k, in, out) -> torch (out, in, k)
        sd[f'{base}.conv_layers.{idx}.weight'] = np.ascontiguousarray(
            w.transpose(2, 1, 0))
        sd[f'{base}.conv_layers.{idx}.bias'] = np.asarray(conv['b'])
        idx += 1
        if n < len(convs) - 1:
            idx += (1 if dout_p else 0) + 1   # Dropout?, ReLU


def export_prop_state_dict(params, data_parallel: bool = False,
                           dout_p: bool = True) -> dict:
    '''Inverse of import_prop_model: a reference-keyed
    MultimodalProposalGenerator state_dict (numpy arrays) from a proposal
    generator (module or tree). The reference trains the proposal stage
    single-device (no DataParallel wrap —
    scripts/train_proposal_generator.py:54), so no ``module.`` prefix by
    default. ``dout_p``: whether the receiving model was built with
    dout_p > 0 (it shifts the heads' Sequential indices). LoRA adapters
    are folded in first, as in export_cap_state_dict.'''
    params = _fold_lora(_params_tree(params))
    sd = {}
    if 'emb_A' in params:
        _sd_put_lin(sd, 'emb_A.embedder', params['emb_A']['linear'])
        _sd_put_lin(sd, 'emb_V.embedder', params['emb_V']['linear'])
    _sd_put_bimodal_encoder(sd, params['encoder'])
    for mod, key in (('A', 'heads_A'), ('V', 'heads_V')):
        for i, head in enumerate(params[key]):
            _conv_head_to_sd(sd, f'detection_layers_{mod}.{i}', head,
                             dout_p)
    if data_parallel:
        sd = {f'module.{k}': v for k, v in sd.items()}
    return sd


def _pickled_config(meta: dict):
    '''The meta's config dict as an instance of the shim class, pickled
    under the module and name the reference expects, so its own Config
    class unpickles it.'''
    _install_config_shims()
    cls = sys.modules['utilities.config_constructor'].Config
    cls.__module__ = 'utilities.config_constructor'
    cls.__qualname__ = 'Config'
    cfg = cls()
    cfg.__dict__.update(meta.get('config', {}))
    return cfg


def _torch_sd(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def save_torch_checkpoint(path: str, params, meta: dict):
    '''Write a reference-format best_cap_model.pt so models trained here can
    be loaded by the original PyTorch implementation (its loaders re-read the
    pickled config and state_dict — eval_on_learned_props.py:86-124).
    ``params``: a bi-modal captioner (module or tree).'''
    params = _params_tree(params)
    if 'emb_C' not in params:
        raise ValueError(
            'save_torch_checkpoint exports the bi-modal captioner layout '
            "only (params have no 'emb_C' — a uni-modal tree?)")
    sd = _torch_sd(export_cap_state_dict(params))
    torch.save({
        'config': _pickled_config(meta),
        'epoch': meta.get('epoch', 0),
        'model_state_dict': sd,
        'optimizer_state_dict': {},
        'val_1_loss': meta.get('val_1_loss'),
        'val_2_loss': meta.get('val_2_loss'),
        'val_1_metrics': meta.get('val_1_metrics'),
        'val_2_metrics': meta.get('val_2_metrics'),
        # the table's rows when meta has no size: the reference's loaders
        # (and both packages') check the rebuilt vocabulary against it
        'trg_voc_size': (meta.get('trg_voc_size')
                         or int(params['emb_C']['table'].shape[0])),
    }, path)


def save_torch_prop_checkpoint(path: str, params, meta: dict,
                               dout_p: 'bool | None' = None):
    '''Write a reference-format best_prop_model.pt (the dict layout of
    epoch_loops/proposal_epoch_loops.py:10-25, incl. the top-level anchors
    dict the reference re-loads at inference —
    sample/single_video_prediction.py:103-106).

    ``dout_p`` shifts the conv heads' Sequential indices; when None it is
    read from the checkpoint's own config in ``meta`` (a model trained
    with --dout_p 0 has no Dropout slots), defaulting to True only when
    the config carries no dout_p at all.'''
    if dout_p is None:
        dout_p = bool(meta.get('config', {}).get('dout_p', True))
    params = _params_tree(params)
    if 'heads_A' not in params:
        raise ValueError(
            'save_torch_prop_checkpoint exports the multimodal proposal '
            "generator layout only (params have no 'heads_A' — a "
            'uni-modal tree?)')
    sd = _torch_sd(export_prop_state_dict(params, dout_p=dout_p))
    torch.save({
        'config': _pickled_config(meta),
        'epoch': meta.get('epoch', 0),
        'model_state_dict': sd,
        'optimizer_state_dict': {},
        'scheduler_state_dict': None,
        'anchors': {'audio': np.asarray(params['anchors_A']).tolist(),
                    'video': np.asarray(params['anchors_V']).tolist()},
        'val_anet_metrics': meta.get('val_anet_metrics'),
        'best_metric': meta.get('best_metric'),
    }, path)


# ---------------------------------------------------------------------------
# the loaders of the entry points
# ---------------------------------------------------------------------------

def load_cap_checkpoint(path: str, train_meta_path: str = None,
                        allow_vocab_drift: bool = False, device='cuda'):
    '''Load a captioner checkpoint from either format; returns (cfg, dims,
    model, vocab), the model (``BiModalTransformer``, or
    ``UniModalTransformer`` for a uni-modal checkpoint) built on ``device``
    (the card unless the caller names another; without a card the default
    raises) in eval mode (reference analog:
    sample/single_video_prediction.py:95-117 for the .pt side).

    - ``path`` ending in ``.pt``: reference PyTorch pickle, bi-modal or
      uni-modal by its state dict's layout; the vocabulary is rebuilt from
      ``train_meta_path`` and checked against the checkpoint's vocabulary
      size. A size mismatch RAISES (decoding with a drifted id->word map
      yields silently garbled captions) unless ``allow_vocab_drift=True``
      explicitly overrides.
    - otherwise: native npz dir containing ``best_cap_model.*``; config and
      vocab itos come from the meta JSON (no rebuild, so no drift). A LoRA
      finetune's archive loads with its adapters on their linears.
    '''
    if path.endswith('.pt'):
        cpt = load_torch_checkpoint(path)
        params, cfg_dict = import_any_cap_model(cpt)
        cfg = Config.from_dict(cfg_dict)
        if not train_meta_path:
            raise ValueError('.pt checkpoints need a train_meta_path to '
                             'rebuild the vocabulary')
        cfg.train_meta_path = train_meta_path
        vocab = build_vocab_from_meta(train_meta_path, cfg.start_token,
                                      cfg.end_token, cfg.pad_token,
                                      cfg.min_freq_caps)
        emb = params['trg_emb' if 'trg_emb' in params else 'emb_C']
        voc_size = cpt.get('trg_voc_size') or emb['table'].shape[0]
        if len(vocab) != voc_size:
            msg = (f'rebuilt vocab size {len(vocab)} != checkpoint voc '
                   f'size {voc_size} ({train_meta_path} is not the CSV '
                   f'this model was trained on) — decoded captions would '
                   f'be garbled')
            if not allow_vocab_drift:
                raise ValueError(
                    msg + '; pass --allow_vocab_drift to proceed anyway')
            print(f'warning: {msg} (override active)', file=sys.stderr)
        dims = CapModelDims.from_config(cfg, emb['table'].shape[0])
        model = captioner_class(dims)(
            dims, device=device,
            table_dim=emb['table'].shape[1] if 'adapter' in emb else None)
        load_jax_params(model, params)
        return cfg, dims, model.eval(), vocab

    meta = read_checkpoint_meta(path, 'best_cap_model')
    cfg = Config.from_dict(meta['config'])
    vocab = Vocab(meta['vocab_itos'])
    dims = CapModelDims.from_config(cfg, len(vocab))
    model = captioner_class(dims)(
        dims, device=device,
        table_dim=native_table_dim(path, emb_key=cap_embedding_key(
            cfg.modality)))
    load_model_params(path, 'best_cap_model', model)
    return cfg, dims, model.eval(), vocab


def native_table_dim(path: str, name: str = 'best_cap_model',
                     emb_key: str = 'emb_C'):
    '''The caption-embedding table's width when the npz checkpoint ``name``
    under ``path`` carries the GloVe adapter (an '<emb_key>/adapter'
    Linear, present when the vectors' width differs from the captioner's
    caption width), else None.'''
    npz_path = os.path.join(path, f'{name}.params.npz')
    if os.path.exists(npz_path):
        with np.load(npz_path) as z:
            if f'{emb_key}{SEP}adapter{SEP}w' in z.files:
                return z[f'{emb_key}{SEP}table'].shape[1]
    return None


def load_pretrained_cap_params(path: str, model: nn.Module) -> None:
    '''The whole captioner's weights into ``model``, in place: the seed of
    train_cap's ``--pretrained_cap_model_path`` (continued training; the
    JAX package's ``load_pretrained_cap_params``). ``path``: a native
    checkpoint directory (its ``best_cap_model``), a bare ``*.params.npz``
    or a reference .pt, bi-modal or uni-modal. Missing, extra and misshapen
    arrays raise. A LoRA finetune's archive seeds the model with its
    adapters folded into the base weights (``_fold_lora``), as the JAX
    package's does: a new run's own ``--lora_rank`` puts fresh adapters on
    top.'''
    if path.endswith('.pt'):
        tree = import_any_cap_model(load_torch_checkpoint(path))[0]
    else:
        if os.path.isdir(path):
            if not checkpoint_exists(path, 'best_cap_model') and _has_orbax(
                    path, 'best_cap_model'):
                _orbax_only(path, 'best_cap_model')
            path = os.path.join(path, 'best_cap_model.params.npz')
        tree = load_params_npz(path)
    load_jax_params(model, _fold_lora(tree))


def load_prop_checkpoint(path: str, max_prop_per_vid: int = None,
                         device='cuda'):
    '''Load a proposal-generator checkpoint (.pt or native npz dir); returns
    (cfg, dims, model), the model (``MultimodalProposalGenerator``, or
    ``UnimodalProposalGenerator`` for a uni-modal one) with its anchors
    built on ``device`` (the card by default, as ``load_cap_checkpoint``) in
    eval mode (reference analog: sample/single_video_prediction.py:66-91).
    ``max_prop_per_vid`` overrides the config's.'''
    params = None
    if path.endswith('.pt'):
        cpt = load_torch_checkpoint(path)
        modality = cpt.get('config', {}).get('modality', 'audio_video')
        if modality == 'audio_video':
            params, cfg_dict = import_prop_model(cpt)
            if 'anchors_A' not in params or 'anchors_V' not in params:
                raise KeyError(f'{path} has no audio and video anchors')
        else:
            params, cfg_dict = import_unimodal_prop_model(cpt, modality)
            if 'anchors' not in params:
                raise KeyError(f'{path} has no {modality} anchors')
    else:
        cfg_dict = read_checkpoint_meta(path, 'best_prop_model')['config']
    if max_prop_per_vid is not None:
        cfg_dict['max_prop_per_vid'] = max_prop_per_vid
    cfg = Config.from_dict(cfg_dict)
    dims = PropModelDims.from_config(cfg)
    model = proposal_class(dims)(dims, device=device)
    if params is not None:
        load_jax_params(model, params)
    else:
        load_model_params(path, 'best_prop_model', model)
    return cfg, dims, model.eval()
