'''Optimizers and learning-rate control (counterpart of
``bmt_tpu.train.optim``), with torch semantics as the reference trainers use
them (reference: scripts/train_captioning_module.py:46-58).

``build_optimizer`` gives an ``Optimizer`` whose ``step()`` applies, in the
order of the JAX package's optax chain:

1. the ``--skip_nonfinite_grads N`` guard (``optax.apply_if_finite``): a
   step whose gradients hold a NaN or inf changes neither the parameters nor
   the optimizer state; after N consecutive such steps the update passes
   through, so the failure surfaces instead of looping forever;
2. global-norm clipping of the raw gradients over the trainable parameters
   (``optax.clip_by_global_norm``: g * max_norm / ||g|| when ||g|| >=
   max_norm; unlike ``torch.nn.utils.clip_grad_norm_`` no 1e-6 is added);
3. L2 weight decay into the gradient and Adam (``torch.optim.Adam``, not
   AdamW), or SGD with momentum (``torch.optim.SGD``, whose momentum buffer
   starts at the first gradient, as ``optax.trace`` does from zeros). With
   ``--optim_mu_dtype bfloat16`` Adam keeps its first moment in bf16 and its
   second in fp32; ``torch.optim.Adam`` keeps one dtype, so that option runs
   ``OptaxAdam``, which follows ``optax.scale_by_adam(mu_dtype=...)`` step
   for step;
4. the learning rate times the ``warmup_cosine`` multiplier of the update
   count, equal to ``optax.warmup_cosine_decay_schedule`` /
   ``linear_schedule`` at every count.

Frozen parameters, chosen by a predicate on the JAX tree path of each
parameter (as ``freeze_mask``), get ``requires_grad=False`` and no state:
with ``--lora_rank`` that leaves state for the adapters alone, as the JAX
package's masked Adam does.

``optax_layout`` names where the JAX package's optax state (``inject_hyperparams``
over the chain above, with ``apply_if_finite`` around it) keeps each part, as
the ``/``-joined keys that its ``save_pytree_npz`` writes; the checkpoint
module converts the port's state to and from that layout, so one optimizer
file serves both packages.
'''
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from bmt_tpu_torch.params import named_jax_parameters


def schedule_multiplier(cfg, total_steps: Optional[int] = None
                        ) -> Optional[Callable[[int], float]]:
    '''The per-update learning-rate multiplier of ``--scheduler
    warmup_cosine`` as a function of the update count, or None for a
    constant rate.'''
    if getattr(cfg, 'scheduler', 'constant') != 'warmup_cosine':
        return None
    warm = max(int(getattr(cfg, 'warmup_steps', 0) or 0), 0)
    floor = float(getattr(cfg, 'lr_final_ratio', 0.0) or 0.0)
    total = int(total_steps or getattr(cfg, 'lr_total_steps', 0) or 0)
    init = 0.0 if warm else 1.0

    def linear(count, steps):          # optax.linear_schedule(init, 1.0)
        if steps <= 0:
            return init
        c = min(max(count, 0), steps)
        return (init - 1.0) * (1.0 - c / steps) + 1.0

    if total <= warm:
        # no (usable) step budget: linear warmup, then flat
        return lambda count: linear(count, max(warm, 1))

    def warmup_cosine(count):
        if count < warm:
            return linear(count, warm)
        c = min(count - warm, total - warm)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / (total - warm)))
        return (1.0 - floor) * cosine + floor
    return warmup_cosine


class OptaxAdam(torch.optim.Optimizer):
    '''Adam with L2 weight decay into the gradient, in the order and
    rounding of ``optax.add_decayed_weights`` then ``optax.scale_by_adam``
    with ``mu_dtype``, the first moment ``exp_avg`` stored in ``mu_dtype``
    and the second ``exp_avg_sq`` in fp32:

      mu = (1 - b1) g + b1 mu_stored   (b1 mu_stored in mu_dtype, b1 rounded
                                        to it, as JAX's weak-typed scalar)
      nu = (1 - b2) g^2 + b2 nu
      p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with mu itself, not its stored rounding, in the update; then mu is
    stored. State keys as ``torch.optim.Adam``'s (``step``, ``exp_avg``,
    ``exp_avg_sq``), so a checkpoint names them alike.'''

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype=torch.bfloat16):
        super().__init__(params, {'lr': lr, 'betas': betas, 'eps': eps,
                                  'weight_decay': weight_decay})
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group['betas']
            wd, eps, lr = group['weight_decay'], group['eps'], group['lr']
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
            corrections = {}
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad + wd * p
                state = self.state[p]
                if not state:
                    state['step'] = torch.zeros((), dtype=torch.float32)
                    state['exp_avg'] = torch.zeros_like(
                        p, dtype=self.mu_dtype)
                    state['exp_avg_sq'] = torch.zeros_like(
                        p, dtype=torch.float32)
                state['step'] += 1
                mu = (1 - b1) * g + state['exp_avg'] * b1_mu
                nu = state['exp_avg_sq']
                nu.mul_(b2).add_((1 - b2) * (g * g))
                # 1 - b^t in fp32, as device tensors: a CPU scalar divisor
                # would be applied on the card as its reciprocal
                key = (int(state['step']), p.device)
                if key not in corrections:
                    corrections[key] = [
                        (1 - torch.tensor(b, dtype=torch.float32) ** key[0])
                        .to(p.device) for b in (b1, b2)]
                bc1, bc2 = corrections[key]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                p.add_(u * -lr)
                state['exp_avg'].copy_(mu)


def optax_layout(cfg, masked: bool) -> dict:
    '''Where ``bmt_tpu.train.optim.build_optimizer(cfg, frozen_mask)``'s
    state keeps each part, as the key prefixes that ``save_pytree_npz``
    writes (``masked``: a frozen mask was given, as the trainers always
    give one). The state is ``inject_hyperparams``' (count, hyperparams,
    hyperparams' states, inner state); the inner state is
    ``apply_if_finite``'s (notfinite_count, last_finite, total_notfinite,
    chain) with ``--skip_nonfinite_grads``, else the chain itself, a tuple
    with one entry per transform: the masked zeroing of frozen gradients,
    the clip, the decay, Adam (count, mu, nu; under ``optax.masked`` with
    LoRA) or SGD's trace, the schedule's count, then the stateless scales.
    Returns {part: prefix} for the parts that exist, and 'all_moments': do
    frozen leaves carry moments (zeros), as they do unless Adam is
    masked.'''
    skip = int(getattr(cfg, 'skip_nonfinite_grads', 0) or 0) > 0
    inner = '3/3' if skip else '3'
    i = (int(masked) + int(getattr(cfg, 'grad_clip', None) is not None)
         + int(bool(getattr(cfg, 'weight_decay', 0.0) or 0.0)))
    out = {'count': '0', 'learning_rate': '1/learning_rate',
           'all_moments': True}
    if skip:
        out.update(notfinite_count='3/0', last_finite='3/1',
                   total_notfinite='3/2')
    if cfg.optimizer == 'adam':
        lora = masked and bool(getattr(cfg, 'lora_rank', 0))
        adam = f'{inner}/{i}' + ('/0' if lora else '')
        out.update(adam_count=f'{adam}/0', mu=f'{adam}/1', nu=f'{adam}/2',
                   all_moments=not lora)
        i += 1
    elif getattr(cfg, 'momentum', 0.0):
        out['trace'] = f'{inner}/{i}/0'
        i += 1
    if getattr(cfg, 'scheduler', 'constant') == 'warmup_cosine':
        out['schedule_count'] = f'{inner}/{i}/0'
    return out


class Optimizer:
    '''Adam or SGD over the trainable parameters, with the clip, the
    non-finite guard and the schedule of ``build_optimizer``.

    ``lr`` is the base learning rate (``set_learning_rate`` changes it);
    ``count`` the number of updates applied, ``calls`` that of ``step()``
    calls (skipped ones too), ``notfinite`` the streak of non-finite
    gradients, ``total_notfinite`` and ``last_finite`` their total and the
    last step's verdict (the counters of ``optax.apply_if_finite``).
    ``step()`` reads each parameter's ``.grad`` (a trainable parameter
    without one counts as a zero gradient, as in the JAX tree) and returns
    the global norm of the raw gradients, a device scalar. ``layout``: the
    optax layout of the state (``optax_layout``, ``masked`` telling whether
    a frozen predicate was given). ``shards``: set by
    ``parallel.sharding_rules.ParamShards`` when some parameters are
    shards; the norm is then the whole model's and the non-finite verdict
    every rank's.'''

    def __init__(self, params: list, cfg, total_steps: Optional[int] = None,
                 masked: bool = False):
        self.params = params
        self.lr = float(cfg.lr)
        self.grad_clip = getattr(cfg, 'grad_clip', None)
        self.skip_nonfinite = int(getattr(cfg, 'skip_nonfinite_grads', 0)
                                  or 0)
        self.schedule = schedule_multiplier(cfg, total_steps)
        self.layout = optax_layout(cfg, masked)
        self.count = 0
        self.calls = 0
        self.notfinite = 0
        self.total_notfinite = 0
        self.last_finite = True
        self.shards = None
        wd = getattr(cfg, 'weight_decay', 0.0) or 0.0
        if not params:
            raise ValueError('no trainable parameters')
        if cfg.optimizer == 'adam':
            mu_dtype = getattr(cfg, 'optim_mu_dtype', 'float32') or 'float32'
            if mu_dtype not in ('float32', 'bfloat16'):
                raise ValueError(f'--optim_mu_dtype {mu_dtype!r}: float32 or '
                                 f'bfloat16')
            adam = torch.optim.Adam if mu_dtype == 'float32' else OptaxAdam
            self.inner = adam(
                params, lr=self.lr, betas=(getattr(cfg, 'beta1', 0.9),
                                           getattr(cfg, 'beta2', 0.999)),
                eps=getattr(cfg, 'eps', 1e-8), weight_decay=wd)
        elif cfg.optimizer == 'sgd':
            self.inner = torch.optim.SGD(
                params, lr=self.lr, momentum=getattr(cfg, 'momentum', 0.0),
                weight_decay=wd)
        else:
            raise ValueError(cfg.optimizer)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norms = torch.stack(torch._foreach_norm(grads))
        norm = (torch.linalg.vector_norm(norms) if self.shards is None
                else self.shards.global_norm(self.params, norms))
        self.calls += 1
        if self.skip_nonfinite:
            # one host sync a step, only with the guard on
            amax = torch.stack(torch._foreach_norm(grads, math.inf))
            self.last_finite = bool(torch.isfinite(amax).all())
            if self.shards is not None:      # one verdict for every rank
                self.last_finite = not self.shards.dp.any(
                    not self.last_finite)
            if self.last_finite:
                self.notfinite = 0
            else:
                self.notfinite += 1
                self.total_notfinite += 1
                if self.notfinite <= self.skip_nonfinite:
                    return norm
        if self.grad_clip is not None:
            factor = torch.where(norm < self.grad_clip, 1.0,
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.lr * (self.schedule(self.count) if self.schedule else 1.0)
        for group in self.inner.param_groups:
            group['lr'] = lr
        self.inner.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def build_optimizer(cfg, model: nn.Module,
                    frozen: Optional[Callable[[tuple], bool]] = None,
                    total_steps: Optional[int] = None) -> Optimizer:
    '''cfg needs: optimizer, lr, grad_clip, weight_decay and (adam)
    beta1/2, eps or (sgd) momentum; optionally scheduler, warmup_steps,
    lr_final_ratio, lr_total_steps and skip_nonfinite_grads.
    ``frozen(path) -> bool`` picks frozen parameters by their JAX tree path
    (``params.named_jax_parameters``); they are set to
    ``requires_grad=False``. ``total_steps``: the run's step budget for
    warmup_cosine.'''
    trainable = []
    for path, p in named_jax_parameters(model):
        if frozen is not None and frozen(path):
            p.requires_grad_(False)
        elif p.requires_grad:
            trainable.append(p)
    return Optimizer(trainable, cfg, total_steps, masked=frozen is not None)


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    '''Replace the base learning rate (in place).'''
    optimizer.lr = float(lr)


def get_learning_rate(optimizer: Optimizer) -> float:
    return optimizer.lr


class ReduceLROnPlateau:
    '''Host-side metric-driven LR scheduler (torch semantics: mode 'min',
    multiply LR by factor after `patience` epochs without improvement);
    the JAX package's class, which is plain Python.'''

    def __init__(self, init_lr: float, factor: float, patience: int,
                 mode: str = 'min', threshold: float = 1e-4):
        self.lr = init_lr
        # --lr_reduce_factor / --lr_patience default to None in the CLI;
        # fall back to torch's own defaults (factor=0.1, patience=10)
        self.factor = factor if factor is not None else 0.1
        self.patience = patience if patience is not None else 10
        self.mode = mode
        self.threshold = threshold   # torch default: rel mode, 1e-4
        self.best = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        # torch 'rel' threshold: noise-level drift is not an improvement
        improved = (self.best is None
                    or (self.mode == 'min'
                        and metric < self.best * (1.0 - self.threshold))
                    or (self.mode == 'max'
                        and metric > self.best * (1.0 + self.threshold)))
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr *= self.factor
                self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {'lr': self.lr, 'best': self.best,
                'bad_epochs': self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = d['lr']
        self.best = d['best']
        self.bad_epochs = d['bad_epochs']
