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
3. L2 weight decay into the gradient and Adam (``OptaxAdam``, not AdamW:
   ``optax.scale_by_adam`` step for step, its first moment in
   ``--optim_mu_dtype``), or SGD with momentum (``OptaxSGD``:
   ``optax.trace`` from zeros);
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

import functools
import math
from typing import Callable, Optional

import torch
from torch import nn

from bmt_tpu_torch.params import named_jax_parameters


def schedule_multiplier(cfg, total_steps: Optional[int] = None
                        ) -> Optional[Callable[[int], float]]:
    '''The per-update learning-rate multiplier of ``--scheduler
    warmup_cosine`` as a function of the update count, or None for a
    constant rate. Its ``horizon`` is the count from which it stays
    constant.'''
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
        def warmup(count):
            return linear(count, max(warm, 1))
        warmup.horizon = max(warm, 1)
        return warmup

    def warmup_cosine(count):
        if count < warm:
            return linear(count, warm)
        c = min(count - warm, total - warm)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / (total - warm)))
        return (1.0 - floor) * cosine + floor
    warmup_cosine.horizon = total
    return warmup_cosine


def _gated(apply, new, old):
    '''``new`` where ``apply`` (a device bool) holds, else ``old``; every
    tensor when ``apply`` is None.'''
    if apply is None:
        return new
    return [torch.where(apply, n, o) for n, o in zip(new, old)]


@functools.lru_cache(maxsize=None)
def correction_table(b: float) -> torch.Tensor:
    '''1 - b^t in fp32 for t = 1, 2, ... until b^t no longer moves it from
    1 (the last row then stands for every later t), each rounded as the
    host computed it before the count moved to the device:
    ``1 - torch.tensor(b, dtype=torch.float32) ** t`` (the power of a
    Python int, which rounds unlike a power of a tensor of exponents).'''
    base = torch.tensor(b, dtype=torch.float32)
    n = 1 if b <= 0.0 else max(1, math.ceil(-27 / math.log2(b)) + 1)
    return torch.stack([1 - base ** t for t in range(1, n + 1)])


class OptaxAdam(torch.optim.Optimizer):
    '''Adam with L2 weight decay into the gradient, in the order and
    rounding of ``optax.add_decayed_weights`` then ``optax.scale_by_adam``
    with ``mu_dtype``, the first moment ``exp_avg`` stored in ``mu_dtype``
    (fp32 by default) and the second ``exp_avg_sq`` in fp32:

      mu = (1 - b1) g + b1 mu_stored   (b1 mu_stored in mu_dtype, b1 rounded
                                        to it, as JAX's weak-typed scalar)
      nu = (1 - b2) g^2 + b2 nu
      p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with mu itself, not its stored rounding, in the update; then mu is
    stored. State keys as ``torch.optim.Adam``'s (``exp_avg``,
    ``exp_avg_sq``), so a checkpoint names them alike.

    ``step(lr, count, apply)`` reads everything that changes from step to
    step from tensors on the parameters' device: the learning rate, the
    count of updates applied before this one (t - 1) and the non-finite
    guard's verdict (None: always apply). So the same call runs eagerly and
    inside a CUDA graph, and nothing in it waits for the device.'''

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 mu_dtype=torch.float32):
        super().__init__(params, {'lr': lr, 'betas': betas, 'eps': eps,
                                  'weight_decay': weight_decay})
        self.mu_dtype = mu_dtype
        self._tables = {}

    def bias_corrections(self, group: dict, count: torch.Tensor) -> tuple:
        '''(1 - b1^t, 1 - b2^t) for t = count + 1, fp32 scalars on the
        count's device: rows of a table of 1 - b^t over t, made on the host
        once (``correction_table``) and indexed by the device count. A host
        t would be frozen into a CUDA graph, and a CPU scalar divisor would
        be applied on the card as its reciprocal.'''
        return tuple(self._correction(b, count) for b in group['betas'])

    def _correction(self, b: float, count: torch.Tensor) -> torch.Tensor:
        key = (b, count.device)
        if key not in self._tables:
            self._tables[key] = correction_table(b).to(count.device)
        table = self._tables[key]
        return table.index_select(0, count.clamp(
            max=table.numel() - 1).view(1)).view(())

    @torch.no_grad()
    def step(self, lr: torch.Tensor, count: torch.Tensor,
             apply: Optional[torch.Tensor] = None):
        for group in self.param_groups:
            b1, b2 = group['betas']
            wd, eps = group['weight_decay'], group['eps']
            b1_mu = torch.tensor(b1, dtype=self.mu_dtype).item()
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if 'exp_avg' not in state:
                    state['exp_avg'] = torch.zeros_like(
                        p, dtype=self.mu_dtype)
                    state['exp_avg_sq'] = torch.zeros_like(
                        p, dtype=torch.float32)
            mus = [self.state[p]['exp_avg'] for p in params]
            nus = [self.state[p]['exp_avg_sq'] for p in params]
            grads = [p.grad for p in params]
            if wd:
                grads = torch._foreach_add(grads,
                                           torch._foreach_mul(params, wd))
            mu = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu, torch._foreach_mul(mus, b1_mu))
            nu = torch._foreach_mul(nus, b2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            bc1, bc2 = self.bias_corrections(group, count)
            u = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(u, den)
            torch._foreach_mul_(u, -lr)
            if apply is None:
                torch._foreach_add_(params, u)
            else:
                torch._foreach_copy_(params, _gated(
                    apply, torch._foreach_add(params, u), params))
            torch._foreach_copy_(mus, _gated(apply, mu, mus))
            torch._foreach_copy_(nus, _gated(apply, nu, nus))


class OptaxSGD(torch.optim.Optimizer):
    '''SGD with L2 weight decay into the gradient and heavy-ball momentum
    (``optax.add_decayed_weights``, ``optax.trace``, then the scale by
    -lr): trace = g + momentum trace, from a zero trace, kept in the state
    as ``momentum_buffer`` (``torch.optim.SGD``'s key). ``step(lr, count,
    apply)`` as ``OptaxAdam``'s.'''

    def __init__(self, params, lr: float, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, {'lr': lr, 'momentum': momentum,
                                  'weight_decay': weight_decay})

    @torch.no_grad()
    def step(self, lr: torch.Tensor, count: torch.Tensor,
             apply: Optional[torch.Tensor] = None):
        for group in self.param_groups:
            momentum, wd = group['momentum'], group['weight_decay']
            params = [p for p in group['params'] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if wd:
                grads = torch._foreach_add(grads,
                                           torch._foreach_mul(params, wd))
            update = grads
            if momentum:
                for p in params:
                    if 'momentum_buffer' not in self.state[p]:
                        self.state[p]['momentum_buffer'] = torch.zeros_like(p)
                bufs = [self.state[p]['momentum_buffer'] for p in params]
                update = torch._foreach_mul(bufs, momentum)
                torch._foreach_add_(update, grads)
                torch._foreach_copy_(bufs, _gated(apply, update, bufs))
            step = torch._foreach_mul(update, -lr)
            if apply is None:
                torch._foreach_add_(params, step)
            else:
                torch._foreach_copy_(params, _gated(
                    apply, torch._foreach_add(params, step), params))


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
    every rank's.

    Everything a step changes lives on the parameters' device: the update
    count and the guard's counters are device tensors (``count``,
    ``notfinite``, ``total_notfinite`` and ``last_finite`` read them, a
    host sync each, and write them in place), the learning rate of each
    count is a row of a device table (``lr_table``: the base rate times the
    schedule, rounded to fp32, rewritten in place when the base rate
    changes), and the guard's verdict gates the update with
    ``torch.where``. So ``step()`` never waits for the device, and the same
    code runs eagerly and inside a CUDA graph (``train.graphs``), where the
    host values of an eager step would be frozen. Only ``calls`` is a host
    count.'''

    def __init__(self, params: list, cfg, total_steps: Optional[int] = None,
                 masked: bool = False):
        if not params:
            raise ValueError('no trainable parameters')
        self.params = params
        device = params[0].device
        self.grad_clip = getattr(cfg, 'grad_clip', None)
        self.skip_nonfinite = int(getattr(cfg, 'skip_nonfinite_grads', 0)
                                  or 0)
        self.schedule = schedule_multiplier(cfg, total_steps)
        self.layout = optax_layout(cfg, masked)
        self.calls = 0
        self.shards = None
        self._count = torch.zeros((), dtype=torch.int64, device=device)
        self._notfinite = torch.zeros((), dtype=torch.int64, device=device)
        self._total_notfinite = torch.zeros((), dtype=torch.int64,
                                            device=device)
        self._last_finite = torch.ones((), dtype=torch.bool, device=device)
        horizon = 0 if self.schedule is None else self.schedule.horizon
        self.lr_table = torch.zeros(horizon + 1, dtype=torch.float32,
                                    device=device)
        self.lr = float(cfg.lr)
        wd = getattr(cfg, 'weight_decay', 0.0) or 0.0
        if cfg.optimizer == 'adam':
            mu_dtype = getattr(cfg, 'optim_mu_dtype', 'float32') or 'float32'
            if mu_dtype not in ('float32', 'bfloat16'):
                raise ValueError(f'--optim_mu_dtype {mu_dtype!r}: float32 or '
                                 f'bfloat16')
            self.inner = OptaxAdam(
                params, lr=self.lr, betas=(getattr(cfg, 'beta1', 0.9),
                                           getattr(cfg, 'beta2', 0.999)),
                eps=getattr(cfg, 'eps', 1e-8), weight_decay=wd,
                mu_dtype=getattr(torch, mu_dtype))
        elif cfg.optimizer == 'sgd':
            self.inner = OptaxSGD(params, lr=self.lr,
                                  momentum=getattr(cfg, 'momentum', 0.0),
                                  weight_decay=wd)
        else:
            raise ValueError(cfg.optimizer)

    @property
    def lr(self) -> float:
        return self._lr

    @lr.setter
    def lr(self, value: float) -> None:
        self._lr = float(value)
        n = self.lr_table.numel()
        rates = [self._lr * (self.schedule(c) if self.schedule else 1.0)
                 for c in range(n)]
        with torch.no_grad():
            self.lr_table.copy_(torch.tensor(rates, dtype=torch.float32))

    def _scalar(name, kind):
        def get(self):
            return kind(getattr(self, name))

        def put(self, value):
            with torch.no_grad():
                getattr(self, name).fill_(value)
        return property(get, put)

    count = _scalar('_count', int)
    notfinite = _scalar('_notfinite', int)
    total_notfinite = _scalar('_total_notfinite', int)
    last_finite = _scalar('_last_finite', bool)
    del _scalar

    def device_state(self) -> list:
        '''The device tensors a step reads and writes in place besides the
        parameters and the moments: the counters and the rate table.'''
        return [self._count, self._notfinite, self._total_notfinite,
                self._last_finite, self.lr_table]

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
        apply = None
        if self.skip_nonfinite:
            amax = torch.stack(torch._foreach_norm(grads, math.inf))
            finite = torch.isfinite(amax).all()
            if self.shards is not None:      # one verdict for every rank
                finite = torch.tensor(
                    not self.shards.dp.any(not bool(finite)),
                    device=finite.device)
            self._notfinite.copy_(torch.where(finite, 0,
                                              self._notfinite + 1))
            self._total_notfinite.add_((~finite).to(torch.int64))
            self._last_finite.copy_(finite)
            # optax.apply_if_finite: past the limit the update passes
            apply = finite | (self._notfinite > self.skip_nonfinite)
        if self.grad_clip is not None:
            factor = torch.where(norm < self.grad_clip, 1.0,
                                 self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        # an index tensor of one element: a 0-d one would be read on the host
        lr = self.lr_table.index_select(0, self._count.clamp(
            max=self.lr_table.numel() - 1).view(1)).view(())
        for group in self.inner.param_groups:
            group['lr'] = lr
        self.inner.step(lr, self._count, apply)
        self._count.add_(1 if apply is None else apply.to(torch.int64))
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
