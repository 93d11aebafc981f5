'''Training and validation steps of the captioners and the proposal
generators, bi-modal and uni-modal (counterpart of ``make_cap_train_step``,
``make_cap_val_step``, ``make_prop_train_step`` and
``make_prop_inference_step`` in ``bmt_tpu.train.steps``). The model picks
the forward: both captioners take the same arguments, and a uni-modal
proposal generator's loss terms are filed under its modality's side.

The JAX steps are pure (state, batch) -> (state, metrics) functions; here
the step updates the ``TrainState``'s model, optimizer and counters in place
and returns the same state, with metrics as device scalars (nothing in a
step waits for the device unless ``--skip_nonfinite_grads`` is on).

Mixed precision as in the JAX package's ``cast_tree``: the model's
parameters stay fp32 masters; with a ``compute_dtype`` below fp32 the
forward runs on ``.to(compute_dtype)`` copies (``torch.func.functional_call``),
so the gradients land on the fp32 masters as fp32 values.

Dropout draws from the state's own ``torch.Generator``, reseeded from
(seed, step) at every step: the counterpart of
``fold_in(state.rng, state.step)``. A step's masks depend only on
(seed, step), not on what ran before in the process.

Not ported: ``make_multistep`` (a TPU dispatch workaround) and the
proposal steps' ``seq_mesh`` (sequence parallelism waits for the
parallelism slice).
'''
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from bmt_tpu_torch.models.proposal import make_targets_dense
from bmt_tpu_torch.ops.layers import dropout_generator
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.train.losses import label_smoothing_kl_logits
from bmt_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    '''The model (fp32 masters), its optimizer, the step count, the dropout
    seed, and the EMA of the parameters ({name: tensor}) when EMA is on.'''
    model: nn.Module
    optimizer: Optimizer
    seed: int = 0
    step: int = 0
    ema: Optional[dict] = None
    generator: Optional[torch.Generator] = None


def init_train_state(model: nn.Module, optimizer: Optimizer, seed: int = 0,
                     ema: bool = False) -> TrainState:
    '''ema=True seeds the EMA with a copy of the parameters.'''
    device = next(model.parameters()).device
    return TrainState(
        model=model, optimizer=optimizer, seed=seed, step=0,
        ema=({n: p.detach().clone() for n, p in model.named_parameters()}
             if ema else None),
        generator=torch.Generator(device=device))


def step_seed(seed: int, step: int) -> int:
    '''The dropout generator's seed at (seed, step): a splitmix64 mix of
    the pair, so the low 32 bits (all that the CPU generator keeps) differ
    too.'''
    mask = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + step + 0x632BE59BD9B4E019) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return (x ^ (x >> 31)) >> 1            # torch takes seeds < 2**63


def cast_params(model: nn.Module, dtype) -> dict:
    '''{name: fp32 parameter cast to ``dtype``}; autograd carries the
    gradient of each copy back to its fp32 parameter.'''
    return {name: p.to(dtype) if p.dtype == torch.float32 else p
            for name, p in model.named_parameters()}


def _forward_logits(model, src, cap_x, masks, attention_impl,
                    compute_dtype, aux_out=None):
    '''Teacher-forced logits in ``compute_dtype`` from the fp32 masters;
    ``aux_out`` gains the MoE load-balance losses.'''
    src = {k: x.to(compute_dtype) for k, x in src.items()}
    args = (src, cap_x, masks, attention_impl)
    kwargs = {'return_logits': True, 'aux_out': aux_out}
    if compute_dtype == torch.float32:
        return model(*args, **kwargs)
    return torch.func.functional_call(model, cast_params(model, compute_dtype),
                                      args, kwargs)


def _device_batch(batch: dict, device):
    '''(src, caption, row_valid) as tensors on ``device``; numpy or torch
    in.'''
    src = {k: torch.as_tensor(x, device=device)
           for k, x in batch['src'].items()}
    caption = torch.as_tensor(batch['caption'], device=device).long()
    row_valid = batch.get('row_valid')
    if row_valid is not None:
        row_valid = torch.as_tensor(row_valid, device=device).bool()
    return src, caption, row_valid


def _masked_targets(caption, row_valid, pad_idx):
    '''(decoder input, targets); the targets of repeat-padded tail rows
    (row_valid False) become pad_idx, which zeroes their loss rows and drops
    them from the token count.'''
    cap_x, cap_y = caption[:, :-1], caption[:, 1:]
    if row_valid is not None:
        cap_y = torch.where(row_valid[:, None], cap_y, pad_idx)
    return cap_x, cap_y


def _ema_update(ema, model, decay: float):
    '''e <- decay e + (1 - decay) p over every parameter.'''
    if not decay or ema is None:
        return
    names, params = zip(*model.named_parameters())
    tensors = [ema[n] for n in names]
    torch._foreach_mul_(tensors, decay)
    torch._foreach_add_(tensors, [p.detach() for p in params],
                        alpha=1.0 - decay)


def make_cap_train_step(dims, smoothing: float, pad_idx: int,
                        attention_impl: str = 'torch',
                        compute_dtype=torch.float32, accum_steps: int = 1,
                        ema_decay: float = 0.0, moe_aux_coeff: float = 0.01):
    '''Teacher-forced captioning train step
    (reference: captioning_epoch_loops.py:122-149).

    accum_steps > 1 splits the batch into that many microbatches and sums
    their gradients of KL / N, N the whole batch's token count: the
    full-batch gradient at 1/accum_steps of the activation memory (the
    JAX step sums raw KL gradients and divides by N once).

    With MoE FFNs (dims.moe_experts > 1) and ``moe_aux_coeff`` > 0 each
    microbatch's objective is KL + coeff mean(aux) n, aux its MoE
    load-balance losses and n its token count, token-weighted as in the JAX
    step, so accumulated microbatches still give the full-batch gradient
    (routing and capacity are per row). The reported loss carries the aux
    term too, as JAX's does.'''
    collect_aux = dims.moe_experts > 1 and moe_aux_coeff > 0.0

    def step(state: TrainState, batch: dict):
        model = state.model
        device = next(model.parameters()).device
        src, caption, row_valid = _device_batch(batch, device)
        cap_x, cap_y = _masked_targets(caption, row_valid, pad_idx)
        B = caption.shape[0]
        if B % accum_steps:
            raise ValueError(f'batch size {B} not divisible by '
                             f'grad_accum_steps={accum_steps}')
        n_tokens = (cap_y != pad_idx).sum().clamp(min=1)
        mb = B // accum_steps

        model.train()
        state.optimizer.zero_grad()
        state.generator.manual_seed(step_seed(state.seed, state.step))
        kl_sum = torch.zeros((), device=device)
        with dropout_generator(state.generator):
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                src_mb = {k: x[rows] for k, x in src.items()}
                masks = make_masks(src_mb, cap_x[rows], dims.modality,
                                   pad_idx)
                aux = [] if collect_aux else None
                logits = _forward_logits(model, src_mb, cap_x[rows], masks,
                                         attention_impl, compute_dtype, aux)
                kl = label_smoothing_kl_logits(logits, cap_y[rows],
                                               smoothing, pad_idx)
                if aux:
                    n = (cap_y[rows] != pad_idx).sum()
                    kl = kl + moe_aux_coeff * (sum(aux) / len(aux)) * n
                (kl / n_tokens).backward()
                kl_sum = kl_sum + kl.detach()

        grad_norm = state.optimizer.step()
        with torch.no_grad():
            _ema_update(state.ema, model, ema_decay)
        state.step += 1
        return state, {'loss': kl_sum / n_tokens, 'grad_norm': grad_norm}
    return step


def make_cap_val_step(dims, smoothing: float, pad_idx: int,
                      attention_impl: str = 'torch',
                      compute_dtype=torch.float32):
    '''Next-word validation loss (reference:
    captioning_epoch_loops.py:152-172): step(model, batch) -> device
    scalar.'''

    @torch.no_grad()
    def step(model: nn.Module, batch: dict) -> torch.Tensor:
        device = next(model.parameters()).device
        src, caption, row_valid = _device_batch(batch, device)
        cap_x, cap_y = _masked_targets(caption, row_valid, pad_idx)
        masks = make_masks(src, cap_x, dims.modality, pad_idx)
        n_tokens = (cap_y != pad_idx).sum().clamp(min=1)
        model.eval()
        logits = _forward_logits(model, src, cap_x, masks, attention_impl,
                                 compute_dtype)
        return label_smoothing_kl_logits(logits, cap_y, smoothing,
                                         pad_idx) / n_tokens
    return step


# ---------------------------------------------------------------------------
# proposal generator
# ---------------------------------------------------------------------------

def prop_frozen(freeze_encoder: bool = False):
    '''The ``frozen(path)`` predicate of the proposal trainer
    (``prop_trainer.py``'s ``is_frozen``) for ``build_optimizer``: the
    anchors always, and the encoder when it comes from a pretrained
    captioner and is not fine-tuned.'''
    def frozen(path: tuple) -> bool:
        return (path[0] in ('anchors_A', 'anchors_V', 'anchors')
                or (freeze_encoder and path[0] == 'encoder'))
    return frozen


def _prop_batch(batch: dict, device):
    '''(src, (centers, lengths, valid)) as tensors on ``device``.'''
    src = {k: torch.as_tensor(x, device=device)
           for k, x in batch['src'].items()}
    targets = (torch.as_tensor(batch['centers'], device=device).float(),
               torch.as_tensor(batch['lengths'], device=device).float(),
               torch.as_tensor(batch['valid'], device=device).bool())
    return src, targets


def _prop_forward(model, src, targets, pad_idx, attention_impl,
                  compute_dtype, loss_denoms=None):
    '''The generator's forward in ``compute_dtype`` from the fp32 masters;
    the masks come from the uncast features (channel 0 against pad_idx).
    Returns (predictions, loss, losses_A, losses_V); a uni-modal
    generator's terms are losses_V for video, losses_A for audio, the
    other side empty (``steps.py:375-389``).'''
    modality = model.dims.modality
    masks = make_masks(src, None, modality, pad_idx)
    args = ({k: x.to(compute_dtype) for k, x in src.items()}, targets, masks,
            attention_impl, loss_denoms)
    if compute_dtype == torch.float32:
        out = model(*args)
    else:
        out = torch.func.functional_call(
            model, cast_params(model, compute_dtype), args)
    if modality == 'audio_video':
        return out
    preds, loss, losses = out
    return ((preds, loss, {}, losses) if modality == 'video'
            else (preds, loss, losses, {}))


def _cell_counts(targets, anchors, stride: float, S: int):
    '''(obj, noobj) cell counts of the whole batch: target math alone (the
    anchors are the only parameter it reads, and they are frozen).'''
    obj, noobj, _, _ = make_targets_dense(*targets, anchors, stride, S)
    return obj.sum().float(), noobj.sum().float()


def make_prop_train_step(dims, pad_idx: int, attention_impl: str = 'torch',
                         compute_dtype=torch.float32, accum_steps: int = 1,
                         ema_decay: float = 0.0):
    '''Proposal-generator train step (reference:
    proposal_epoch_loops.py:27-63); the batch holds 'src' and the padded
    events 'centers', 'lengths' (seconds) and 'valid', each (B, E).

    Metrics: 'loss', 'grad_norm' and each loss term of each modality
    ('loss_x_A', ..., 'loss_conf_noobj_V'), device scalars.

    accum_steps > 1 splits the batch into microbatches and is exact: the YOLO
    losses are masked means over obj/noobj cells, and the cell counts depend
    only on the targets, so a target-only pre-pass counts them over the
    whole batch per modality, each microbatch divides its sums by those
    counts, and the summed gradients are the full batch's.'''

    def step(state: TrainState, batch: dict):
        model = state.model
        device = next(model.parameters()).device
        src, targets = _prop_batch(batch, device)
        B = targets[0].shape[0]
        if B % accum_steps:
            raise ValueError(f'batch size {B} not divisible by '
                             f'grad_accum_steps={accum_steps}')
        denoms = None
        if accum_steps > 1 and dims.modality == 'audio_video':
            denoms = (_cell_counts(targets, model.anchors_A, dims.stride_A,
                                   src['audio'].shape[1]),
                      _cell_counts(targets, model.anchors_V, dims.stride_V,
                                   src['rgb'].shape[1]))
        elif accum_steps > 1:
            grid = src['rgb' if dims.modality == 'video' else 'audio']
            denoms = _cell_counts(targets, model.anchors, model.stride,
                                  grid.shape[1])
        mb = B // accum_steps

        model.train()
        state.optimizer.zero_grad()
        state.generator.manual_seed(step_seed(state.seed, state.step))
        loss_sum, terms = torch.zeros((), device=device), {}
        with dropout_generator(state.generator):
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                _, loss, losses_A, losses_V = _prop_forward(
                    model, {k: x[rows] for k, x in src.items()},
                    tuple(t[rows] for t in targets), pad_idx, attention_impl,
                    compute_dtype, denoms)
                loss.backward()
                loss_sum = loss_sum + loss.detach()
                for suffix, losses in (('_A', losses_A), ('_V', losses_V)):
                    for k, v in losses.items():
                        terms[k + suffix] = (terms.get(k + suffix, 0.0)
                                             + v.detach())

        grad_norm = state.optimizer.step()
        with torch.no_grad():
            _ema_update(state.ema, model, ema_decay)
        state.step += 1
        return state, {'loss': loss_sum, 'grad_norm': grad_norm, **terms}
    return step


def make_prop_inference_step(dims, pad_idx: int,
                             attention_impl: str = 'torch',
                             compute_dtype=torch.float32):
    '''Forward-only proposal predictions (reference:
    proposal_epoch_loops.py:99-110): step(model, batch) -> (B, N, 3) fp32
    [center, length, conf] in seconds.'''

    @torch.no_grad()
    def step(model: nn.Module, batch: dict) -> torch.Tensor:
        device = next(model.parameters()).device
        src = {k: torch.as_tensor(x, device=device)
               for k, x in batch['src'].items()}
        model.eval()
        return _prop_forward(model, src, None, pad_idx, attention_impl,
                             compute_dtype)[0].float()
    return step
