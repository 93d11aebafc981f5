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

Dropout draws as the state's ``prng_impl`` says (``init_train_state``;
JAX's ``--prng_impl``). Under ``threefry2x32``, the step API's default as
in JAX, the step's key is ``fold_in(key(seed), step)``, computed on the
host from its step count (no device read) and handed to the body as its
``'rng'`` input, and each microbatch of an accumulated step draws from
``fold_in(step key, i)``: the masks are JAX's bit for bit
(``ops.layers.key_stream``). Under ``rbg`` and ``unsafe_rbg`` (the
trainers' default) they come from the state's own ``torch.Generator``,
reseeded from (seed, step) at every step. Either way a step's masks depend
only on (seed, step), not on what ran before in the process.

Data parallelism (``dp``, a ``parallel.DataParallel``): each rank runs its
rows of the global batch and the step keeps the global batch's semantics.
The caption loss is the global KL sum over the global non-pad token count
(the count all-reduced before the backward), the proposal losses divide by
the global obj/noobj cell counts (all-reduced ``denoms``), the ranks'
gradients are summed (not averaged) before the clip and the update, and the
MoE load-balance term keeps the global batch's weight. The sums run over
``dp``'s data group: the dp ranks, and the sp ranks of the proposal step,
which hold the same rows' sequence blocks; the ep ranks of one row block
compute the same loss and need no sum. Under threefry a rank draws its
block of the one global mask, as JAX does: its rows'
(``ops.layers.row_block``; a rank's microbatch i is the (rank accum + i)-th
block of the global batch, inside global microbatch (rank accum + i) //
n_dp, whose key it folds in), its sequence block's and its mp and ep
slices'. Under rbg it draws from a generator seeded by (seed, step,
``dp.seed_rank``): the ep ranks of a row block draw the same masks, the
other ranks their own.

``--fsdp`` (``dp.shards``): a step gathers the whole large parameters
before its forward (``dp.gather_params``) and keeps its shards of their
summed gradients (``dp.all_reduce_grads``), so the optimizer and the EMA
run on shards. Sequence parallelism (the proposal steps): the batch's
features are this rank's sequence blocks (``'seq_split'``), the key
padding masks are gathered whole, the model runs inside
``parallel.seq.sequence_parallel``, and the cell counts are the blocks'
summed over the data group.

Each train step is a ``TrainStep``: its batch (and the step key) to
device tensors, the rbg generator's reseed, a body that only enqueues
device work, then the host's step count.
``make_multistep`` bundles K steps into one call, as JAX's does with
``lax.scan``: on the card a CUDA graph of the body for each batch geometry
(``train.graphs``) is replayed once a step, in place of the step's ~2000
kernel launches; on the CPU, and under a process group, the K steps run in
order.
'''
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Optional

import numpy as np
import torch
from torch import nn

from bmt_tpu_torch.models.proposal import make_targets_dense
from bmt_tpu_torch.ops import prng
from bmt_tpu_torch.ops.layers import dropout_generator, key_stream, row_block
from bmt_tpu_torch.ops.masks import make_masks
from bmt_tpu_torch.parallel import seq
from bmt_tpu_torch.train.losses import label_smoothing_kl_logits
from bmt_tpu_torch.train.optim import Optimizer


PRNG_IMPLS = ('threefry2x32', 'rbg', 'unsafe_rbg')


@dataclasses.dataclass
class TrainState:
    '''The model (fp32 masters), its optimizer, the step count, the dropout
    seed, the EMA of the parameters ({name: tensor}) when EMA is on, and
    the CUDA graphs of its steps once ``make_multistep`` has made some.
    Under threefry2x32 ``key`` is ``jax.random.key(seed)``, a (2,) uint32
    CPU tensor (read with no device sync); under rbg ``generator`` is the
    dropout generator on the model's device.'''
    model: nn.Module
    optimizer: Optimizer
    seed: int = 0
    step: int = 0
    ema: Optional[dict] = None
    generator: Optional[torch.Generator] = None
    graphs: Optional[object] = None     # train.graphs.StepGraphs
    prng_impl: str = 'threefry2x32'
    key: Optional[torch.Tensor] = None


def init_train_state(model: nn.Module, optimizer: Optimizer, seed: int = 0,
                     ema: bool = False, prng_impl: str = 'threefry2x32'
                     ) -> TrainState:
    '''ema=True seeds the EMA with a copy of the parameters. ``prng_impl``:
    'threefry2x32' (the default, as JAX's: masks bit-equal to JAX's and the
    same under every sharding) or 'rbg'/'unsafe_rbg' (the port's Philox
    generator; JAX leaves these bits to the backend).'''
    if prng_impl not in PRNG_IMPLS:
        raise ValueError(f'prng_impl {prng_impl!r} is not one of '
                         f'{PRNG_IMPLS}')
    device = next(model.parameters()).device
    threefry = prng_impl == 'threefry2x32'
    return TrainState(
        model=model, optimizer=optimizer, seed=seed, step=0,
        ema=({n: p.detach().clone() for n, p in model.named_parameters()}
             if ema else None),
        generator=None if threefry else torch.Generator(device=device),
        prng_impl=prng_impl,
        key=prng.key(seed, 'cpu') if threefry else None)


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    '''The dropout generator's seed at (seed, step) on data-parallel rank
    ``rank``: a splitmix64 mix, so the low 32 bits (all that the CPU
    generator keeps) differ too; rank 0 has the single process's seed.'''
    mask = (1 << 64) - 1
    x = (seed * 0x9E3779B97F4A7C15 + step + 0x632BE59BD9B4E019
         + rank * 0xD1B54A32D192ED03) & mask
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


def _seed_rank(dp) -> int:
    return 0 if dp is None else dp.seed_rank


def step_key(state: TrainState) -> np.ndarray:
    '''fold_in(state.key, state.step) as a (2,) uint32 array: the threefry
    key of the state's next step.'''
    words = prng.fold_in_words(tuple(state.key.tolist()), state.step)
    return np.array(words, dtype=np.uint32)


@contextlib.contextmanager
def _microbatch_keys(inputs: dict, i: int, accum_steps: int, dp):
    '''Under threefry (an ``'rng'`` input), microbatch i of this rank draws
    from a stream of the step key (JAX :207), folded with its global
    microbatch's index when the step accumulates (JAX :236), and for its
    block of that microbatch's rows. Under rbg, nothing.'''
    key = inputs.get('rng')
    if key is None:
        yield
        return
    n_dp = 1 if dp is None else dp.n_dp
    block = (0 if dp is None else dp.dp_rank) * accum_steps + i
    k = prng.Key(key)
    if accum_steps > 1:
        k = k.fold_in(block // n_dp)
    with key_stream(k), (row_block(block % n_dp, n_dp) if n_dp > 1
                         else contextlib.nullcontext()):
        yield


class TrainStep:
    '''A train step, ``step(state, batch) -> (state, metrics)``, in the
    parts that ``make_multistep``'s CUDA graphs take apart:

    - ``host_inputs(batch, state)``: the batch as a flat {name: array} of
      numpy arrays in the dtypes the body reads (``'src/<stack>'``, then
      the step's own ``casts``), and under threefry the state's next step
      key (``'rng'``);
    - ``seed(state)``: under rbg, the dropout seed of the state's next
      step, (seed, step, rank) mixed by ``step_seed``;
    - ``body(state, inputs) -> metrics``: the step on device tensors. It
      only enqueues device work (no host read, no host-to-device copy), so
      a graph can capture it; the optimizer's counters and the EMA are
      updated in place on the device;
    - the host's step count, ``state.step``, advanced after the body.

    ``key`` holds what else picks the body's work (the accumulation steps
    and the EMA decay): a graph is kept for each key and batch geometry.'''

    def __init__(self, body, casts: dict, dp=None, key=()):
        self.body, self.casts, self.dp, self.key = body, casts, dp, key

    def host_inputs(self, batch: dict, state: TrainState = None) -> dict:
        out = {f'src/{k}': np.asarray(x) for k, x in batch['src'].items()}
        for name, dtype in self.casts.items():
            if batch.get(name) is not None:
                out[name] = np.asarray(batch[name]).astype(
                    _NUMPY[dtype], copy=False)
        if state is not None and state.key is not None:
            out['rng'] = step_key(state)
        return out

    def device_inputs(self, batch: dict, device) -> dict:
        '''``host_inputs`` as tensors on ``device``, and a
        sequence-parallel batch's ``'seq_split'``.'''
        out = {f'src/{k}': torch.as_tensor(x, device=device)
               for k, x in batch['src'].items()}
        for name, dtype in self.casts.items():
            if batch.get(name) is not None:
                out[name] = torch.as_tensor(batch[name],
                                            device=device).to(dtype)
        if 'seq_split' in batch:
            out['seq_split'] = tuple(batch['seq_split'])
        return out

    def seed(self, state: TrainState) -> int:
        return step_seed(state.seed, state.step, _seed_rank(self.dp))

    def __call__(self, state: TrainState, batch: dict):
        device = next(state.model.parameters()).device
        inputs = self.device_inputs(batch, device)
        if state.key is not None:
            inputs['rng'] = torch.from_numpy(step_key(state)).to(device)
        else:
            state.generator.manual_seed(self.seed(state))
        metrics = self.body(state, inputs)
        state.step += 1
        return state, metrics


_NUMPY = {torch.int64: np.int64, torch.bool: np.bool_,
          torch.float32: np.float32}


def _src(inputs: dict) -> dict:
    return {k[4:]: x for k, x in inputs.items() if k.startswith('src/')}


def make_cap_train_step(dims, smoothing: float, pad_idx: int,
                        attention_impl: str = 'torch',
                        compute_dtype=torch.float32, accum_steps: int = 1,
                        ema_decay: float = 0.0, moe_aux_coeff: float = 0.01,
                        dp=None):
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
    term too, as JAX's does.

    ``dp``: the batch is this rank's rows, a contiguous block of the global
    batch (by its dp coordinate); the token counts (the global batch's and
    each global microbatch's, the contiguous slices JAX accumulates over)
    are summed over the ranks, and the gradients are summed over the ranks before the
    update. A rank's microbatch lies inside one global microbatch, which
    n_dp such blocks of equal rows make up, so the global microbatch's
    Switch loss (a per-row mean) is the mean of their means: each block's
    MoE term is weighted by 1 / n_dp of its global microbatch's tokens.'''
    collect_aux = dims.moe_experts > 1 and moe_aux_coeff > 0.0
    # the batch's token count, then each global microbatch's (for MoE):
    # this rank's microbatch i is the (rank * accum + i)-th block of mb rows
    # of the global batch, inside global microbatch block // n_dp
    n_dp = 1 if dp is None else dp.n_dp
    in_mb = [((0 if dp is None else dp.dp_rank) * accum_steps + i) // n_dp
             for i in range(accum_steps)]
    in_mb_on = {}         # {device: in_mb}, copied to the device once

    def body(state: TrainState, inputs: dict):
        model = state.model
        device = next(model.parameters()).device
        src, caption = _src(inputs), inputs['caption']
        cap_x, cap_y = _masked_targets(caption, inputs.get('row_valid'),
                                       pad_idx)
        B = caption.shape[0]
        if B % accum_steps:
            raise ValueError(f'batch size {B} not divisible by '
                             f'grad_accum_steps={accum_steps}')
        mb = B // accum_steps
        tokens = (cap_y != pad_idx)
        counts = tokens.sum()[None]
        if collect_aux:
            if device not in in_mb_on:
                in_mb_on[device] = torch.tensor(in_mb, device=device)
            per_mb = tokens.view(accum_steps, -1).sum(1)
            counts = torch.cat([counts, torch.zeros_like(per_mb).index_add_(
                0, in_mb_on[device], per_mb)])
        if dp is not None:
            counts = dp.all_reduce_sum(counts)
        n_tokens = counts[0].clamp(min=1)

        model.train()
        state.optimizer.zero_grad()
        if dp is not None:
            dp.gather_params()
        kl_sum = torch.zeros((), device=device)
        with dropout_generator(state.generator):
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                src_mb = {k: x[rows] for k, x in src.items()}
                masks = make_masks(src_mb, cap_x[rows], dims.modality,
                                   pad_idx)
                aux = [] if collect_aux else None
                with _microbatch_keys(inputs, i, accum_steps, dp):
                    logits = _forward_logits(model, src_mb, cap_x[rows],
                                             masks, attention_impl,
                                             compute_dtype, aux)
                    kl = label_smoothing_kl_logits(logits, cap_y[rows],
                                                   smoothing, pad_idx)
                    if aux:
                        n = counts[1 + in_mb[i]] / n_dp
                        kl = kl + moe_aux_coeff * (sum(aux) / len(aux)) * n
                    (kl / n_tokens).backward()
                kl_sum = kl_sum + kl.detach()

        if dp is not None:
            dp.all_reduce_grads(state.optimizer.params)
            kl_sum = dp.all_reduce_sum(kl_sum)
        grad_norm = state.optimizer.step()
        with torch.no_grad():
            _ema_update(state.ema, model, ema_decay)
        return {'loss': kl_sum / n_tokens, 'grad_norm': grad_norm}
    return TrainStep(body, {'caption': torch.int64, 'row_valid': torch.bool},
                     dp, key=(accum_steps, ema_decay))


def make_cap_val_step(dims, smoothing: float, pad_idx: int,
                      attention_impl: str = 'torch',
                      compute_dtype=torch.float32, dp=None):
    '''Next-word validation loss (reference:
    captioning_epoch_loops.py:152-172): step(model, batch) -> device
    scalar. ``dp``: the batch is this rank's rows, and the KL sum and the
    token count are summed over the ranks first.'''

    @torch.no_grad()
    def step(model: nn.Module, batch: dict) -> torch.Tensor:
        device = next(model.parameters()).device
        src, caption, row_valid = _device_batch(batch, device)
        cap_x, cap_y = _masked_targets(caption, row_valid, pad_idx)
        masks = make_masks(src, cap_x, dims.modality, pad_idx)
        n_tokens = (cap_y != pad_idx).sum()
        model.eval()
        logits = _forward_logits(model, src, cap_x, masks, attention_impl,
                                 compute_dtype)
        kl = label_smoothing_kl_logits(logits, cap_y, smoothing, pad_idx)
        if dp is not None:
            kl, n_tokens = dp.all_reduce_sum(torch.stack([
                kl.float(), n_tokens.float()]))
        return kl / n_tokens.clamp(min=1)
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


def _prop_forward(model, src, targets, pad_idx, attention_impl,
                  compute_dtype, loss_denoms=None, split=()):
    '''The generator's forward in ``compute_dtype`` from the fp32 masters;
    the masks come from the uncast features (channel 0 against pad_idx),
    gathered whole for the features in ``split`` (this rank's sequence
    blocks, under an active ``seq.sequence_parallel``). Returns
    (predictions, loss, losses_A, losses_V); a uni-modal generator's
    terms are losses_V for video, losses_A for audio, the other side empty
    (``steps.py:375-389``).'''
    modality = model.dims.modality
    masks = make_masks(src, None, modality, pad_idx)
    for key, source in (('A_mask', 'audio'), ('V_mask', 'rgb')):
        if key in masks and source in split:
            masks[key] = seq.gather_mask(masks[key])
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


def _cell_counts(targets, anchors, stride: float, S: int, split=False):
    '''(obj, noobj) cell counts of the batch: target math alone (the
    anchors are the only parameter it reads, and they are frozen). ``S``:
    the grid's rows here; with ``split`` a block of the active sp group's
    sequence, whose cells alone are counted.'''
    whole = S * (seq.active().size if split else 1)
    obj, noobj, _, _ = make_targets_dense(*targets, anchors, stride, whole)
    if split:
        first = seq.offset(S, whole)
        obj, noobj = obj[..., first:first + S], noobj[..., first:first + S]
    return obj.sum().float(), noobj.sum().float()


def make_prop_train_step(dims, pad_idx: int, attention_impl: str = 'torch',
                         compute_dtype=torch.float32, accum_steps: int = 1,
                         ema_decay: float = 0.0, dp=None):
    '''Proposal-generator train step (reference:
    proposal_epoch_loops.py:27-63); the batch holds 'src' and the padded
    events 'centers', 'lengths' (seconds) and 'valid', each (B, E).

    Metrics: 'loss', 'grad_norm' and each loss term of each modality
    ('loss_x_A', ..., 'loss_conf_noobj_V'), device scalars.

    accum_steps > 1 splits the batch into microbatches and is exact: the YOLO
    losses are masked means over obj/noobj cells, and the cell counts depend
    only on the targets, so a target-only pre-pass counts them over the
    whole batch per modality, each microbatch divides its sums by those
    counts, and the summed gradients are the full batch's. ``dp`` takes the
    same route: the batch is this rank's rows, the counts are summed over
    the ranks, and so are the gradients and the reported losses.'''

    def body(state: TrainState, inputs: dict):
        with seq.sequence_parallel(None if dp is None else dp.sp_group):
            return _body(state, inputs)

    def _body(state: TrainState, inputs: dict):
        model = state.model
        device = next(model.parameters()).device
        src = _src(inputs)
        targets = (inputs['centers'], inputs['lengths'], inputs['valid'])
        split = inputs.get('seq_split', ())
        if dp is not None:
            dp.gather_params()      # the anchors too, read by the counts
        B = targets[0].shape[0]
        if B % accum_steps:
            raise ValueError(f'batch size {B} not divisible by '
                             f'grad_accum_steps={accum_steps}')
        denoms = None
        if (accum_steps > 1 or dp is not None) \
                and dims.modality == 'audio_video':
            denoms = (_cell_counts(targets, model.anchors_A, dims.stride_A,
                                   src['audio'].shape[1], 'audio' in split),
                      _cell_counts(targets, model.anchors_V, dims.stride_V,
                                   src['rgb'].shape[1], 'rgb' in split))
        elif accum_steps > 1 or dp is not None:
            key = 'rgb' if dims.modality == 'video' else 'audio'
            denoms = _cell_counts(targets, model.anchors, model.stride,
                                  src[key].shape[1], key in split)
        if dp is not None:
            nested = isinstance(denoms[0], tuple)
            flat = dp.all_reduce_sum(torch.stack(
                [c for pair in (denoms if nested else (denoms,))
                 for c in pair]))
            denoms = (((flat[0], flat[1]), (flat[2], flat[3])) if nested
                      else (flat[0], flat[1]))
        mb = B // accum_steps

        model.train()
        state.optimizer.zero_grad()
        loss_sum, terms = torch.zeros((), device=device), {}
        with dropout_generator(state.generator):
            for i in range(accum_steps):
                rows = slice(i * mb, (i + 1) * mb)
                with _microbatch_keys(inputs, i, accum_steps, dp):
                    _, loss, losses_A, losses_V = _prop_forward(
                        model, {k: x[rows] for k, x in src.items()},
                        tuple(t[rows] for t in targets), pad_idx,
                        attention_impl, compute_dtype, denoms, split)
                    loss.backward()
                loss_sum = loss_sum + loss.detach()
                for suffix, losses in (('_A', losses_A), ('_V', losses_V)):
                    for k, v in losses.items():
                        terms[k + suffix] = (terms.get(k + suffix, 0.0)
                                             + v.detach())

        if dp is not None:
            dp.all_reduce_grads(state.optimizer.params)
            names = sorted(terms)
            flat = dp.all_reduce_sum(torch.stack(
                [loss_sum] + [torch.as_tensor(terms[k], device=device)
                              for k in names]))
            loss_sum, terms = flat[0], dict(zip(names, flat[1:]))
        grad_norm = state.optimizer.step()
        with torch.no_grad():
            _ema_update(state.ema, model, ema_decay)
        return {'loss': loss_sum, 'grad_norm': grad_norm, **terms}
    return TrainStep(body, {'centers': torch.float32,
                            'lengths': torch.float32, 'valid': torch.bool},
                     dp, key=(accum_steps, ema_decay))


def make_prop_inference_step(dims, pad_idx: int,
                             attention_impl: str = 'torch',
                             compute_dtype=torch.float32, dp=None):
    '''Forward-only proposal predictions (reference:
    proposal_epoch_loops.py:99-110): step(model, batch) -> (B, N, 3) fp32
    [center, length, conf] in seconds. ``dp``: a batch of this rank's
    sequence blocks (``'seq_split'``) predicts over its sp group, and every
    sp rank returns its rows' whole predictions.'''

    @torch.no_grad()
    def step(model: nn.Module, batch: dict) -> torch.Tensor:
        device = next(model.parameters()).device
        src = {k: torch.as_tensor(x, device=device)
               for k, x in batch['src'].items()}
        model.eval()
        with seq.sequence_parallel(None if dp is None else dp.sp_group):
            return _prop_forward(model, src, None, pad_idx, attention_impl,
                                 compute_dtype,
                                 split=batch.get('seq_split', ()))[0].float()
    return step


# ---------------------------------------------------------------------------
# multi-step dispatch
# ---------------------------------------------------------------------------

def _unstack(batches) -> list:
    '''K host batches from a list, or from one batch whose array leaves
    carry a leading K (JAX's stacked layout).'''
    if isinstance(batches, (list, tuple)):
        return list(batches)

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            yield x

    k = next(leaves(batches)).shape[0]

    def pick(x, i):
        if isinstance(x, dict):
            return {key: pick(v, i) for key, v in x.items()}
        return x[i] if isinstance(x, (np.ndarray, torch.Tensor)) else x
    return [pick(batches, i) for i in range(k)]


def make_multistep(step: TrainStep):
    '''K train steps in one call (counterpart of
    ``bmt_tpu.train.steps.make_multistep``): ``multistep(state, batches) ->
    (state, metrics)``, ``batches`` K host batches (a list, or one batch
    whose array leaves carry a leading K), each metric stacked to (K,).

    On a CUDA model the state keeps one CUDA graph of ``step``'s body for
    each batch geometry (every input's shape and dtype, and ``step.key``),
    as ``jit`` keeps one executable a shape (``train.graphs.StepGraphs``):
    the first batch of a geometry runs eagerly on the graphs' side stream
    (the warm-up, a real step), the second captures the graph, and from
    then on each batch is copied into the graph's inputs and the graph is
    replayed, one launch for the step's ~2000 kernels. The steps are those
    of ``step`` bit for bit: the same body on the same inputs, the step key
    among them under threefry (the dropout kernels read it from the
    graph's input buffer), under rbg the dropout generator reseeded to the
    same (seed, step, rank) before each replay.
    A failed capture or replay raises; nothing falls back to eager steps.

    On the CPU the K steps run in order. So do they under a process group
    (``step.dp``): its gloo collectives cannot be captured (said once on
    stderr).'''
    announced = []

    def multistep(state: TrainState, batches):
        batches = _unstack(batches)
        device = next(state.model.parameters()).device
        grouped = step.dp is not None and step.dp.size > 1
        if grouped and not announced:
            announced.append(True)
            print(f'multi-step dispatch: under a process group of '
                  f'{step.dp.size} ranks the {len(batches)} steps of a '
                  f'bundle run in order (collectives are not captured in '
                  f'CUDA graphs)', file=sys.stderr)
        per_step = []
        if device.type == 'cuda' and not grouped:
            from bmt_tpu_torch.train.graphs import StepGraphs
            if state.graphs is None:
                state.graphs = StepGraphs(device)
            for batch in batches:
                per_step.append(state.graphs.run(step, state, batch))
        else:
            for batch in batches:
                state, metrics = step(state, batch)
                per_step.append(metrics)
        return state, {k: torch.stack([torch.as_tensor(m[k])
                                       for m in per_step])
                       for k in per_step[0]}
    return multistep
