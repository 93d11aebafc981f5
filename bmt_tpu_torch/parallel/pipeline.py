'''Pipeline parallelism over a group of ``pp`` ranks, GPipe microbatching
(counterpart of ``bmt_tpu.parallel.pipeline``).

As in the JAX module, the scope is a standalone pipelined layer stack with
its forward and gradients (no trainer runs it):

- an N-layer stack splits into pp stages of N/pp consecutive layers, and a
  rank holds only its stage (``stack_layer_params``);
- the batch splits into ``n_micro`` microbatches, and the schedule runs
  ``n_micro + pp - 1`` ticks: at tick t, stage s runs microbatch t - s when
  0 <= t - s < n_micro and idles otherwise (JAX runs every stage every tick
  and feeds the idle ones a real microbatch, only to keep NaN out of its
  ``scan``; here an idle stage computes nothing);
- after each tick, one point-to-point hop (``Hop``, the counterpart of the
  ``ppermute``) sends what a stage made to the next rank and receives what
  the previous rank made. The sends and receives of a hop are posted
  together (``batch_isend_irecv``: blocking ones around a ring deadlock)
  and tagged by the tick. ``Hop`` is an autograd Function: its backward
  sends the gradient of what arrived back to the previous rank and receives
  the gradient of what was sent from the next one (the inverse
  permutation). A token threads the hops of a rank into one chain, so every
  hop's backward runs, and in the reverse order of the ticks on every rank;
- the last stage's outputs are joined in row order and replicated over the
  group by ``ReduceFromGroup`` on zeros elsewhere (the masked ``psum``),
  whose backward hands each rank the output gradient; the inputs enter
  through ``CopyToGroup`` (and start the token's chain, so every rank runs
  that backward), so their gradient (stage 0's) is whole on every rank.
  So ``backward`` of a pipelined forward is the pipelined backward, with
  the bubble (pp - 1) / (n_micro + pp - 1) in both directions.

Under gloo, CUDA tensors travel through host copies (as ``Group``'s
collectives do). Dropout: with a threefry ``key``, the layer j of stage s
at tick t draws from a stream of fold_in(fold_in(key, s n_local + j), t),
as JAX's (``pipeline.py:99-100``), so the masks are JAX's pipelined ones
bit for bit (not the sequential stack's: a layer's key depends on its
tick). With a ``generator`` instead (rbg), each (stage layer, tick) draws
from a generator of its own, seeded from one draw of ``generator`` and that
pair (``train.steps.step_seed``).
'''
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from bmt_tpu_torch.ops.layers import dropout_generator, key_stream
from bmt_tpu_torch.ops import prng
from bmt_tpu_torch.parallel.mesh import CopyToGroup, Group, ReduceFromGroup


def stage_group(device='cuda') -> Group:
    '''The whole process group as a pipeline's group: rank r holds stage
    r. Under gloo CUDA tensors travel through host copies.'''
    if not dist.is_initialized():
        return Group()
    host = dist.get_backend() == 'gloo' and torch.device(device).type != 'cpu'
    return Group(None, dist.get_world_size(), dist.get_rank(), host)


def stack_layer_params(layers, pp: int, stage: int) -> nn.ModuleList:
    '''Stage ``stage``'s layers of an N-layer stack split into ``pp``
    stages: layers [stage N/pp, (stage + 1) N/pp). Raises ValueError when N
    does not divide by pp (JAX's ``stack_layer_params``).'''
    n = len(layers)
    if n % pp:
        raise ValueError(f'{n} layers do not split into {pp} stages')
    if not 0 <= stage < pp:
        raise ValueError(f'stage {stage} of {pp}')
    per = n // pp
    return nn.ModuleList(list(layers)[stage * per:(stage + 1) * per])


def _exchange(group: Group, sent, to: Optional[int], templates,
              frm: Optional[int], tag: int) -> list:
    '''Send the tensors ``sent`` to group rank ``to`` and receive tensors
    shaped like ``templates`` from group rank ``frm`` (either may be None),
    every send and receive posted together; returns what arrived, on the
    templates' devices.'''
    ops = []
    for t in (sent if to is not None else ()):
        buf = t.detach()
        buf = buf.cpu() if group.host else buf.contiguous()
        ops.append(dist.P2POp(dist.isend, buf, group.ranks[to], group.handle,
                              tag))
    got = []
    for t in (templates if frm is not None else ()):
        buf = torch.empty(t.shape, dtype=t.dtype,
                          device='cpu' if group.host else t.device)
        got.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, group.ranks[frm],
                              group.handle, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [g.to(t.device) for g, t in zip(got, templates)]


class Hop(torch.autograd.Function):
    '''One tick's hop: forward sends ``sent`` to the next stage (``to``)
    and returns a new token and what arrives from the previous stage
    (``frm``), shaped like ``templates``; backward sends the gradient of
    what arrived to ``frm`` and returns the gradient of ``sent`` received
    from ``to``. ``tag`` tells the ticks apart.'''

    @staticmethod
    def forward(ctx, token, group, to, frm, tag, templates, *sent):
        ctx.group, ctx.to, ctx.frm, ctx.tag = group, to, frm, tag
        ctx.sent = [(t.shape, t.dtype, t.device) for t in sent]
        got = _exchange(group, sent, to, templates, frm, tag)
        ctx.mark_non_differentiable(*[g for g in got
                                      if not g.is_floating_point()])
        return (token.new_empty(0), *got)

    @staticmethod
    def backward(ctx, g_token, *g_got):
        back = [g for g in g_got if g is not None and g.is_floating_point()]
        want = [torch.empty(shape, dtype=dtype, device=device)
                for shape, dtype, device in ctx.sent
                if dtype.is_floating_point]
        grads = _exchange(ctx.group, [g.contiguous() for g in back],
                          ctx.frm if back else None, want,
                          ctx.to if want else None, ctx.tag)
        it = iter(grads)
        g_sent = [next(it) if dtype.is_floating_point else None
                  for _, dtype, _ in ctx.sent]
        return (g_token.new_zeros(0), None, None, None, None, None,
                *g_sent)


class Tie(torch.autograd.Function):
    '''An empty tensor that depends on the tensors given: its backward gives
    them exact zero gradients.'''

    @staticmethod
    def forward(ctx, *xs):
        ctx.likes = [(x.shape, x.dtype, x.device) for x in xs]
        return xs[0].new_empty(0)

    @staticmethod
    def backward(ctx, g):
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.likes)


def pipeline_layer_stack(stage_layers, inputs: tuple, layer_fn: Callable,
                         group: Group, n_micro: int,
                         generator: Optional[torch.Generator] = None,
                         key=None) -> tuple:
    '''Run ``layer_fn`` over every layer of a stack split into stages over
    ``group`` (this rank, ``group.rank``, holds stage ``stage_layers``,
    from ``stack_layer_params``), pipelined over ``n_micro`` microbatches.

    inputs:   tuple of (B, ...) tensors threaded through the layers,
              unchanged in shape and dtype (constants such as masks ride
              along; ``layer_fn`` returns them);
    layer_fn: (layer, carry tuple) -> carry tuple;
    n_micro:  the microbatch count; B must divide by it;
    generator: when given, dropout draws per (stage layer, tick) as the
              module's docstring says;
    key:      a threefry ``prng.Key`` (or key tensor) in its place.

    Returns the carry at (B, ...) shapes, the same on every rank.'''
    pp, stage = group.size, group.rank
    B = inputs[0].shape[0]
    if B % n_micro:
        raise ValueError(f'batch {B} not divisible by n_micro={n_micro}')
    n_local = len(stage_layers)
    base = None
    if generator is not None:
        from bmt_tpu_torch.train.steps import step_seed
        base = int(torch.randint(2 ** 62, (1,), generator=generator,
                                 device=generator.device))
    inputs = tuple(CopyToGroup.apply(x, group) if x.requires_grad else x
                   for x in inputs)
    mbs = list(zip(*(x.chunk(n_micro) for x in inputs)))
    templates = mbs[0]
    # the token starts from the inputs, so every rank runs their
    # CopyToGroup backward (stage 0's gradient, zeros elsewhere, summed)
    tied = [x for x in inputs if x.requires_grad]
    token = (Tie.apply(*tied) if tied else torch.empty(
        0, device=inputs[0].device, requires_grad=True))

    def runs(s: int, t: int) -> bool:
        return 0 <= t - s < n_micro
    done, carry = [], None
    for t in range(n_micro + pp - 1):
        out = None
        if runs(stage, t):
            carry = mbs[t] if stage == 0 else carry
            for j, layer in enumerate(stage_layers):
                if key is not None:
                    with key_stream(prng.as_key(key).fold_in(
                            stage * n_local + j, t)):
                        carry = tuple(layer_fn(layer, carry))
                    continue
                if base is None:
                    carry = tuple(layer_fn(layer, carry))
                    continue
                g = torch.Generator(device=generator.device)
                g.manual_seed(step_seed(base, t, stage * n_local + j))
                with dropout_generator(g):
                    carry = tuple(layer_fn(layer, carry))
            out = carry
            if stage == pp - 1:
                done.append(out)
        to = stage + 1 if out is not None and stage < pp - 1 else None
        frm = stage - 1 if stage > 0 and runs(stage - 1, t) else None
        token, *got = Hop.apply(token, group, to, frm, t, templates,
                                *(out if to is not None else ()))
        carry = tuple(got) if frm is not None else None
    if stage == pp - 1:
        result = [torch.cat(xs) for xs in zip(*done)]
    else:
        result = [torch.zeros_like(x) for x in inputs]
    out = []
    for x in result:
        if x.is_floating_point():
            # the token's empty sum is an exact 0: it ties every hop to the
            # output, so each hop's backward runs
            out.append(ReduceFromGroup.apply(x, group) + token.sum())
        elif x.dtype == torch.bool:
            out.append(group.all_reduce(x.to(torch.int32)).bool())
        else:
            out.append(group.all_reduce(x))
    return tuple(out)


def pipelined_bimodal_encoder_forward(stage_layers, A, V, A_mask, V_mask,
                                      group: Group, n_micro: int,
                                      generator=None,
                                      attention_impl: str = 'torch',
                                      key=None):
    '''The pipelined ``models.encoders.BiModalEncoder`` forward (JAX
    ``pipelined_bimodal_encoder_forward``): this rank's stage of
    ``BiModalEncoderLayer``s (``stack_layer_params(encoder.layers, pp,
    rank)``) over the (A, V, masks) microbatches. Returns (Av, Va), the
    same on every rank.'''
    def layer_fn(layer, carry):
        M1, M2, m1, m2 = carry
        M1, M2 = layer(M1, M2, m1, m2, attention_impl)
        return M1, M2, m1, m2

    Av, Va, _, _ = pipeline_layer_stack(stage_layers, (A, V, A_mask, V_mask),
                                        layer_fn, group, n_micro, generator,
                                        key)
    return Av, Va
