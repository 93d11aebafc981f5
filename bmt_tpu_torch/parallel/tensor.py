'''Tensor parallelism over the ``mp`` ranks: Megatron's column- and
row-parallel linears. The JAX package has no such module: there
``parallel.sharding_rules`` places the weights and GSPMD inserts the
collectives; here they are written out.

A parallel linear is an ``nn.Linear`` that keeps its whole
``in_features``/``out_features``. ``parallel.sharding_rules.ParamShards``
cuts its ``weight`` (and bias) to this rank's block and sets ``mp``, the
group of the mp ranks; the linear tells a block from the whole weight by
its shape, so with the whole weight (one process, or inside
``DataParallel.whole``) it is exactly ``nn.Linear``.

- ``ColumnParallelLinear``: this rank's block of output features. The input
  enters through ``CopyToGroup`` ("f": the identity, whose backward sums the
  ranks' partial input gradients), so the layers before it see the whole
  input gradient. With ``gather`` (the captioners' ``generator``) the
  blocks are joined along the features by ``GatherFromGroup``, whose
  backward keeps this rank's slice, so the log-softmax, the loss, argmax,
  beam search and sampling read the whole vocabulary unchanged.
- ``RowParallelLinear``: this rank's block of input features (the output of
  a column-parallel block); the partial products are summed over the group
  by ``ReduceFromGroup`` ("g", whose backward passes the gradient through)
  and the bias, whole on every rank, is added once after the sum. The sum
  runs in fp32 whatever the compute dtype.

A LoRA adapter on a parallel linear (``ops.lora``) follows the JAX layout:
at a column site ``lora_b`` holds this rank's output columns and the
rank-r product ``x A`` enters through ``CopyToGroup``; at a row site
``lora_a`` holds this rank's input rows and ``x A`` is summed over the
group before ``B``. ``adapter_delta`` computes the delta either way.

``block(linear, dim)`` gives a ``Dropout`` inside a column-parallel block
where this rank's slice lies (``ops.layers.Dropout``), so a rank draws its
slice of the mask that one process would draw for the whole tensor.
'''
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bmt_tpu_torch.parallel.mesh import CopyToGroup, ReduceFromGroup


class GatherFromGroup(torch.autograd.Function):
    '''y = the ranks' equal-shaped x joined along the last dim in group
    order; the backward keeps this rank's slice of dL/dy, which every rank
    holds whole.'''

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return torch.cat(group.all_gather(x.contiguous()), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g.narrow(-1, r * n, n).contiguous(), None


def is_sharded(linear: nn.Module) -> bool:
    '''Whether a linear holds an mp block of its weight rather than the
    whole (modules without a ``weight``, as ``ops.quant.Int8Linear``, are
    whole).'''
    w = getattr(linear, 'weight', None)
    return w is not None and tuple(w.shape) != (linear.out_features,
                                                linear.in_features)


def shards(linear: nn.Module) -> int:
    '''The number of mp blocks a linear's weight is cut into (1: whole).'''
    return linear.mp.size if is_sharded(linear) else 1


def block(linear: nn.Module, dim: int) -> Optional[tuple]:
    '''(dim, rank, ranks) of this rank's slice along ``dim`` of a tensor
    that a sharded column-parallel ``linear`` made; None when it is
    whole.'''
    if not is_sharded(linear):
        return None
    return dim, linear.mp.rank, linear.mp.size


class ColumnParallelLinear(nn.Linear):
    '''``nn.Linear`` whose output features may be split over the mp ranks
    (see the module's docstring); ``gather`` joins the blocks.'''

    def __init__(self, in_features: int, out_features: int, bias=True,
                 device=None, dtype=None, gather: bool = False):
        super().__init__(in_features, out_features, bias, device, dtype)
        self.mp = None
        self.gather = gather

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not is_sharded(self):
            return F.linear(x, self.weight, self.bias)
        y = F.linear(CopyToGroup.apply(x, self.mp), self.weight, self.bias)
        return GatherFromGroup.apply(y, self.mp) if self.gather else y

    def adapter_delta(self, x, a, b, s) -> torch.Tensor:
        '''The LoRA delta ``(x A) B s`` in A's dtype, with ``b`` this rank's
        output columns when the linear is sharded.'''
        h = x.to(a.dtype) @ a
        if not is_sharded(self):
            return (h @ b) * s
        d = (CopyToGroup.apply(h, self.mp) @ b) * s
        return GatherFromGroup.apply(d, self.mp) if self.gather else d


class RowParallelLinear(nn.Linear):
    '''``nn.Linear`` whose input features may be split over the mp ranks
    (see the module's docstring).'''

    def __init__(self, in_features: int, out_features: int, bias=True,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias, device, dtype)
        self.mp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not is_sharded(self):
            return F.linear(x, self.weight, self.bias)
        y = ReduceFromGroup.apply(F.linear(x, self.weight).float(),
                                  self.mp).to(x.dtype)
        return y if self.bias is None else y + self.bias

    def adapter_delta(self, x, a, b, s) -> torch.Tensor:
        '''The LoRA delta ``(x A) B s`` in A's dtype, with ``x`` and ``a``
        this rank's input rows when the linear is sharded.'''
        h = x.to(a.dtype) @ a
        if is_sharded(self):
            h = ReduceFromGroup.apply(h, self.mp)
        return (h @ b) * s
