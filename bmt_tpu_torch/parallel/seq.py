'''Sequence (context) parallelism over the ``sp`` ranks (counterpart of
``bmt_tpu.parallel.seq``), for the proposal generators' long sequences
(Sa = 800 audio and Sv = 300 video rows).

``DataParallel.shard`` gives each sp rank its contiguous block of every
``(B, S, D)`` feature leaf whose S divides sp (a leaf that does not divide
stays whole, as the JAX package leaves it) and names those leaves in the
batch's ``'seq_split'``. The proposal steps gather the key padding masks
over sp (``gather_mask``) and run the model inside ``sequence_parallel``;
the model then tells a block from a whole sequence by its length against
its mask's, and at the JAX package's ``shard_seq`` sites:

- attention: the rank's query block attends the keys and values of the
  whole sequence, all-gathered (``keys``); the backward sums each key
  row's gradient over the ranks and returns it to its owner;
- positional encoding, the YOLO grid and the targets start at the block's
  first row (``offset``);
- the conv heads' first conv reads k // 2 rows of each neighbour's block
  (``halo``; zeros beyond the sequence's ends, its "same" padding), whose
  gradients go back to the neighbours; the other convs are pointwise;
- validation's predictions are gathered in sequence order (``gather``).

Outside a ``sequence_parallel`` block (or with one sp rank) every helper
is the identity, so the other paths are untouched. Where the JAX package
leaves the collectives to GSPMD, the port writes them with the
``all_gather`` and ``all_reduce`` that NCCL and gloo both have.
'''
from __future__ import annotations

import contextlib
import types
from typing import Optional

import torch

# process-wide, not per thread: on the card the autograd engine runs the
# backward, and with it the recompute of a checkpointed (remat) layer, on a
# thread of its own, which must see the step's group
_STATE = types.SimpleNamespace(group=None)


def active():
    '''The sp ``parallel.mesh.Group`` of the running step, or None.'''
    return _STATE.group


@contextlib.contextmanager
def sequence_parallel(group):
    '''Run the block with ``group`` (the sp ranks) as the sequence-parallel
    group; None or a group of one rank leaves the helpers the identity.'''
    prev = active()
    _STATE.group = group if group is not None and group.size > 1 else None
    try:
        yield
    finally:
        _STATE.group = prev


def _group_for(length: int, whole: int):
    '''The active group when a sequence of ``length`` rows is a block of one
    of ``whole`` rows; None when it is whole.'''
    if length == whole:
        return None
    group = active()
    if group is None or length * group.size != whole:
        raise ValueError(f'a sequence of {length} rows against a mask of '
                         f'{whole}: not a block of an active '
                         f'sequence_parallel group')
    return group


def offset(length: int, whole: int) -> int:
    '''The first row of this rank's block of ``length`` rows in a sequence
    of ``whole`` rows; 0 for a whole sequence.'''
    group = _group_for(length, whole)
    return 0 if group is None else group.rank * length


def part(length: int, whole: int) -> Optional[tuple]:
    '''(rank, ranks) when a sequence of ``length`` rows is this rank's block
    of one of ``whole`` rows (its dropout masks are that block of the whole
    sequence's); None when it is whole.'''
    group = _group_for(length, whole)
    return None if group is None else (group.rank, group.size)


def part_of(x: torch.Tensor, mask: Optional[torch.Tensor]) -> Optional[tuple]:
    '''``part`` of x (B, S, D) against its key padding mask (B, 1, S); None
    without a mask.'''
    return None if mask is None else part(x.shape[1], mask.shape[-1])


class _GatherSeq(torch.autograd.Function):
    '''All ranks' blocks joined along ``dim``; the backward sums the whole
    gradient over the ranks and keeps this rank's block.'''

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return torch.cat(group.all_gather(x.contiguous()), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.all_reduce(g.contiguous())
        return g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n), None, None


def gather(x: torch.Tensor, whole: int, dim: int = 1) -> torch.Tensor:
    '''``x`` (this rank's block along ``dim``) joined into the sequence of
    ``whole`` rows; ``x`` itself when it is whole.'''
    group = _group_for(x.shape[dim], whole)
    if group is None:
        return x
    return _GatherSeq.apply(x, group, dim)


def keys(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    '''The keys and values an attention over ``x`` (B, S, D) reads: the
    whole sequence when ``x`` is a block of the one ``mask`` (B, 1, S)
    covers (a mask of None: ``x`` is whole).'''
    return x if mask is None else gather(x, mask.shape[-1], 1)


def gather_mask(mask: torch.Tensor) -> torch.Tensor:
    '''A key padding mask (B, 1, S/sp) of this rank's block as the whole
    sequence's (B, 1, S).'''
    group = active()
    if group is None:
        return mask
    parts = group.all_gather(mask.to(torch.uint8))   # gloo has no bool
    return torch.cat(parts, dim=-1).to(mask.dtype)


class _Halo(torch.autograd.Function):
    '''x (B, D, L) with the h rows before and after it along the last dim:
    the previous rank's last and the next rank's first, zeros at the
    sequence's ends; the backward returns the halo rows' gradients to their
    owners.'''

    @staticmethod
    def forward(ctx, x, group, h):
        ctx.group, ctx.h = group, h
        firsts = group.all_gather(x[..., :h].contiguous())
        lasts = group.all_gather(x[..., -h:].contiguous())
        r, n = group.rank, group.size
        zeros = torch.zeros_like(firsts[0])
        return torch.cat([lasts[r - 1] if r > 0 else zeros, x,
                          firsts[r + 1] if r < n - 1 else zeros], dim=-1)

    @staticmethod
    def backward(ctx, g):
        group, h = ctx.group, ctx.h
        r, n = group.rank, group.size
        before = group.all_gather(g[..., :h].contiguous())
        after = group.all_gather(g[..., -h:].contiguous())
        dx = g[..., h:-h].clone()
        if r < n - 1:
            dx[..., -h:] += before[r + 1]
        if r > 0:
            dx[..., :h] += after[r - 1]
        return dx, None, None


def halo(x: torch.Tensor, h: int, whole: int) -> Optional[torch.Tensor]:
    '''x (B, D, L), a block of a sequence of ``whole`` rows, with h rows of
    its neighbours on each side; None when ``x`` is whole (the caller pads
    as usual). A halo wider than a block raises.'''
    group = _group_for(x.shape[-1], whole)
    if group is None:
        return None
    if h > x.shape[-1]:
        raise ValueError(f'a conv halo of {h} rows is wider than a block of '
                         f'{x.shape[-1]} rows: use fewer --sp_devices')
    if h == 0:
        return x
    return _Halo.apply(x, group, h)
