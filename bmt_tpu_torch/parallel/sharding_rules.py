'''Parameter sharding: ZeRO-3 over dp (``--fsdp``), the MoE experts over
ep (``--ep_devices``) and tensor parallelism over mp; counterpart of
``bmt_tpu.parallel.sharding_rules``.

Which leaves shard follows the JAX rules (``_spec_for``; keyed off the leaf
names there, off the modules here, which carry those names):

- mp (``DataParallel(mp=)``): the attention projections ``q2d``/``k2d``/
  ``v2d`` and the feed-forwards' ``fc1`` are column-parallel (JAX's
  ``w`` columns and ``b``), ``d2q`` and ``fc2`` row-parallel (``w`` rows;
  the bias whole), the captioners' ``generator`` column-parallel over the
  vocabulary, and the MoE experts' ``w1``/``b1`` columns and ``w2`` rows of
  their hidden width (``P('ep', None, 'mp')``); a LoRA adapter's ``lora_b``
  at a column site and ``lora_a`` at a row site; the rank dimension,
  ``lora_s``, routers, norms, embeddings, bridges, the proposal
  generators' conv heads and anchors stay whole. ``parallel.tensor`` and
  ``ops.moe`` run the cut modules. A module whose width does not divide mp
  stays whole, as the JAX guard leaves such leaves replicated; an attention
  whose H does not divide mp stays whole too, where the JAX guard still
  splits d_model's columns when they divide and GSPMD reshards them across
  heads: the port does not split a head (the same results; ROADMAP.md
  section 3);
- ep (``--ep_devices``): the expert-stacked leaves ``experts/{w1,b1,w2,b2}``
  of each ``MoEFeedForward`` keep their leading expert axis split into
  contiguous blocks of E/ep experts (``P('ep', ...)``); the router stays
  whole;
- dp (``--fsdp``): every leaf of at least ``fsdp_min_elems`` elements
  (counted whole; ``FSDP_MIN_ELEMS`` by default), after its ep and mp cuts,
  except the experts, which keep their ep blocks whole over dp (the JAX
  rules also split them over dp); with ``--sp_devices`` the sp ranks of a
  dp coordinate hold the same dp shards.

A leaf is cut in that order: its ep block, then its mp block, then the dp
shard of that. The layout of a dp shard is the port's own, which nothing
reads: the block is flattened, zero-padded to a multiple of dp, and rank r
keeps the r-th of dp equal pieces. A parameter's ``.data`` is its cut
between steps, so the optimizer's moments (made by ``zeros_like``) and the
EMA are cuts too. A train step gathers the dp shards into mp blocks before
its forward (``gather``: one ``all_gather`` a dtype) and, after its
backward, sums their gradients over the data group and keeps its piece
(``reduce_grads``: ``all_reduce``, then a slice); the parameters are pieces
again when the optimizer runs. The mp blocks and the ep blocks stay cut
through the step: their modules run on them. Only collectives that NCCL and
gloo both have are used, so one implementation serves the card's two ranks
on gloo and a card a rank on NCCL. The whole dp leaves live from a step's
gather to its backward's end, so FSDP cuts the memory a rank holds between
steps (parameters, moments, EMA) about dp-fold, not the step's peak.

Everything that reads the whole model (validation, checkpoints, resume)
runs inside ``whole``: the dp shards and the mp blocks (and the EMA, and for
checkpoints the experts and the optimizer's moments) are gathered on entry
and cut to each rank's again on exit, so the files are an unsharded run's,
key for key, and what the block loads (a JAX-layout tree, a resume) lands
on each rank as its cut.
'''
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from bmt_tpu_torch.params import named_jax_parameters

# Leaves smaller than this stay whole under --fsdp (bmt_tpu's constant):
# a LayerNorm scale or a bias saves a few KB and costs a collective.
FSDP_MIN_ELEMS = 1 << 16

# the optimizer state entries that have a parameter's shape
MOMENT_KEYS = ('exp_avg', 'exp_avg_sq', 'momentum_buffer')

# the cuts in the order they are made; gathers undo them backwards
LEVELS = ('ep', 'mp', 'dp')


@dataclasses.dataclass
class Leaf:
    '''How one parameter is cut: its whole shape, whether its leading
    (expert) axis is cut over ep, the dim cut over mp (None: whole), and
    whether its ep/mp block is cut over dp (flat).'''
    whole: tuple
    ep: bool = False
    mp: Optional[int] = None
    flat: bool = False

    @property
    def levels(self) -> tuple:
        return tuple(lv for lv, on in zip(LEVELS, (self.ep, self.mp is not
                                                   None, self.flat)) if on)


def mp_plan(model: nn.Module, n_mp: int) -> tuple:
    '''({id(parameter): its dim cut over mp}, [the modules that run cut,
    each to get the mp group]) of ``model`` over ``n_mp`` ranks, by the
    module's docstring's rules; ({}, []) for one rank.'''
    from bmt_tpu_torch.ops.attention import MultiheadAttention
    from bmt_tpu_torch.ops.layers import FeedForward
    from bmt_tpu_torch.ops.moe import MoEFeedForward
    from bmt_tpu_torch.parallel.tensor import ColumnParallelLinear
    dims, modules = {}, []
    if n_mp <= 1:
        return dims, modules

    def linear(m, column: bool):
        dims[id(m.weight)] = 0 if column else 1
        if column and m.bias is not None:
            dims[id(m.bias)] = 0
        lora = m._parameters.get('lora_b' if column else 'lora_a')
        if lora is not None:
            dims[id(lora)] = 1 if column else 0
        modules.append(m)

    for m in model.modules():
        if isinstance(m, MultiheadAttention):
            if m.H % n_mp == 0:          # a head is not split
                for lin in (m.q2d, m.k2d, m.v2d):
                    linear(lin, True)
                linear(m.d2q, False)
        elif isinstance(m, FeedForward):
            if m.fc1.out_features % n_mp == 0:
                linear(m.fc1, True)
                linear(m.fc2, False)
        elif isinstance(m, MoEFeedForward):
            if m.d_ff % n_mp == 0:
                ex = m.experts
                dims.update({id(ex.w1): 2, id(ex.b1): 1, id(ex.w2): 1})
                modules.append(m)
        elif isinstance(m, ColumnParallelLinear) and m.gather:
            if m.out_features % n_mp == 0:       # the vocabulary
                linear(m, True)
    return dims, modules


class ParamShards:
    '''The cut leaves of a ``TrainState`` (model, optimizer, EMA) over
    ``dp``'s grid. On construction each rank cuts its shards out of the
    whole state (every rank must hold the same whole state: after
    ``DataParallel.broadcast_module``) and gives the cut modules their
    groups; the optimizer reads the whole model's gradient norm through
    ``global_norm``.'''

    def __init__(self, state, dp, fsdp: bool = False,
                 min_elems: int = FSDP_MIN_ELEMS):
        from bmt_tpu_torch.ops.moe import MoEFeedForward
        self.state, self.dp = state, dp
        model = state.model
        self.names = {id(p): n for n, p in model.named_parameters()}
        mp_dims, mp_modules = mp_plan(model, dp.n_mp)
        self.leaves: dict = {}                 # id(parameter): Leaf
        self.params: dict = {}                 # id(parameter): parameter
        for path, p in named_jax_parameters(model):
            leaf = Leaf(tuple(p.shape), ep=dp.n_ep > 1 and 'experts' in path,
                        mp=mp_dims.get(id(p)))
            leaf.flat = (fsdp and dp.n_dp > 1 and not leaf.ep
                         and p.numel() >= min_elems)
            if leaf.levels:
                self.leaves[id(p)], self.params[id(p)] = leaf, p
        for m in model.modules():
            if isinstance(m, MoEFeedForward) and dp.n_ep > 1:
                E = m.experts.w1.shape[0]
                if E % dp.n_ep:
                    raise ValueError(
                        f'--ep_devices {dp.n_ep} requires --moe_experts '
                        f'divisible by it (got {E})')
                m.ep = dp.ep_group
        for m in mp_modules:
            m.mp = dp.mp_group
        self.gathered = False
        state.optimizer.shards = self
        self._cut(self._with(LEVELS), LEVELS, True)

    # -- one leaf -----------------------------------------------------------

    def _with(self, levels) -> list:
        '''The parameters cut at any of ``levels``.'''
        return [p for i, p in self.params.items()
                if set(self.leaves[i].levels) & set(levels)]

    def _group(self, level):
        return {'ep': self.dp.ep_group, 'mp': self.dp.mp_group,
                'dp': self.dp.dp_group}[level]

    def _shape(self, leaf: Leaf, levels) -> tuple:
        '''The shape of a tensor of ``leaf`` cut at ``levels``.'''
        shape = list(leaf.whole)
        if 'ep' in levels and leaf.ep:
            shape[0] //= self.dp.n_ep
        if 'mp' in levels and leaf.mp is not None:
            shape[leaf.mp] //= self.dp.n_mp
        if 'dp' in levels and leaf.flat:
            return (-(-math.prod(shape) // self.dp.n_dp),)
        return tuple(shape)

    def _own(self, leaf: Leaf, t: torch.Tensor, levels) -> torch.Tensor:
        '''This rank's cut at ``levels`` of ``t``, a tensor of ``leaf``
        joined at them.'''
        dp = self.dp
        if 'ep' in levels and leaf.ep:
            n = t.shape[0] // dp.n_ep
            t = t[dp.ep_rank * n:(dp.ep_rank + 1) * n]
        if 'mp' in levels and leaf.mp is not None:
            n = t.shape[leaf.mp] // dp.n_mp
            t = t.narrow(leaf.mp, dp.mp_rank * n, n)
        if 'dp' in levels and leaf.flat:
            s = -(-t.numel() // dp.n_dp)
            flat = t.reshape(-1)
            t = flat[dp.dp_rank * s:(dp.dp_rank + 1) * s]
            if t.numel() < s:                  # the last piece's padding
                t = torch.cat([t, flat.new_zeros(s - t.numel())])
        return t.contiguous().clone()

    def _joined(self, params, tensors, levels) -> list:
        '''The tensors of ``params`` joined at ``levels`` from each rank's
        cuts ``tensors``: one all_gather a (level, dtype), undoing the cuts
        backwards (dp, then mp, then ep).'''
        out = list(tensors)
        for level in reversed(LEVELS):
            if level not in levels:
                continue
            groups: dict = {}
            for i, (p, t) in enumerate(zip(params, out)):
                if level in self.leaves[id(p)].levels:
                    groups.setdefault(t.dtype, []).append(i)
            for idx in groups.values():
                buf = torch.cat([out[i].reshape(-1) for i in idx])
                parts = self._group(level).all_gather(buf)
                pieces = [part.split([out[i].numel() for i in idx])
                          for part in parts]
                for j, i in enumerate(idx):
                    leaf, local = self.leaves[id(params[i])], out[i].shape
                    if level == 'dp':
                        shape = self._shape(leaf, LEVELS[:LEVELS.index(
                            'dp')])
                        out[i] = torch.cat([pc[j] for pc in pieces])[
                            :math.prod(shape)].view(shape)
                    else:
                        dim = 0 if level == 'ep' else leaf.mp
                        out[i] = torch.cat([pc[j].view(local)
                                            for pc in pieces], dim=dim)
        return out

    # -- the state ----------------------------------------------------------

    def _slots(self, params, everything: bool):
        '''(parameter, getter, setter) of every tensor of the state that
        has a cut leaf's shape: the parameters, the EMA and, with
        ``everything``, the optimizer's moments.'''
        state = self.state
        for p in params:
            yield p, (lambda p=p: p.data), (lambda t, p=p: setattr(
                p, 'data', t))
            name = self.names[id(p)]
            if state.ema is not None and name in state.ema:
                yield p, (lambda n=name: state.ema[n]), (
                    lambda t, n=name: state.ema.__setitem__(n, t))
            if everything:
                slot = state.optimizer.inner.state.get(p, {})
                for key in MOMENT_KEYS:
                    if isinstance(slot.get(key), torch.Tensor):
                        yield p, (lambda s=slot, k=key: s[k]), (
                            lambda t, s=slot, k=key: s.__setitem__(k, t))

    @torch.no_grad()
    def _cut(self, params, levels, everything: bool) -> None:
        '''Cut every slot of ``params`` that is joined at ``levels`` (one a
        block loaded or made joined, or one ``_join`` joined).'''
        for p, get, put in list(self._slots(params, everything)):
            leaf, t = self.leaves[id(p)], get()
            joined = [lv for lv in leaf.levels if lv not in levels]
            if tuple(t.shape) == self._shape(leaf, joined):
                put(self._own(leaf, t, levels))

    @torch.no_grad()
    def _join(self, params, levels, everything: bool) -> None:
        slots = list(self._slots(params, everything))
        joined = self._joined([p for p, _, _ in slots],
                              [get() for _, get, _ in slots], levels)
        for (_, _, put), t in zip(slots, joined):
            put(t)

    @contextlib.contextmanager
    def whole(self, everything: bool = False):
        '''The dp shards, the mp blocks and the EMA whole inside the block,
        and with ``everything`` the experts and the optimizer's moments
        too; what the block loads into them (a resume) is cut on exit.'''
        if self.gathered:
            raise RuntimeError('the parameters are whole already')
        levels = LEVELS if everything else ('mp', 'dp')
        params = self._with(levels)
        self._join(params, levels, everything)
        self.gathered = True
        try:
            yield
        finally:
            self.gathered = False
            self._cut(params, levels, everything)

    # -- a train step -------------------------------------------------------

    @torch.no_grad()
    def gather(self) -> None:
        '''The mp blocks of the ``--fsdp`` parameters, before a step's
        forward.'''
        if self.gathered:
            raise RuntimeError('a train step inside whole(): the parameters '
                               'are whole already')
        flat = self._with(('dp',))
        if not flat:
            return
        for p, t in zip(flat, self._joined(flat, [p.data for p in flat],
                                           ('dp',))):
            p.data = t

    @torch.no_grad()
    def reduce_grads(self, params) -> list:
        '''After a step's backward: the ``--fsdp`` leaves' gradients (of
        their mp blocks) summed over the data group (the dp ranks, and the
        sp ranks, whose sequence blocks give partial gradients and which
        hold the same shards), each rank keeping its dp shard as ``.grad``
        of its shard of the parameter (one all_reduce a dtype, then a
        slice). Returns the other parameters of ``params``, whose gradients
        the caller sums over the data group.'''
        trainable = {id(p) for p in params}
        flat = self._with(('dp',))
        grads: dict = {}
        for p in flat:
            if id(p) in trainable:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads.setdefault(g.dtype, []).append((p, g))
            p.grad = None
        for entries in grads.values():
            s = [self._shape(self.leaves[id(p)], LEVELS)[0] * self.dp.n_dp
                 for p, _ in entries]
            buf = torch.cat([torch.nn.functional.pad(g.reshape(-1),
                                                     (0, n - g.numel()))
                             for (_, g), n in zip(entries, s)])
            buf = self.dp.data_group.all_reduce(buf)
            for (p, _), chunk in zip(entries, buf.split(s)):
                piece, r = chunk.numel() // self.dp.n_dp, self.dp.dp_rank
                p.data = self._own(self.leaves[id(p)], p.data, ('dp',))
                p.grad = chunk[r * piece:(r + 1) * piece].clone()
        for p in flat:
            leaf = self.leaves[id(p)]
            if tuple(p.shape) == self._shape(leaf, ('ep', 'mp')):
                p.data = self._own(leaf, p.data, ('dp',))
        cut = {id(p) for p in flat}
        return [p for p in params if id(p) not in cut]

    def global_norm(self, params, norms: torch.Tensor) -> torch.Tensor:
        '''The whole model's gradient norm from the per-parameter norms of
        ``params``' gradients (cuts for the cut leaves): the squares of the
        leaves cut alike summed over each group they are cut over, a whole
        leaf's counted once.'''
        sq = norms.square()
        by_levels: dict = {}
        for i, p in enumerate(params):
            leaf = self.leaves.get(id(p))
            by_levels.setdefault(() if leaf is None else leaf.levels,
                                 []).append(i)
        total = sq.new_zeros(())
        for levels, idx in by_levels.items():
            part = sq[torch.tensor(idx, device=sq.device)].sum()
            for level in levels:
                part = self._group(level).all_reduce(part)
            total = total + part
        return total.sqrt()

    def bytes(self) -> dict:
        '''This rank's bytes of the cut leaves and of the others, for the
        parameters, the optimizer's moments and the EMA.'''
        out = {'sharded': 0, 'whole': 0}
        state = self.state
        for p in state.model.parameters():
            key = 'sharded' if id(p) in self.leaves else 'whole'
            n = p.numel() * p.element_size()
            slot = state.optimizer.inner.state.get(p, {})
            n += sum(v.numel() * v.element_size() for k, v in slot.items()
                     if k in MOMENT_KEYS)
            if state.ema is not None:
                e = state.ema.get(self.names[id(p)])
                n += 0 if e is None else e.numel() * e.element_size()
            out[key] += n
        return out
