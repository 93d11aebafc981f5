'''Parameter sharding: ZeRO-3 over dp (``--fsdp``) and the MoE experts over
ep (``--ep_devices``); counterpart of ``bmt_tpu.parallel.sharding_rules``
(its ``mp`` rules, tensor parallelism, are not ported: ROADMAP queue 1
item 11).

Which leaves shard follows the JAX rules: under ``--fsdp`` every leaf of at
least ``fsdp_min_elems`` elements (``FSDP_MIN_ELEMS`` by default) is split
over the dp ranks and smaller ones stay whole on every rank; under
``--ep_devices`` the expert-stacked leaves ``experts/{w1,b1,w2,b2}`` of each
``MoEFeedForward`` keep their leading expert axis split into contiguous
blocks of E/ep experts (``P('ep', ...)``), and the router stays whole.
With both, the experts keep only their ep blocks (the JAX rules also split
them over dp); with ``--sp_devices`` the sp ranks of a dp coordinate hold
the same dp shards.

The layout of a dp shard is the port's own, which nothing reads: a leaf is
flattened, zero-padded to a multiple of dp, and rank r keeps the r-th of dp
equal pieces; the parameter's ``.data`` is that piece between steps, so
the optimizer's moments (made by ``zeros_like``) and the EMA are shards
too. A train step gathers the whole leaves before its forward
(``gather``: one ``all_gather`` a dtype) and, after its backward, sums the
whole gradients over the dp ranks and keeps its piece (``reduce_grads``:
``all_reduce``, then a slice); the parameters are pieces again when the
optimizer runs. Only collectives that NCCL and gloo both have are used, so
one implementation serves the card's two ranks on gloo and a card a rank on
NCCL. The whole leaves live from a step's gather to its backward's end, so
FSDP cuts the memory a rank holds between steps (parameters, moments, EMA)
about dp-fold, not the step's peak.

Everything that reads the whole model (validation, checkpoints, resume)
runs inside ``whole``: the leaves (and the EMA, and for checkpoints the
experts and the optimizer's moments) are gathered on entry and cut to each
rank's shard on exit, so the files are an unsharded run's, key for key.
'''
from __future__ import annotations

import contextlib
import math

import torch

from bmt_tpu_torch.params import named_jax_parameters

# Leaves smaller than this stay whole under --fsdp (bmt_tpu's constant):
# a LayerNorm scale or a bias saves a few KB and costs a collective.
FSDP_MIN_ELEMS = 1 << 16

# the optimizer state entries that have a parameter's shape
MOMENT_KEYS = ('exp_avg', 'exp_avg_sq', 'momentum_buffer')


class ParamShards:
    '''The sharded leaves of a ``TrainState`` (model, optimizer, EMA) over
    ``dp``'s grid. On construction each rank cuts its shards out of the
    whole state (every rank must hold the same whole state: after
    ``DataParallel.broadcast_module``); the optimizer reads the whole
    model's gradient norm through ``global_norm``.'''

    def __init__(self, state, dp, fsdp: bool = False,
                 min_elems: int = FSDP_MIN_ELEMS):
        from bmt_tpu_torch.ops.moe import MoEFeedForward
        self.state, self.dp = state, dp
        model = state.model
        self.names = {id(p): n for n, p in model.named_parameters()}
        self.flat, self.experts = [], []      # (parameter, whole shape)
        for path, p in named_jax_parameters(model):
            if dp.n_ep > 1 and 'experts' in path:
                self.experts.append((p, tuple(p.shape)))
            elif fsdp and dp.n_dp > 1 and p.numel() >= min_elems:
                self.flat.append((p, tuple(p.shape)))
        for m in model.modules():
            if isinstance(m, MoEFeedForward) and dp.n_ep > 1:
                E = m.experts.w1.shape[0]
                if E % dp.n_ep:
                    raise ValueError(
                        f'--ep_devices {dp.n_ep} requires --moe_experts '
                        f'divisible by it (got {E})')
                m.ep = dp.ep_group
        self.kind = {id(p): 'flat' for p, _ in self.flat}
        self.kind.update({id(p): 'experts' for p, _ in self.experts})
        self.whole_shape = {id(p): s for p, s in self.flat + self.experts}
        self.gathered = False
        state.optimizer.shards = self
        self._cut(self.flat + self.experts, True)

    # -- one leaf -----------------------------------------------------------

    def _piece(self, p) -> int:
        '''Elements of a dp shard of ``p``.'''
        return -(-math.prod(self.whole_shape[id(p)]) // self.dp.n_dp)

    def own(self, p, t: torch.Tensor) -> torch.Tensor:
        '''This rank's shard of ``t``, a whole tensor of ``p``'s shape.'''
        if self.kind[id(p)] == 'experts':
            n = t.shape[0] // self.dp.n_ep
            return t[self.dp.ep_rank * n:(self.dp.ep_rank + 1) * n].clone()
        s = self._piece(p)
        flat = t.reshape(-1)
        r = self.dp.dp_rank
        out = flat[r * s:(r + 1) * s]
        if out.numel() < s:                    # the last piece's padding
            out = torch.cat([out, flat.new_zeros(s - out.numel())])
        return out.clone()

    def _gathered(self, leaves, tensors) -> list:
        '''The whole tensors of ``leaves`` (parameters) from each rank's
        shards ``tensors``: one all_gather a (kind, dtype).'''
        out = [None] * len(tensors)
        groups: dict = {}
        for i, (p, t) in enumerate(zip(leaves, tensors)):
            groups.setdefault((self.kind[id(p)], t.dtype), []).append(i)
        for (kind, _), idx in groups.items():
            group = (self.dp.ep_group if kind == 'experts'
                     else self.dp.dp_group)
            buf = torch.cat([tensors[i].reshape(-1) for i in idx])
            parts = group.all_gather(buf)
            sizes = [tensors[i].numel() for i in idx]
            pieces = [part.split(sizes) for part in parts]
            for j, i in enumerate(idx):
                shape = self.whole_shape[id(leaves[i])]
                if kind == 'experts':
                    local = tensors[i].shape
                    out[i] = torch.cat([pc[j].view(local) for pc in pieces])
                else:
                    out[i] = torch.cat([pc[j] for pc in pieces])[
                        :math.prod(shape)].view(shape)
        return out

    # -- the state ----------------------------------------------------------

    def _slots(self, leaves, everything: bool):
        '''(parameter, getter, setter) of every tensor of the state that
        has a sharded leaf's shape: the parameters, the EMA and, with
        ``everything``, the optimizer's moments.'''
        state = self.state
        for p, _ in leaves:
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
    def _cut(self, leaves, everything: bool) -> None:
        for p, get, put in list(self._slots(leaves, everything)):
            t = get()
            if tuple(t.shape) == self.whole_shape[id(p)]:
                put(self.own(p, t))

    @torch.no_grad()
    def _join(self, leaves, everything: bool) -> None:
        slots = list(self._slots(leaves, everything))
        whole = self._gathered([p for p, _, _ in slots],
                               [get() for _, get, _ in slots])
        for (_, _, put), t in zip(slots, whole):
            put(t)

    @contextlib.contextmanager
    def whole(self, everything: bool = False):
        '''The ``--fsdp`` leaves and the EMA whole inside the block, and
        with ``everything`` the experts and the optimizer's moments too;
        what the block loads into them (a resume) is cut on exit.'''
        if self.gathered:
            raise RuntimeError('the parameters are whole already')
        leaves = self.flat + (self.experts if everything else [])
        self._join(leaves, everything)
        self.gathered = True
        try:
            yield
        finally:
            self.gathered = False
            self._cut(leaves, everything)

    # -- a train step -------------------------------------------------------

    @torch.no_grad()
    def gather(self) -> None:
        '''The whole ``--fsdp`` parameters, before a step's forward.'''
        if self.gathered:
            raise RuntimeError('a train step inside whole(): the parameters '
                               'are whole already')
        if not self.flat:
            return
        leaves = [p for p, _ in self.flat]
        for p, t in zip(leaves, self._gathered(leaves,
                                               [p.data for p in leaves])):
            p.data = t

    @torch.no_grad()
    def reduce_grads(self, params) -> list:
        '''After a step's backward: the ``--fsdp`` leaves' whole gradients
        summed over the data group (the dp ranks, and the sp ranks, whose
        sequence blocks give partial gradients and which hold the same
        shards), each rank keeping its dp shard as ``.grad`` of its shard
        of the parameter (one all_reduce a dtype, then a slice). Returns
        the other parameters of ``params``, whose gradients the caller sums
        over the data group.'''
        trainable = {id(p) for p in params}
        flat = [p for p, _ in self.flat]
        grads: dict = {}
        for p in flat:
            if id(p) in trainable:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                grads.setdefault(g.dtype, []).append((p, g))
            p.grad = None
        for entries in grads.values():
            s = [self._piece(p) * self.dp.n_dp for p, _ in entries]
            buf = torch.cat([torch.nn.functional.pad(g.reshape(-1),
                                                     (0, n - g.numel()))
                             for (_, g), n in zip(entries, s)])
            buf = self.dp.data_group.all_reduce(buf)
            for (p, _), chunk in zip(entries, buf.split(s)):
                r, piece = self.dp.dp_rank, self._piece(p)
                p.data = self.own(p, p.data)
                p.grad = chunk[r * piece:(r + 1) * piece].clone()
        for p in flat:
            if tuple(p.shape) == self.whole_shape[id(p)]:
                p.data = self.own(p, p.data)
        return [p for p in params if self.kind.get(id(p)) != 'flat']

    def global_norm(self, params, norms: torch.Tensor) -> torch.Tensor:
        '''The whole model's gradient norm from the per-parameter norms of
        ``params``' gradients (shards for the sharded leaves): the squares
        of each kind's shards summed over its group.'''
        sq = norms.square()
        total = sq.new_zeros(())
        for kind, group in (('flat', self.dp.dp_group),
                            ('experts', self.dp.ep_group), (None, None)):
            idx = [i for i, p in enumerate(params)
                   if self.kind.get(id(p)) == kind]
            if not idx:
                continue
            part = sq[torch.tensor(idx, device=sq.device)].sum()
            total = total + (part if group is None
                             else group.all_reduce(part))
        return total.sqrt()

    def bytes(self) -> dict:
        '''This rank's bytes of the sharded leaves and of the others, for
        the parameters, the optimizer's moments and the EMA.'''
        out = {'sharded': 0, 'whole': 0}
        state = self.state
        for p in state.model.parameters():
            key = 'sharded' if id(p) in self.kind else 'whole'
            n = p.numel() * p.element_size()
            slot = state.optimizer.inner.state.get(p, {})
            n += sum(v.numel() * v.element_size() for k, v in slot.items()
                     if k in MOMENT_KEYS)
            if state.ema is not None:
                e = state.ema.get(self.names[id(p)])
                n += 0 if e is None else e.numel() * e.element_size()
            out[key] += n
        return out
