'''Switch mixture-of-experts feed-forward, top-1 routing (counterpart of
``bmt_tpu.ops.moe``).

``MoEFeedForward`` holds the JAX tree's leaves in their JAX layout, with no
transpose: the router ``router/w`` (D, E), kept fp32, and the expert-stacked
FFN ``experts/{w1 (E, D, F), b1 (E, F), w2 (E, F, D), b2 (E, D)}``. Routing
is per leading row (a batch element), so a row's output does not depend on
its batchmates.

Two forwards, as in the JAX package:

- lossless (eval mode, the decoder's cached step): each expert over every
  token, weighted by the one-hot of the chosen expert times its gate, with no
  capacity. Every token's output depends on that token alone, so the cached
  one-token decode equals the teacher-forced forward;
- capacity dispatch (training): C = max(1, min(S, ceil(S / E cf))) slots
  per expert and row, a token's slot its place among the row's tokens routed
  to that expert (a cumsum), the (B, S, E, C) dispatch and combine einsums,
  dropout on the hidden layer; a token past its expert's capacity gets 0,
  which the surrounding residual passes through.

The Switch load-balance loss E mean_b sum_e f_be P_be (f the share of a
row's tokens routed to e, P the mean router probability) is appended to an
explicit ``aux_out`` list when one is given. The einsums stay torch's: the
JAX package leaves them to XLA, outside any Pallas kernel.

Expert parallelism (``--ep_devices``; ``parallel.sharding_rules`` sets
``ep``, the group of ep ranks, and cuts the experts): a rank holds a
contiguous block of E/ep experts, the router stays whole, and every ep rank
routes the same tokens the same way (they hold the same rows). Each rank
runs its experts on the tokens routed to them, in both forwards, and the
combine is summed over the group (``ReduceFromGroup``, whose backward
passes dL/dy through, since dL/dy is the same on every rank). The input and
the gates enter the experts through ``CopyToGroup``, whose backward sums
the ranks' partial gradients, so every rank holds the whole dL/dx and the
router's whole gradient; the load-balance loss comes from the whole router
outside that sum, once.

Tensor parallelism (``mp``, the JAX rules' ``P('ep', None, 'mp')``): a rank
may also hold only its block of each expert's hidden width (``w1``'s and
``b1``'s columns, ``w2``'s rows; ``b2`` and the router whole). The input and
the gates then enter the hidden products through ``CopyToGroup`` over the
mp ranks, the partial ``h w2`` terms are summed over them
(``ReduceFromGroup``), and ``b2``'s term, the same on every mp rank, is
added after that sum; the hidden dropout draws the whole width's mask and
keeps this rank's slice.
'''
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from bmt_tpu_torch.ops.layers import Dropout, FeedForward, stream_block
from bmt_tpu_torch.parallel.mesh import CopyToGroup, ReduceFromGroup


class _Leaves(nn.Module):
    '''A JAX dict of array leaves as a module of parameters of those
    names.'''

    def __init__(self, **shapes):
        super().__init__()
        for name, (shape, device) in shapes.items():
            self.register_parameter(
                name, nn.Parameter(torch.zeros(shape, device=device)))


class MoEFeedForward(nn.Module):
    '''Top-1 MoE FFN over tokens (..., S, D) -> (..., S, D).'''

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 dout_p: float = 0.0, capacity_factor: float = 1.25,
                 device=None):
        super().__init__()
        E, D, Fd = n_experts, d_model, d_ff
        self.router = _Leaves(w=((D, E), device))
        self.experts = _Leaves(w1=((E, D, Fd), device), b1=((E, Fd), device),
                               w2=((E, Fd, D), device), b2=((E, D), device))
        self.dropout = Dropout(dout_p, batch_dim=1)     # h is (E, B, C, F)
        self.capacity_factor = capacity_factor
        self.d_ff = d_ff
        self.ep = None          # the ep ranks' group when experts are cut
        self.mp = None          # the mp ranks' group when d_ff is cut

    @torch.no_grad()
    def init_from(self, generator: torch.Generator) -> None:
        '''The JAX package's ``init_moe_ffn`` recipe: the router
        xavier-uniform, then each expert as the dense FFN is drawn (xavier
        weights, U(+-1/sqrt(fan_in)) biases).'''
        ex = self.experts
        E, D, Fd = ex.w1.shape
        _xavier(self.router.w, D, E, generator)
        for e in range(E):
            _xavier(ex.w1[e], D, Fd, generator)
            ex.b1[e].uniform_(-1 / math.sqrt(D), 1 / math.sqrt(D),
                              generator=generator)
            _xavier(ex.w2[e], Fd, D, generator)
            ex.b2[e].uniform_(-1 / math.sqrt(Fd), 1 / math.sqrt(Fd),
                              generator=generator)

    def forward(self, x: torch.Tensor, aux_out: list | None = None,
                deterministic: bool | None = None) -> torch.Tensor:
        '''``deterministic`` (default: not training) picks the lossless
        form.'''
        if deterministic is None:
            deterministic = not self.training
        ex = self.experts
        E = self.router.w.shape[1]
        n_local = ex.w1.shape[0]
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        B, S, D = x.shape
        dt = x.dtype

        # routing in fp32 (the router may arrive as a bf16 compute copy)
        probs = torch.softmax(x.float() @ self.router.w.float(), dim=-1)
        gate, e_star = probs.max(dim=-1)                          # (B, S)
        onehot = F.one_hot(e_star, E).float()                     # (B, S, E)
        if aux_out is not None:
            f, P = onehot.mean(dim=1), probs.mean(dim=1)          # (B, E)
            aux_out.append((f * P).sum(dim=-1).mean() * E)

        first = 0
        if n_local < E:          # this rank's block of experts (ep ranks)
            if self.ep is None or n_local * self.ep.size != E:
                raise ValueError(f'{n_local} of {E} experts here, but no ep '
                                 f'group of {E // max(n_local, 1)} ranks')
            first = self.ep.rank * n_local
            x = CopyToGroup.apply(x, self.ep)
            gate = CopyToGroup.apply(gate, self.ep)
        mine = slice(first, first + n_local)
        w1, b1, w2, b2 = (t.to(dt) for t in (ex.w1, ex.b1, ex.w2, ex.b2))
        mp = self.mp if ex.w1.shape[2] != self.d_ff else None
        # the input and gates of the hidden products: under mp their
        # gradients are partial on each rank and sum through CopyToGroup
        xm, gm = ((CopyToGroup.apply(x, mp), CopyToGroup.apply(gate, mp))
                  if mp is not None else (x, gate))
        if deterministic:
            y = torch.zeros_like(x)
            yb = torch.zeros_like(x) if mp is not None else None
            for i in range(n_local):
                h = F.relu(xm @ w1[i] + b1[i])
                if mp is None:
                    sel = (onehot[..., first + i] * gate).to(dt)[..., None]
                    y = y + sel * (h @ w2[i] + b2[i])
                else:
                    sel = (onehot[..., first + i] * gm).to(dt)[..., None]
                    y = y + sel * (h @ w2[i])
                    sel = (onehot[..., first + i] * gate).to(dt)[..., None]
                    yb = yb + sel * b2[i]
        else:
            C = max(1, min(S, math.ceil(S / E * self.capacity_factor)))
            # a token's slot in its expert's queue; a slot of -1 (not
            # routed there) or past C (over capacity) matches no column
            pos = torch.cumsum(onehot, dim=1) * onehot - 1.0      # (B, S, E)
            slots = (pos[..., None] == torch.arange(
                C, device=x.device, dtype=pos.dtype)).float()     # (B,S,E,C)
            dispatch = (onehot[..., None] * slots)[:, :, mine]
            xin = torch.einsum('bsec,bsd->ebcd', dispatch.to(dt), xm)
            h = F.relu(torch.einsum('ebcd,edf->ebcf', xin, w1)
                       + b1[:, None, None, :])
            h = self.dropout(h, (None if mp is None
                                 else (-1, mp.rank, mp.size),
                                 stream_block(0, (self.ep.rank, self.ep.size)
                                              if n_local < E else None)))
            if mp is None:
                out = (torch.einsum('ebcf,efd->ebcd', h, w2)
                       + b2[:, None, None, :])
                combine = (dispatch * gate[..., None, None]).to(dt)
                y = torch.einsum('bsec,ebcd->bsd', combine, out)
            else:
                out = torch.einsum('ebcf,efd->ebcd', h, w2)
                combine = (dispatch * gm[..., None, None]).to(dt)
                y = torch.einsum('bsec,ebcd->bsd', combine, out)
                combine = (dispatch * gate[..., None, None]).to(dt)
                yb = torch.einsum('bsec,ed->bsd', combine, b2)
        if mp is not None:
            y = ReduceFromGroup.apply(y.float(), mp).to(dt) + yb
        if n_local < E:
            y = ReduceFromGroup.apply(y, self.ep)
        return y[0] if squeeze else y

    def extra_repr(self) -> str:
        _, D, Fd = self.experts.w1.shape
        E = self.router.w.shape[1]
        return f'experts={E}, d_model={D}, d_ff={Fd}, ' \
               f'capacity_factor={self.capacity_factor}'


def _xavier(t: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    t.uniform_(-bound, bound, generator=generator)


def ffn_or_moe(d_model: int, d_ff: int, moe_experts: int = 0,
               dout_p: float = 0.0, capacity_factor: float = 1.25,
               device=None) -> nn.Module:
    '''A dense FFN, or a Switch MoE when ``moe_experts`` > 1 (the JAX
    package's ``_init_ffn_or_moe``).'''
    if moe_experts and moe_experts > 1:
        return MoEFeedForward(d_model, d_ff, moe_experts, dout_p,
                              capacity_factor, device)
    return FeedForward(d_model, d_ff, dout_p, device)


def ffn_apply(ff: nn.Module, x: torch.Tensor, aux_out: list | None = None,
              deterministic: bool | None = None, seq: tuple | None = None
              ) -> torch.Tensor:
    '''Run a dense or MoE FFN; only a MoE one reads ``aux_out`` and
    ``deterministic`` (the JAX package's ``ffn_apply``), only a dense one
    ``seq``, x's sequence block (``FeedForward``).'''
    if isinstance(ff, MoEFeedForward):
        return ff(x, aux_out, deterministic)
    return ff(x, seq)
