'''Multi-head attention with heterogeneous Q/K/V model dims (counterpart of
``bmt_tpu.ops.attention``).

Queries, keys and values may live in different model dims (audio 128-d
attending video 1024-d); all are projected into a shared ``d_model`` (H heads
of d_model / H) by three separate projections, and the output is projected
back to the query's dim. Dropout acts on the attention *output*, not on the
weights.

``attention_impl`` selects the attention core of the full-sequence forward:
``'torch'`` is the plain math (``scaled_dot_attention``, JAX's ``'xla'``) and
``'kernel'`` the fused CUDA kernel (``flash_attention``, JAX's
``'pallas'``). The one-token decode steps always run the plain math: at
Sq = 1 they are matrix-vector products, where the JAX package measured the
fused kernel's per-call cost as a loss.

The decode steps' cross-attention K/V can be stored int8
(``precompute_kv(quantize=True)``), and beam search shares them across
beams (``cross_attention_step`` folds the beams into query positions).
Their logits are fp32, as JAX's ``preferred_element_type=float32``: the
operands are upcast before the product, as ``scaled_dot_attention`` does.

Tensor parallelism (``parallel.tensor``): ``q2d``/``k2d``/``v2d`` are
column-parallel and ``d2q`` row-parallel, so a rank whose projections hold
its mp block runs ``heads`` = H/mp of the heads, the kernels among them, and
the decode steps keep K/V caches (int8 ones too, their scales per channel)
of those heads only. ``parallel.sharding_rules`` cuts them only when H
divides over mp: a head is not split.
'''
from __future__ import annotations

import math

import torch
from torch import nn

from bmt_tpu_torch.ops.flash_attention import flash_attention
from bmt_tpu_torch.ops.layers import Dropout, stream_block
from bmt_tpu_torch.ops.quant import per_127
from bmt_tpu_torch.parallel import tensor
from bmt_tpu_torch.parallel.tensor import (ColumnParallelLinear,
                                           RowParallelLinear)

ATTENTION_IMPLS = ('torch', 'kernel')


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: torch.Tensor | None) -> torch.Tensor:
    '''softmax(q k^T / sqrt(d_k)) v with boolean masking (True = attend).

    q (B, H, Sq, d_k), k/v (B, H, Sk, d_k), mask broadcastable to
    (B, H, Sq, Sk). Logits and softmax are fp32; masked logits are -inf, so
    a row with no valid key is NaN. The weights are cast to v's dtype for
    the value product.'''
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask, -math.inf)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def split_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    '''(B, S, D) -> (B, H, S, D // H), a view.'''
    B, S, D = x.shape
    return x.view(B, S, H, D // H).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    '''(B, H, S, d_k) -> (B, S, H * d_k).'''
    B, H, S, d_k = x.shape
    return x.transpose(1, 2).reshape(B, S, H * d_k)


class MultiheadAttention(nn.Module):
    '''Hetero-dim MHA; ``d_model`` defaults to ``d_model_Q``.'''

    def __init__(self, d_model_Q: int, d_model_K: int, d_model_V: int,
                 d_model: int | None, H: int, dout_p: float = 0.0,
                 device=None):
        super().__init__()
        d_model = d_model or d_model_Q
        self.H = H
        self.q2d = ColumnParallelLinear(d_model_Q, d_model, device=device)
        self.k2d = ColumnParallelLinear(d_model_K, d_model, device=device)
        self.v2d = ColumnParallelLinear(d_model_V, d_model, device=device)
        self.d2q = RowParallelLinear(d_model, d_model_Q, device=device)
        self.dropout = Dropout(dout_p)

    @property
    def heads(self) -> int:
        '''The heads this module runs: H, or H/mp when its projections hold
        this rank's mp block.'''
        return self.H // tensor.shards(self.q2d)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor | None,
                attention_impl: str = 'torch',
                seq: tuple | None = None) -> torch.Tensor:
        '''q (B, Sq, Dq), k (B, Sk, Dk), v (B, Sk, Dv); mask (B, 1, Sk)
        padding, (B, Sq, Sk) causal+padding, or None. Returns (B, Sq, Dq).
        ``seq`` = (i, n): q is the i-th of n sequence blocks (the dropout
        draws that block of the whole sequence's mask).'''
        H = self.heads
        qp = split_heads(self.q2d(q), H)
        kp = split_heads(self.k2d(k), H)
        vp = split_heads(self.v2d(v), H)
        if mask is not None:
            mask = mask[:, None]           # one mask for every head
        if attention_impl == 'kernel':
            out = flash_attention(qp.contiguous(), kp.contiguous(),
                                  vp.contiguous(), mask)
        elif attention_impl == 'torch':
            out = scaled_dot_attention(qp, kp, vp, mask)
        else:
            raise ValueError(f'attention_impl {attention_impl!r} is not one '
                             f'of {ATTENTION_IMPLS}')
        out = self.dropout(out, (tensor.block(self.q2d, 1),
                                 stream_block(2, seq)))
        return self.d2q(merge_heads(out))


# ---------------------------------------------------------------------------
# KV-cache variants for autoregressive decoding
# ---------------------------------------------------------------------------

def precompute_kv(mha: MultiheadAttention, memory: torch.Tensor,
                  quantize: bool = False, mask: torch.Tensor | None = None):
    '''Project encoder memory into per-head (k, v), each (B, H, Sk, d_k),
    once per segment; every decode step reuses them.

    With ``quantize`` the K/V are stored int8 with one symmetric scale per
    (batch, head, channel): ``{'k': (k8, k_scale), 'v': (v8, v_scale)}``,
    scales (B, H, 1, d_k) fp32. ``mask`` ((B, 1, Sk) key padding, True =
    attend) matters only then: padded keys are zeroed first, so they do not
    inflate the per-channel amax.'''
    k = split_heads(mha.k2d(memory), mha.heads)
    v = split_heads(mha.v2d(memory), mha.heads)
    if not quantize:
        return k, v
    if mask is not None:
        keep = mask[:, None].transpose(-1, -2)            # (B, 1, Sk, 1)
        k = torch.where(keep, k, torch.zeros((), dtype=k.dtype,
                                             device=k.device))
        v = torch.where(keep, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))
    return {'k': _quantize_per_channel(k), 'v': _quantize_per_channel(v)}


def _quantize_per_channel(x: torch.Tensor):
    '''Symmetric int8 quantization of (B, H, S, d_k) along S: one scale per
    (batch, head, channel), so every stored value is exactly q * scale.'''
    x32 = x.float()
    amax = x32.abs().amax(dim=2, keepdim=True)             # (B, H, 1, d_k)
    scale = torch.clamp_min(per_127(amax), 1e-12)
    return torch.round(x32 / scale).to(torch.int8), scale


def _cross_attention_q8(qp: torch.Tensor, kv: dict,
                        mask: torch.Tensor | None) -> torch.Tensor:
    '''Attention of a few queries over int8 K/V with the per-channel scales
    folded into the two products:

      logits = (q * k_scale) @ K8^T     fp32
      out    = (weights @ V8) * v_scale

    The scaled query and the weights round to the query's dtype first, as
    in JAX; the products then run in fp32 over exact upcasts (an int8 or a
    bf16 value is exact in fp32), the counterpart of JAX's bf16 x int8
    einsum accumulated in fp32.'''
    (k8, k_s), (v8, v_s) = kv['k'], kv['v']
    act = qp.dtype
    qf = (qp.float() * k_s).to(act)
    logits = torch.matmul(qf.float(), k8.float().transpose(-1, -2))
    logits = logits / math.sqrt(qp.shape[-1])
    if mask is not None:
        logits = logits.masked_fill(~mask, -math.inf)
    weights = torch.softmax(logits, dim=-1).to(act)
    out = torch.matmul(weights.float(), v8.float())
    return (out * v_s).to(act)


def cross_attention_step(mha: MultiheadAttention, q: torch.Tensor, kv,
                         mask: torch.Tensor | None) -> torch.Tensor:
    '''Attention of the current token q (B, 1, Dq) over precomputed memory:
    ``kv`` is (k, v), each (Bm, H, Sk, d_k), or the int8 dict of
    ``precompute_kv(quantize=True)``; mask (Bm, 1, Sk) or None. Plain math.

    Beam sharing: when q has B = Bm * K rows (K beams of each memory row,
    beam-major within a row), the K beams become K query positions over the
    Bm-row memory, so the K/V are read once per step and never tiled.'''
    k0 = kv['k'][0] if isinstance(kv, dict) else kv[0]
    Bm = k0.shape[0]
    qp = split_heads(mha.q2d(q), mha.heads)             # (B, H, Sq, d_k)
    B, H, Sq, d_k = qp.shape
    folded = B != Bm
    if folded:
        if Sq != 1 or B % Bm:
            raise ValueError(f'cross_attention_step: a query of {B} rows x '
                             f'{Sq} positions does not fold onto a memory '
                             f'of {Bm} rows (beams need B = Bm * K, Sq = 1)')
        K = B // Bm
        # (Bm*K, H, 1, d_k) -> (Bm, H, K, d_k): beams become query positions
        qp = qp.reshape(Bm, K, H, d_k).transpose(1, 2)
    if mask is not None:
        mask = mask[:, None]
    if isinstance(kv, dict):
        out = _cross_attention_q8(qp, kv, mask)
    else:
        out = scaled_dot_attention(qp, kv[0], kv[1], mask)
    if folded:
        out = out.transpose(1, 2).reshape(B, H, 1, d_k)
    return mha.d2q(merge_heads(out))


def self_attention_step(mha: MultiheadAttention, q: torch.Tensor,
                        cache_k: torch.Tensor, cache_v: torch.Tensor,
                        step: int):
    '''One causal self-attention step with a KV cache.

    q (B, 1, Dq) is the newest token; cache_k/cache_v (B, H, T_max, d_k)
    hold the projections of tokens [0, step). The new token's k/v are
    written at ``step`` IN PLACE -- unlike the JAX version, which returns
    updated copies -- so the caches passed in are modified (beam search
    therefore reorders them into fresh tensors). Attention runs over
    positions <= step. Returns (out (B, 1, Dq), cache_k, cache_v).'''
    H = mha.heads
    qp = split_heads(mha.q2d(q), H)                    # (B, H, 1, d_k)
    cache_k[:, :, step] = split_heads(mha.k2d(q), H)[:, :, 0]
    cache_v[:, :, step] = split_heads(mha.v2d(q), H)[:, :, 0]
    T_max = cache_k.shape[2]
    valid = torch.arange(T_max, device=q.device) <= step   # (T_max,)
    out = scaled_dot_attention(qp, cache_k, cache_v, valid)
    return mha.d2q(merge_heads(out)), cache_k, cache_v
