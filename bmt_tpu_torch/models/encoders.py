'''Uni-modal and bi-modal transformer encoders (counterpart of
``bmt_tpu.models.encoders``).

The uni-modal ``Encoder`` (the audio-only and video-only models) stacks
self-attention and a feed-forward, pre-norm residuals. As in the reference,
its attention and feed-forward carry no dropout of their own: only the two
residual dropouts are live (``encoders.py:53-69``). A MoE feed-forward there
runs its lossless form in training too, as the JAX layer calls it with
``deterministic`` at its default.

Each bi-modal layer runs self-attention per modality, then cross-attention
in both directions (M1 queries M2 and M2 queries M1), then a feed-forward
per modality, all with pre-norm residuals. M1 is audio and M2 video; the encoder
returns (Av, Va): audio attended by video and video attended by audio.
With ``remat`` each layer runs under ``checkpoint`` while autograd records
what reaches the encoder:
its activations are recomputed in the backward instead of kept (the JAX
package's ``jax.checkpoint`` per layer, ``encoders.py:190-191``).

The feed-forwards are dense, or Switch MoE with ``moe_experts`` > 1
(``ops.moe``). Given an ``aux_out`` list, each layer appends the sum of its
two MoE load-balance losses, returned out of the (possibly recomputed)
layer rather than appended inside it, as the JAX encoder does.

Under sequence parallelism (``parallel.seq``, the JAX package's
``shard_seq`` sites ``encoders.py:80, 198``) a modality may arrive as this
rank's block of its sequence, shorter than its mask: its queries stay the
block, and its keys and values are the whole sequence, gathered where an
attention reads them (``seq.keys``).
'''
from __future__ import annotations

import torch
from torch import nn

from bmt_tpu_torch.ops.attention import MultiheadAttention
from bmt_tpu_torch.ops.layers import (Dropout, LayerNorm, checkpoint,
                                      key_stream, next_key, residual)
from bmt_tpu_torch.ops.moe import ffn_apply, ffn_or_moe
from bmt_tpu_torch.parallel import seq


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int, H: int, dout_p: float = 0.0,
                 device=None, moe_experts: int = 0, moe_cf: float = 1.25):
        super().__init__()
        self.self_att = MultiheadAttention(d_model, d_model, d_model,
                                           d_model, H, 0.0, device)
        self.ff = ffn_or_moe(d_model, d_ff, moe_experts, 0.0, moe_cf, device)
        self.res = nn.ModuleList(LayerNorm(d_model, device=device)
                                 for _ in range(2))
        self.dropout = Dropout(dout_p)

    def forward(self, x, src_mask, attention_impl='torch', aux_out=None):
        def self_att(y):
            kv = seq.keys(y, src_mask)
            return self.self_att(y, kv, kv, src_mask, attention_impl)
        part = seq.part_of(x, src_mask)
        x = residual(self.res[0], x, self_att, self.dropout, part)
        return residual(self.res[1], x,
                        lambda y: ffn_apply(self.ff, y, aux_out, True),
                        self.dropout, part)


class Encoder(nn.Module):
    '''Uni-modal encoder: N ``EncoderLayer``s over one modality.'''

    def __init__(self, d_model: int, d_ff: int, N: int, H: int,
                 dout_p: float = 0.0, device=None, moe_experts: int = 0,
                 moe_cf: float = 1.25):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, d_ff, H, dout_p, device, moe_experts,
                         moe_cf)
            for _ in range(N))

    def forward(self, x: torch.Tensor, src_mask,
                attention_impl: str = 'torch',
                aux_out: list | None = None) -> torch.Tensor:
        '''x (B, S, d_model), src_mask (B, 1, S) -> (B, S, d_model);
        ``aux_out`` gains each MoE FFN's load-balance loss.'''
        for layer in self.layers:
            x = layer(x, src_mask, attention_impl, aux_out)
        return x


class BiModalEncoderLayer(nn.Module):
    def __init__(self, d_model_M1: int, d_model_M2: int, d_model: int,
                 d_ff_M1: int, d_ff_M2: int, H: int, dout_p: float = 0.0,
                 device=None, moe_experts: int = 0, moe_cf: float = 1.25):
        super().__init__()
        self.self_att_M1 = MultiheadAttention(d_model_M1, d_model_M1,
                                              d_model_M1, d_model, H, dout_p,
                                              device)
        self.self_att_M2 = MultiheadAttention(d_model_M2, d_model_M2,
                                              d_model_M2, d_model, H, dout_p,
                                              device)
        self.cross_att_M1 = MultiheadAttention(d_model_M1, d_model_M2,
                                               d_model_M2, d_model, H, dout_p,
                                               device)
        self.cross_att_M2 = MultiheadAttention(d_model_M2, d_model_M1,
                                               d_model_M1, d_model, H, dout_p,
                                               device)
        self.ff_M1 = ffn_or_moe(d_model_M1, d_ff_M1, moe_experts, dout_p,
                                moe_cf, device)
        self.ff_M2 = ffn_or_moe(d_model_M2, d_ff_M2, moe_experts, dout_p,
                                moe_cf, device)
        self.res_M1 = nn.ModuleList(LayerNorm(d_model_M1, device=device)
                                    for _ in range(3))
        self.res_M2 = nn.ModuleList(LayerNorm(d_model_M2, device=device)
                                    for _ in range(3))
        self.dropout = Dropout(dout_p)

    def forward(self, M1, M2, M1_mask, M2_mask, attention_impl='torch',
                with_aux: bool = False, key=None):
        '''(M1m2, M2m1), and with ``with_aux`` the sum of the layer's MoE
        load-balance losses third (0 for dense FFNs). ``key``: the layer's
        dropout sites draw from a stream of it (JAX's per-layer
        ``_rng_stream(key)``); None keeps the active stream or
        generator.'''
        with key_stream(key):
            return self._forward(M1, M2, M1_mask, M2_mask, attention_impl,
                                 with_aux)

    def _forward(self, M1, M2, M1_mask, M2_mask, attention_impl, with_aux):
        drop = self.dropout
        aux = [] if with_aux else None
        # (i, n) when a modality is this rank's block of its sequence
        p1, p2 = seq.part_of(M1, M1_mask), seq.part_of(M2, M2_mask)

        def att(mha, mask, part, kv=None):
            def run(y):
                k = seq.keys(y if kv is None else kv, mask)
                return mha(y, k, k, mask, attention_impl, part)
            return run
        # 1. self-attention
        M1 = residual(self.res_M1[0], M1,
                      att(self.self_att_M1, M1_mask, p1), drop, p1)
        M2 = residual(self.res_M2[0], M2,
                      att(self.self_att_M2, M2_mask, p2), drop, p2)
        # 2. cross-attention: each modality queries the other
        M1m2 = residual(self.res_M1[1], M1,
                        att(self.cross_att_M1, M2_mask, p1, M2), drop, p1)
        M2m1 = residual(self.res_M2[1], M2,
                        att(self.cross_att_M2, M1_mask, p2, M1), drop, p2)
        # 3. feed-forward
        M1m2 = residual(self.res_M1[2], M1m2,
                        lambda y: ffn_apply(self.ff_M1, y, aux, seq=p1),
                        drop, p1)
        M2m1 = residual(self.res_M2[2], M2m1,
                        lambda y: ffn_apply(self.ff_M2, y, aux, seq=p2),
                        drop, p2)
        if not with_aux:
            return M1m2, M2m1
        return M1m2, M2m1, (sum(aux) if aux
                            else M1m2.new_zeros((), dtype=torch.float32))


class BiModalEncoder(nn.Module):
    def __init__(self, d_model_A: int, d_model_V: int, d_model: int,
                 d_ff_A: int, d_ff_V: int, N: int, H: int,
                 dout_p: float = 0.0, device=None, remat: bool = False,
                 moe_experts: int = 0, moe_cf: float = 1.25):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            BiModalEncoderLayer(d_model_A, d_model_V, d_model, d_ff_A, d_ff_V,
                                H, dout_p, device, moe_experts, moe_cf)
            for _ in range(N))

    def forward(self, A: torch.Tensor, V: torch.Tensor, A_mask, V_mask,
                attention_impl: str = 'torch', aux_out: list | None = None):
        '''A (B, Sa, d_model_A), V (B, Sv, d_model_V); masks (B, 1, S).
        Returns (Av, Va); ``aux_out`` gains one load-balance loss a layer.
        Remat applies only when the backward will reach the encoder: a
        frozen encoder fed features that need no gradient runs its layers
        plainly, recording no graph.'''
        remat = (self.remat and torch.is_grad_enabled()
                 and (A.requires_grad or V.requires_grad
                      or any(p.requires_grad for p in self.parameters())))
        args = (A_mask, V_mask, attention_impl, aux_out is not None)
        for layer in self.layers:
            # one key a layer, its sites a stream of it (JAX :181), so a
            # recompute draws the same masks
            key = next_key()
            if remat:
                out = checkpoint(layer, A, V, *args, key)
            else:
                out = layer(A, V, *args, key)
            A, V = out[:2]
            if aux_out is not None:
                aux_out.append(out[2])
        return A, V
