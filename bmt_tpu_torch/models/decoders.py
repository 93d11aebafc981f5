'''Uni-modal and bi-modal transformer decoders (counterpart of
``bmt_tpu.models.decoders``).

The uni-modal ``Decoder`` layer runs causal self-attention over the caption,
attention to the one encoder memory, then a feed-forward, pre-norm residual;
as in its encoder, only the residual dropouts are live and a MoE
feed-forward runs its lossless form (``decoders.py:51-79``).

Each bi-modal layer runs causal self-attention over the caption, attends
the audio memory (Av) and the video memory (Va) separately, fuses the two
streams with a bridge (2 Dc -> Dc), then a feed-forward, all pre-norm
residual. Both the
teacher-forced forward and the KV-cached one-token step are here; the step
equals the forward's last position, because LayerNorm is per token, the
causal mask limits self-attention to the cached prefix, and the cross,
bridge and FFN blocks are position-wise. A MoE feed-forward
(``moe_experts`` > 1) keeps that: the step runs its lossless form, which is
per token too.
'''
from __future__ import annotations

import torch
from torch import nn

from bmt_tpu_torch.ops.attention import (MultiheadAttention,
                                         cross_attention_step, precompute_kv,
                                         self_attention_step)
from bmt_tpu_torch.ops.layers import Bridge, Dropout, LayerNorm, residual
from bmt_tpu_torch.ops.moe import ffn_apply, ffn_or_moe


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, d_ff: int, H: int, dout_p: float = 0.0,
                 device=None, moe_experts: int = 0, moe_cf: float = 1.25):
        super().__init__()
        self.self_att = MultiheadAttention(d_model, d_model, d_model,
                                           d_model, H, 0.0, device)
        self.enc_att = MultiheadAttention(d_model, d_model, d_model,
                                          d_model, H, 0.0, device)
        self.ff = ffn_or_moe(d_model, d_ff, moe_experts, 0.0, moe_cf, device)
        self.res = nn.ModuleList(LayerNorm(d_model, device=device)
                                 for _ in range(3))
        self.dropout = Dropout(dout_p)

    def forward(self, x, memory, src_mask, trg_mask, attention_impl='torch',
                aux_out=None):
        drop = self.dropout
        x = residual(self.res[0], x, lambda y: self.self_att(
            y, y, y, trg_mask, attention_impl), drop)
        x = residual(self.res[1], x, lambda y: self.enc_att(
            y, memory, memory, src_mask, attention_impl), drop)
        return residual(self.res[2], x,
                        lambda y: ffn_apply(self.ff, y, aux_out, True), drop)

    def step(self, s: dict, c_t, src_mask, step: int):
        '''One KV-cached step; ``s`` is this layer's decode state, whose
        self-attention caches are written in place.'''
        att, _, _ = self_attention_step(self.self_att, self.res[0](c_t),
                                        s['cache_k'], s['cache_v'], step)
        c_t = c_t + att
        c_t = c_t + cross_attention_step(self.enc_att, self.res[1](c_t),
                                         s['kv_mem'], src_mask)
        return c_t + ffn_apply(self.ff, self.res[2](c_t), deterministic=True)


def _decode_caches(mha: MultiheadAttention, like: torch.Tensor, B: int,
                   max_len: int) -> dict:
    '''Empty self-attention caches (B, H, max_len, d_k) in ``like``'s
    dtype, H the heads ``mha`` runs on this rank.'''
    shape = (B, mha.heads, max_len, mha.k2d.out_features // mha.H)
    return {'cache_k': like.new_zeros(shape), 'cache_v': like.new_zeros(shape)}


class Decoder(nn.Module):
    '''Uni-modal decoder: N ``DecoderLayer``s over one encoder memory.'''

    def __init__(self, d_model: int, d_ff: int, N: int, H: int,
                 dout_p: float = 0.0, device=None, moe_experts: int = 0,
                 moe_cf: float = 1.25):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, d_ff, H, dout_p, device, moe_experts,
                         moe_cf)
            for _ in range(N))

    def forward(self, x, memory, src_mask, trg_mask,
                attention_impl: str = 'torch',
                aux_out: list | None = None) -> torch.Tensor:
        '''Teacher-forced forward (JAX ``decoder_forward``): x (B, St, D)
        embedded captions, memory (B, S, D), src_mask (B, 1, S), trg_mask
        (B, St, St) causal+padding. Returns (B, St, D).'''
        for layer in self.layers:
            x = layer(x, memory, src_mask, trg_mask, attention_impl, aux_out)
        return x

    def init_decode_state(self, memory: torch.Tensor, max_len: int,
                          kv_int8: bool = False,
                          cache_batch: int | None = None,
                          src_mask: torch.Tensor | None = None) -> list:
        '''JAX ``init_unimodal_decode_state``: per layer, the memory's
        cross-attention (k, v) computed once (int8 with per-channel scales
        when ``kv_int8``, the padded keys of ``src_mask`` zeroed first), and
        empty self-attention caches of ``cache_batch`` rows (default:
        memory's).'''
        B = cache_batch if cache_batch is not None else memory.shape[0]
        return [{'kv_mem': precompute_kv(layer.enc_att, memory, kv_int8,
                                         src_mask),
                 **_decode_caches(layer.self_att, memory, B, max_len)}
                for layer in self.layers]

    def step(self, state: list, c_t: torch.Tensor, src_mask,
             step: int) -> torch.Tensor:
        '''Advance one token (JAX ``unimodal_decoder_step``); writes the
        self-attention caches in ``state`` in place.'''
        for layer, s in zip(self.layers, state):
            c_t = layer.step(s, c_t, src_mask, step)
        return c_t


class BiModalDecoderLayer(nn.Module):
    def __init__(self, d_model_A: int, d_model_V: int, d_model_C: int,
                 d_model: int, d_ff_C: int, H: int, dout_p: float = 0.0,
                 device=None, moe_experts: int = 0, moe_cf: float = 1.25):
        super().__init__()
        self.self_att = MultiheadAttention(d_model_C, d_model_C, d_model_C,
                                           d_model, H, dout_p, device)
        self.enc_att_A = MultiheadAttention(d_model_C, d_model_A, d_model_A,
                                            d_model, H, dout_p, device)
        self.enc_att_V = MultiheadAttention(d_model_C, d_model_V, d_model_V,
                                            d_model, H, dout_p, device)
        self.bridge = Bridge(2 * d_model_C, d_model_C, dout_p, device)
        self.ff = ffn_or_moe(d_model_C, d_ff_C, moe_experts, dout_p, moe_cf,
                             device)
        self.res_self = LayerNorm(d_model_C, device=device)
        self.res_enc_A = LayerNorm(d_model_C, device=device)
        self.res_enc_V = LayerNorm(d_model_C, device=device)
        self.res_ff = LayerNorm(d_model_C, device=device)
        self.dropout = Dropout(dout_p)

    def forward(self, C, Av, Va, A_mask, V_mask, C_mask,
                attention_impl='torch', aux_out=None):
        drop = self.dropout
        C = residual(self.res_self, C, lambda y: self.self_att(
            y, y, y, C_mask, attention_impl), drop)
        Ca = residual(self.res_enc_A, C, lambda y: self.enc_att_A(
            y, Av, Av, A_mask, attention_impl), drop)
        Cv = residual(self.res_enc_V, C, lambda y: self.enc_att_V(
            y, Va, Va, V_mask, attention_impl), drop)
        C = self.bridge(torch.cat([Ca, Cv], dim=-1))
        return residual(self.res_ff, C,
                        lambda y: ffn_apply(self.ff, y, aux_out), drop)

    def step(self, s: dict, c_t, A_mask, V_mask, step: int):
        '''One KV-cached step; ``s`` is this layer's decode state, whose
        self-attention caches are written in place.'''
        att, _, _ = self_attention_step(self.self_att, self.res_self(c_t),
                                        s['cache_k'], s['cache_v'], step)
        c_t = c_t + att
        Ca = c_t + cross_attention_step(self.enc_att_A, self.res_enc_A(c_t),
                                        s['kvA'], A_mask)
        Cv = c_t + cross_attention_step(self.enc_att_V, self.res_enc_V(c_t),
                                        s['kvV'], V_mask)
        c_t = self.bridge(torch.cat([Ca, Cv], dim=-1))
        return c_t + ffn_apply(self.ff, self.res_ff(c_t), deterministic=True)


class BiModalDecoder(nn.Module):
    def __init__(self, d_model_A: int, d_model_V: int, d_model_C: int,
                 d_model: int, d_ff_C: int, N: int, H: int,
                 dout_p: float = 0.0, device=None, moe_experts: int = 0,
                 moe_cf: float = 1.25):
        super().__init__()
        self.layers = nn.ModuleList(
            BiModalDecoderLayer(d_model_A, d_model_V, d_model_C, d_model,
                                d_ff_C, H, dout_p, device, moe_experts,
                                moe_cf)
            for _ in range(N))

    def forward(self, C, Av, Va, A_mask, V_mask, C_mask,
                attention_impl: str = 'torch',
                aux_out: list | None = None) -> torch.Tensor:
        '''Teacher-forced forward (JAX ``bimodal_decoder_forward``):
        C (B, Sc, Dc) embedded captions, C_mask (B, Sc, Sc)
        causal+padding. Returns (B, Sc, Dc); ``aux_out`` gains each layer's
        MoE load-balance loss.'''
        for layer in self.layers:
            C = layer(C, Av, Va, A_mask, V_mask, C_mask, attention_impl,
                      aux_out)
        return C

    def init_decode_state(self, Av: torch.Tensor, Va: torch.Tensor,
                          max_len: int, kv_int8: bool = False,
                          cache_batch: int | None = None,
                          A_mask: torch.Tensor | None = None,
                          V_mask: torch.Tensor | None = None) -> list:
        '''JAX ``init_decode_state``: per layer, the cross-attention (k, v)
        of both memories, computed once (int8 with per-channel scales when
        ``kv_int8``; ``A_mask``/``V_mask`` then zero the padded keys first),
        and empty self-attention caches (cache_batch, H, max_len, d_k) in
        Av's dtype. ``cache_batch`` (default: Av's rows) sizes the caches
        apart from the memories: beam search gives each of the B x K beams
        its own cache, while the cross K/V stay at B rows.'''
        B = cache_batch if cache_batch is not None else Av.shape[0]
        return [{'kvA': precompute_kv(layer.enc_att_A, Av, kv_int8, A_mask),
                 'kvV': precompute_kv(layer.enc_att_V, Va, kv_int8, V_mask),
                 **_decode_caches(layer.self_att, Av, B, max_len)}
                for layer in self.layers]

    def step(self, state: list, c_t: torch.Tensor, A_mask, V_mask,
             step: int) -> torch.Tensor:
        '''Advance one token (JAX ``bimodal_decoder_step``): c_t
        (B, 1, Dc) embedded at position ``step``. Writes the
        self-attention caches in ``state`` in place and returns
        (B, 1, Dc).'''
        for layer, s in zip(self.layers, state):
            c_t = layer.step(s, c_t, A_mask, V_mask, step)
        return c_t
