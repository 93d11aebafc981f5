'''The captioning transformers (counterpart of
``bmt_tpu.models.captioning``).

``BiModalTransformer`` holds the JAX parameter tree's structure as modules:
``emb_C``, ``encoder``, ``decoder``, ``generator`` and, with a linear feature
embedder, ``emb_A``/``emb_V``. ``UniModalTransformer`` (``--modality audio``
or ``video``, the reference's ablations) holds ``trg_emb``, ``encoder``,
``decoder``, ``generator`` and, with a linear feature embedder, ``src_emb``;
its captions live in the modality's width, not ``d_model_C``. The generator
head (Linear -> log_softmax) is folded in, as in the JAX package; under
tensor parallelism it is column-parallel over the vocabulary, its blocks
gathered before the log-softmax (``parallel.tensor``).
'''
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from bmt_tpu_torch.models.decoders import BiModalDecoder, Decoder
from bmt_tpu_torch.models.encoders import BiModalEncoder, Encoder
from bmt_tpu_torch.ops.layers import (Dropout, FeatureEmbedder,
                                      VocabularyEmbedder, positional_encode,
                                      positional_encoding_table)
from bmt_tpu_torch.params import init_params
from bmt_tpu_torch.parallel.tensor import ColumnParallelLinear

POS_ENC_LEN = 3660  # rows of the positional table, as in the reference


@dataclasses.dataclass(frozen=True)
class CapModelDims:
    '''Static architecture config; same fields and defaults as
    ``bmt_tpu.models.captioning.CapModelDims``. ``moe_experts`` > 1 makes
    every FFN (the encoder's two a layer, the decoder's one) a Switch MoE of
    that many experts with capacity factor ``moe_cf`` (``ops.moe``).
    ``remat`` recomputes each bi-modal encoder layer in the backward
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).'''
    voc_size: int
    d_model_A: int = 128
    d_model_V: int = 1024
    d_model_C: int = 300
    d_model: int = 1024
    H: int = 4
    N: int = 2
    d_ff_A: int = 512
    d_ff_V: int = 4096
    d_ff_C: int = 1200
    dout_p: float = 0.1
    use_linear_embedder: bool = False
    d_vid: int = 1024
    d_aud: int = 128
    modality: str = 'audio_video'
    remat: bool = False
    moe_experts: int = 0
    moe_cf: float = 1.25

    @classmethod
    def from_config(cls, cfg, voc_size: int) -> 'CapModelDims':
        '''The dims from a ``Config`` (the trainer's attribute names). The
        d_ff_* exist only for the modalities the config was built with
        (reference: config_constructor.py:86-90).'''
        d_model_A = getattr(cfg, 'd_model_audio', 128)
        d_model_V = getattr(cfg, 'd_model_video', 1024)
        return cls(
            voc_size=voc_size,
            d_model_A=d_model_A, d_model_V=d_model_V,
            d_model_C=cfg.d_model_caps, d_model=cfg.d_model,
            H=cfg.H, N=cfg.N,
            d_ff_A=getattr(cfg, 'd_ff_audio', 4 * d_model_A),
            d_ff_V=getattr(cfg, 'd_ff_video', 4 * d_model_V),
            d_ff_C=cfg.d_ff_caps,
            dout_p=cfg.dout_p, use_linear_embedder=cfg.use_linear_embedder,
            d_vid=cfg.d_vid, d_aud=cfg.d_aud, modality=cfg.modality,
            remat=getattr(cfg, 'remat', False),
            moe_experts=getattr(cfg, 'moe_experts', 0) or 0,
            moe_cf=getattr(cfg, 'moe_capacity_factor', 1.25),
        )


def build_device(device, what: str) -> torch.device:
    '''``device`` as a torch.device; a CUDA device without a card raises
    (nothing is built on the CPU unless asked).'''
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'{what}: device {device} asked for, but no CUDA device is '
            f'available; pass device="cpu" to build on the CPU')
    return device


class BiModalTransformer(nn.Module):
    '''Bi-modal captioner.

    ``device``: where the model is built, the card unless the caller names
    another (``device='cpu'``); without a CUDA device the default raises
    rather than building on the CPU.
    ``generator``: a ``torch.Generator`` on ``device``; when given, every
    weight is drawn from it with the JAX package's recipe (xavier-uniform
    weights, PyTorch's fan-in uniform biases, ones/zeros LayerNorms).
    ``table_dim``: width of a pretrained caption-embedding table (GloVe)
    when it differs from ``d_model_C``; the embedder then carries an
    adapter.'''

    def __init__(self, dims: CapModelDims, *, device='cuda',
                 generator: torch.Generator | None = None,
                 table_dim: int | None = None):
        super().__init__()
        device = build_device(device, 'BiModalTransformer')
        if dims.modality != 'audio_video':
            raise ValueError(f'modality {dims.modality!r}: the bi-modal '
                             f'captioner is audio_video; UniModalTransformer '
                             f'builds the audio and video ones')
        self.dims = dims
        self.emb_C = VocabularyEmbedder(dims.voc_size, dims.d_model_C,
                                        table_dim, device)
        self.encoder = BiModalEncoder(dims.d_model_A, dims.d_model_V,
                                      dims.d_model, dims.d_ff_A, dims.d_ff_V,
                                      dims.N, dims.H, dims.dout_p, device,
                                      remat=dims.remat,
                                      moe_experts=dims.moe_experts,
                                      moe_cf=dims.moe_cf)
        self.decoder = BiModalDecoder(dims.d_model_A, dims.d_model_V,
                                      dims.d_model_C, dims.d_model,
                                      dims.d_ff_C, dims.N, dims.H,
                                      dims.dout_p, device, dims.moe_experts,
                                      dims.moe_cf)
        self.generator = ColumnParallelLinear(dims.d_model_C, dims.voc_size,
                                              device=device, gather=True)
        if dims.use_linear_embedder:
            self.emb_A = FeatureEmbedder(dims.d_aud, dims.d_model_A, device)
            self.emb_V = FeatureEmbedder(dims.d_vid, dims.d_model_V, device)
        self.dropout = Dropout(dims.dout_p)
        for name, width in (('pe_A', dims.d_model_A), ('pe_V', dims.d_model_V),
                            ('pe_C', dims.d_model_C)):
            table = torch.tensor(positional_encoding_table(POS_ENC_LEN, width),
                                 device=device)
            self.register_buffer(name, table, persistent=False)
        if generator is not None:
            init_params(self, generator)

    def _embed_av(self, src: dict):
        '''V = rgb + flow; optional feature embedders; positional encoding.'''
        A, V = src['audio'], src['rgb'] + src['flow']
        if self.dims.use_linear_embedder:
            A, V = self.emb_A(A), self.emb_V(V)
        return (self.dropout(positional_encode(self.pe_A, A)),
                self.dropout(positional_encode(self.pe_V, V)))

    def encode(self, src: dict, masks: dict, attention_impl: str = 'torch',
               aux_out: list | None = None):
        '''Embeddings and the bi-modal encoder; returns (Av, Va).
        src: {'rgb', 'flow': (B, Sv, d_vid), 'audio': (B, Sa, d_aud)}.'''
        A, V = self._embed_av(src)
        return self.encoder(A, V, masks['A_mask'], masks['V_mask'],
                            attention_impl, aux_out)

    def forward(self, src: dict, trg: torch.Tensor, masks: dict,
                attention_impl: str = 'torch', return_logits: bool = False,
                aux_out: list | None = None) -> torch.Tensor:
        '''Teacher-forced forward -> (B, Sc, voc_size) fp32 log-probs, or
        the logits in the compute dtype with ``return_logits``. ``aux_out``
        gains the MoE load-balance losses: one per encoder layer (the sum
        of its two FFNs'), then one per decoder layer.'''
        # the caption embedding's key comes third, after the features'
        # (JAX :164-166), though it is drawn after the encoder
        A, V = self._embed_av(src)
        key_C = self.dropout.take()
        Av, Va = self.encoder(A, V, masks['A_mask'], masks['V_mask'],
                              attention_impl, aux_out)
        C = self.dropout(positional_encode(self.pe_C, self.emb_C(trg)),
                         key=key_C)
        C = self.decoder(C, Av, Va, masks['A_mask'], masks['V_mask'],
                         masks['C_mask'], attention_impl, aux_out)
        logits = self.generator(C)
        if return_logits:
            return logits
        return torch.log_softmax(logits.float(), dim=-1)

    def decode_init(self, Av: torch.Tensor, Va: torch.Tensor,
                    max_len: int, kv_int8: bool = False,
                    cache_batch: int | None = None, A_mask=None,
                    V_mask=None) -> list:
        '''The KV-cache decode state for memories (Av, Va)
        (``BiModalDecoder.init_decode_state``).'''
        return self.decoder.init_decode_state(Av, Va, max_len, kv_int8,
                                              cache_batch, A_mask, V_mask)

    def decode_step(self, state: list, token: torch.Tensor, step: int,
                    A_mask, V_mask):
        '''Embed ``token`` (B, 1) at position ``step`` and advance the
        decoder one token (plain attention math; the caches in ``state`` are
        written in place). Returns ((B, voc_size) fp32 log-probs, state).'''
        c_t = positional_encode(self.pe_C, self.emb_C(token), offset=step)
        c_t = self.decoder.step(state, c_t, A_mask, V_mask, step)
        logits = self.generator(c_t[:, 0, :])
        return torch.log_softmax(logits.float(), dim=-1), state


class UniModalTransformer(nn.Module):
    '''Uni-modal captioner (``dims.modality`` 'audio' or 'video'); the
    arguments as ``BiModalTransformer``'s. The encoder, the decoder, the
    caption embedding and the positional table all use the modality's width
    (``d_model_A`` or ``d_model_V``), and its feed-forward width.'''

    def __init__(self, dims: CapModelDims, *, device='cuda',
                 generator: torch.Generator | None = None,
                 table_dim: int | None = None):
        super().__init__()
        device = build_device(device, 'UniModalTransformer')
        if dims.modality not in ('audio', 'video'):
            raise ValueError(f'modality {dims.modality!r}: the uni-modal '
                             f'captioner is audio or video')
        self.dims = dims
        video = dims.modality == 'video'
        d_model = dims.d_model_V if video else dims.d_model_A
        d_ff = dims.d_ff_V if video else dims.d_ff_A
        self.trg_emb = VocabularyEmbedder(dims.voc_size, d_model, table_dim,
                                          device)
        self.encoder = Encoder(d_model, d_ff, dims.N, dims.H, dims.dout_p,
                               device, dims.moe_experts, dims.moe_cf)
        self.decoder = Decoder(d_model, d_ff, dims.N, dims.H, dims.dout_p,
                               device, dims.moe_experts, dims.moe_cf)
        self.generator = ColumnParallelLinear(d_model, dims.voc_size,
                                              device=device, gather=True)
        if dims.use_linear_embedder:
            self.src_emb = FeatureEmbedder(dims.d_vid if video else dims.d_aud,
                                           d_model, device)
        self.dropout = Dropout(dims.dout_p)
        self.register_buffer('pe', torch.tensor(
            positional_encoding_table(POS_ENC_LEN, d_model), device=device),
            persistent=False)
        if generator is not None:
            init_params(self, generator)

    def src_mask(self, masks: dict):
        return masks['V_mask' if self.dims.modality == 'video' else 'A_mask']

    def _source(self, src: dict) -> torch.Tensor:
        '''The modality's features (video: rgb + flow), embedded when the
        model has a feature embedder.'''
        x = (src['rgb'] + src['flow'] if self.dims.modality == 'video'
             else src['audio'])
        return self.src_emb(x) if self.dims.use_linear_embedder else x

    def encode(self, src: dict, src_mask, attention_impl: str = 'torch',
               aux_out: list | None = None) -> torch.Tensor:
        '''Embeddings and the encoder: the memory (B, S, d_model).'''
        x = self.dropout(positional_encode(self.pe, self._source(src)))
        return self.encoder(x, src_mask, attention_impl, aux_out)

    def forward(self, src: dict, trg: torch.Tensor, masks: dict,
                attention_impl: str = 'torch', return_logits: bool = False,
                aux_out: list | None = None) -> torch.Tensor:
        '''Teacher-forced forward, as ``BiModalTransformer.forward``;
        ``aux_out`` gains the encoder's MoE losses, then the decoder's.'''
        src_mask = self.src_mask(masks)
        x = self.dropout(positional_encode(self.pe, self._source(src)))
        key_t = self.dropout.take()       # second, as JAX :308-309
        memory = self.encoder(x, src_mask, attention_impl, aux_out)
        t = self.dropout(positional_encode(self.pe, self.trg_emb(trg)),
                         key=key_t)
        out = self.decoder(t, memory, src_mask, masks['C_mask'],
                           attention_impl, aux_out)
        logits = self.generator(out)
        if return_logits:
            return logits
        return torch.log_softmax(logits.float(), dim=-1)

    def decode_init(self, memory: torch.Tensor, max_len: int,
                    kv_int8: bool = False, cache_batch: int | None = None,
                    src_mask=None) -> list:
        '''The KV-cache decode state for ``memory``
        (``Decoder.init_decode_state``).'''
        return self.decoder.init_decode_state(memory, max_len, kv_int8,
                                              cache_batch, src_mask)

    def decode_step(self, state: list, token: torch.Tensor, step: int,
                    src_mask):
        '''As ``BiModalTransformer.decode_step``, over one memory.'''
        c_t = positional_encode(self.pe, self.trg_emb(token), offset=step)
        c_t = self.decoder.step(state, c_t, src_mask, step)
        logits = self.generator(c_t[:, 0, :])
        return torch.log_softmax(logits.float(), dim=-1), state


def captioner_class(dims: CapModelDims):
    '''``BiModalTransformer`` for audio_video, else
    ``UniModalTransformer``.'''
    return (BiModalTransformer if dims.modality == 'audio_video'
            else UniModalTransformer)
