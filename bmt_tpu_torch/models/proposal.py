'''The event proposal generators (counterpart of
``bmt_tpu.models.proposal``), YOLO-style over the encoder's outputs.

``MultimodalProposalGenerator`` runs the bi-modal encoder, then one
``ProposalHead`` per kernel size on each modality (10 on audio, 10 on video
at the flagship width). Each head is a stack of ``nn.Conv1d`` ("same" zero
padding, odd kernel sizes) whose output holds, at every grid cell and for
every anchor, a center offset, a log length ratio and an objectness logit.
``yolo_decode`` turns those into world coordinates (seconds);
``make_targets_dense`` assigns the padded ground-truth events of a batch to
(anchor, cell) pairs and ``yolo_losses`` scores the heads against them.

The module holds the JAX parameter tree's keys: ``encoder``, ``heads_A``,
``heads_V`` (each head ``{'convs': [...], 'lns': [...]}``), optionally
``emb_A``/``emb_V``, and the anchors ``anchors_A``/``anchors_V`` (seconds,
k-means priors) as top-level parameters. The anchors are never trained: they
are built with ``requires_grad=False``, and ``train.steps.prop_frozen``
names them for the optimizer as ``prop_trainer`` does.

``UnimodalProposalGenerator`` (``--modality audio`` or ``video``) runs the
uni-modal encoder and one set of heads with the modality's stride, conv
layers and kernel sizes; its keys are ``encoder``, ``heads``, optionally
``emb``, and one ``anchors``.

Sequence parallelism (``parallel.seq``; the JAX package's ``shard_seq``
sites ``proposal.py:357, 396, 473``): a modality's features may be this
rank's block of its sequence, shorter than its mask. The positional
encoding, the YOLO grid and the dense targets then start at the block's
first row, each head's first conv reads a halo of its neighbours' rows,
the losses sum over the block's cells (the caller divides by the whole
batch's cell counts), and predictions without targets are gathered in
sequence order.
'''
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bmt_tpu_torch.models.captioning import build_device
from bmt_tpu_torch.models.encoders import BiModalEncoder, Encoder
from bmt_tpu_torch.ops.layers import (Dropout, FeatureEmbedder, LayerNorm,
                                      next_key, positional_encode,
                                      positional_encoding_table,
                                      stream_block)
from bmt_tpu_torch.parallel import seq
from bmt_tpu_torch.params import init_params

POS_ENC_LEN = 3660  # rows of the positional table, as in the reference
EPS = 1e-16         # in the log length ratio of the targets


@dataclasses.dataclass(frozen=True)
class PropModelDims:
    '''Static architecture config; same fields and defaults as
    ``bmt_tpu.models.proposal.PropModelDims``. The strides are the seconds
    one grid cell spans: an audio feature's timespan (0.96 s) and a video
    feature's (64 frames at 25 fps).'''
    modality: str = 'audio_video'
    d_model_A: int = 128
    d_model_V: int = 1024
    d_model: int = 1024
    H: int = 4
    N: int = 2
    d_ff_A: int = 512
    d_ff_V: int = 4096
    dout_p: float = 0.1
    use_linear_embedder: bool = False
    d_vid: int = 1024
    d_aud: int = 128
    kernel_sizes_A: Tuple[int, ...] = (5, 13, 23, 35, 51, 69, 91, 121, 161, 211)
    kernel_sizes_V: Tuple[int, ...] = (1, 5, 9, 13, 19, 25, 35, 45, 61, 79)
    conv_layers_A: Tuple[int, ...] = (512, 512)
    conv_layers_V: Tuple[int, ...] = (512, 512)
    anchors_num_A: int = 48
    anchors_num_V: int = 128
    layer_norm: bool = False
    remat: bool = False
    stride_A: float = 0.96
    stride_V: float = 64 / 25
    obj_coeff: float = 1.0
    noobj_coeff: float = 100.0

    @classmethod
    def from_config(cls, cfg) -> 'PropModelDims':
        '''The dims from a config namespace with the trainer's attribute
        names (``d_model_audio``, ``kernel_sizes['audio']``, ...).'''
        kw = dict(
            modality=cfg.modality,
            d_model_A=getattr(cfg, 'd_model_audio', 128),
            d_model_V=getattr(cfg, 'd_model_video', 1024),
            d_model=cfg.d_model, H=cfg.H, N=cfg.N,
            d_ff_A=getattr(cfg, 'd_ff_audio', 512),
            d_ff_V=getattr(cfg, 'd_ff_video', 4096),
            dout_p=cfg.dout_p, use_linear_embedder=cfg.use_linear_embedder,
            d_vid=cfg.d_vid, d_aud=cfg.d_aud,
            layer_norm=getattr(cfg, 'layer_norm', False),
            remat=getattr(cfg, 'remat', False),
            obj_coeff=getattr(cfg, 'obj_coeff', 1.0),
            noobj_coeff=getattr(cfg, 'noobj_coeff', 100.0),
        )
        if 'audio' in cfg.modality:
            kw.update(kernel_sizes_A=tuple(cfg.kernel_sizes['audio']),
                      conv_layers_A=tuple(cfg.conv_layers_audio),
                      anchors_num_A=cfg.anchors_num_audio,
                      stride_A=cfg.strides['audio'])
        if 'video' in cfg.modality:
            kw.update(kernel_sizes_V=tuple(cfg.kernel_sizes['video']),
                      conv_layers_V=tuple(cfg.conv_layers_video),
                      anchors_num_V=cfg.anchors_num_video,
                      stride_V=cfg.strides['video'])
        return cls(**kw)


class ProposalHead(nn.Module):
    '''(B, S, d_list[0]) -> (B, S, d_list[-1]): convs over the sequence,
    the first with ``kernel_size`` taps, the rest pointwise, all with "same"
    zero padding; an optional LayerNorm before each conv; dropout then ReLU
    between convs, none after the last (``proposal_head_forward``).'''

    def __init__(self, d_model_list, kernel_size: int, with_layer_norm: bool,
                 dout_p: float = 0.0, device=None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f'kernel size {kernel_size}: odd sizes only '
                             f'("same" padding)')
        pairs = list(zip(d_model_list[:-1], d_model_list[1:]))
        self.convs = nn.ModuleList(
            nn.Conv1d(d_in, d_out, k, padding=k // 2, device=device)
            for (d_in, d_out), k in zip(
                pairs, [kernel_size] + [1] * (len(pairs) - 1)))
        self.lns = (nn.ModuleList(LayerNorm(d_in, device=device)
                                  for d_in, _ in pairs)
                    if with_layer_norm else None)
        self.dropout = Dropout(dout_p)

    def forward(self, x: torch.Tensor, whole: int | None = None,
                key=None) -> torch.Tensor:
        '''``whole``: the sequence's length when ``x`` is a block of it
        (sequence parallelism); the first conv then reads a halo of the
        neighbouring blocks instead of zero padding. ``key``: the head's
        ``prng.Key``; conv n's dropout draws fold_in(key, n) for the
        (B, S, D) view whose element order JAX's bits follow (the kernel
        reads the (B, D, S) output in place).'''
        part = seq.part(x.shape[1], whole) if whole else None
        x = x.transpose(1, 2)                       # (B, D, S) for Conv1d
        last = len(self.convs) - 1
        for n, conv in enumerate(self.convs):
            if self.lns is not None:
                x = self.lns[n](x.transpose(1, 2)).transpose(1, 2)
            k = conv.kernel_size[0]
            haloed = (seq.halo(x, k // 2, whole) if n == 0 and whole
                      else None)
            x = (conv(x) if haloed is None
                 else F.conv1d(haloed, conv.weight, conv.bias))
            if n < last and key is not None:
                x = F.relu(self.dropout(
                    x.transpose(1, 2), (stream_block(1, part),),
                    key.fold_in(n)).transpose(1, 2))
            elif n < last:
                x = F.relu(self.dropout(x))
        return x.transpose(1, 2)


def yolo_decode(raw: torch.Tensor, anchors: torch.Tensor,
                stride: float, first: int = 0) -> dict:
    '''raw (B, S, 3 A) head output -> {'sigma_c', 'l', 'sigma_o': (B, A, S)
    in raw's dtype, 'predictions': (B, A S, 3) fp32 [center, length, conf]
    in seconds}, anchor-major. The world coordinates are fp32 whatever the
    compute dtype: a bf16 grid rounds cells past 256 (799 -> 800).
    ``first``: the grid cell of raw's first row (a sequence block).'''
    B, S, _ = raw.shape
    A = anchors.shape[0]
    x = raw.reshape(B, S, A, 3).permute(0, 2, 1, 3)      # (B, A, S, 3)
    sigma_c = torch.sigmoid(x[..., 0])
    l = x[..., 1]
    sigma_o = torch.sigmoid(x[..., 2])
    grid = torch.arange(first, first + S, dtype=torch.float32,
                        device=raw.device)
    prior = (anchors / stride).float()[None, :, None]
    center = (sigma_c.float() + grid) * stride
    length = prior * torch.exp(l.float()) * stride
    preds = torch.stack([center, length, sigma_o.float()], dim=-1)
    return {'sigma_c': sigma_c, 'l': l, 'sigma_o': sigma_o,
            'predictions': preds.reshape(B, A * S, 3)}


def make_targets_dense(centers: torch.Tensor, lengths: torch.Tensor,
                       valid: torch.Tensor, anchors: torch.Tensor,
                       stride: float, S: int):
    '''(obj_mask, noobj_mask, target_x, target_w), each (B, A, S), from the
    ground-truth events (B, E) in seconds, padded to E with ``valid``
    False.

    Each event goes to the anchor whose length is closest by tIoU (the first
    on a tie) and to the cell of its center, clipped to [0, S-1]. Where
    events share an (anchor, cell), the last in event order wins, as the
    reference's loop overwrites: a max-scatter of the event order finds each
    cell's owner, and losing and padded events are routed to a trash column
    S that is cut off, so every write to a real cell is unique (a scatter
    with duplicate indices has no defined order on CUDA).'''
    B, E = centers.shape
    A = anchors.shape[0]
    device = centers.device
    anchors_scaled = anchors.detach() / stride               # (A,)
    gt_x = centers / stride
    gt_w = lengths / stride

    inter = torch.minimum(anchors_scaled[None, None, :],
                          gt_w[:, :, None]).clamp(min=0.0)
    union = torch.maximum(anchors_scaled[None, None, :], gt_w[:, :, None])
    best_anchor = torch.argmax(inter / (union + 1e-8), dim=-1)   # (B, E)

    gt_cell = torch.floor(gt_x).long().clamp(0, S - 1)
    gt_cell = torch.where(valid, gt_cell, S)
    batch_ix = torch.arange(B, device=device)[:, None].expand(B, E)
    order = torch.arange(1, E + 1, device=device)[None, :].expand(B, E)
    order = torch.where(valid, order, 0)

    def flat(cell):
        return ((batch_ix * A + best_anchor) * (S + 1) + cell).reshape(-1)

    owner = torch.zeros(B * A * (S + 1), dtype=torch.long, device=device)
    owner.scatter_reduce_(0, flat(gt_cell), order.reshape(-1), 'amax')
    is_winner = owner[flat(gt_cell)].reshape(B, E) == order
    gt_cell = torch.where(is_winner & valid, gt_cell, S)
    owner = owner.reshape(B, A, S + 1)

    def scatter(values):
        buf = torch.zeros(B * A * (S + 1), dtype=torch.float32, device=device)
        buf[flat(gt_cell)] = values.float().reshape(-1)
        return buf.reshape(B, A, S + 1)[:, :, :S]

    obj_mask = owner[:, :, :S] > 0
    tx = gt_x - torch.floor(gt_x)
    tw = torch.log(gt_w / anchors_scaled[best_anchor] + EPS)
    return obj_mask, ~obj_mask, scatter(tx), scatter(tw)


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    '''max(log x, -100), with the clamped branch's gradient, 0, wherever
    log x <= -100. ``log(x).clamp(min=-100)`` (the JAX package's form) has a
    NaN gradient at x = 0: clamp passes 0 back and log's backward makes
    0 / 0 of it.'''
    live = x > math.exp(-100.0)
    return torch.where(live, torch.log(torch.where(live, x, 1.0)), -100.0)


def _bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    '''Elementwise binary cross-entropy, logs clamped at -100 as
    ``torch.nn.BCELoss`` does. The values are the JAX package's; where a
    confidence rounds to exactly 0 or 1 (in bf16, a logit past ~6) the
    gradient is finite, where the JAX package's is NaN.'''
    return -(t * _clamped_log(p) + (1.0 - t) * _clamped_log(1.0 - p))


def _masked_mean(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return (x * m).sum() / m.sum().clamp(min=1.0)


def yolo_losses(decoded: dict, targets: tuple, obj_coeff: float,
                noobj_coeff: float, denoms=None):
    '''(loss, {'loss_x', 'loss_w', 'loss_conf_obj', 'loss_conf_noobj'}):
    the center and log-length MSE on obj cells, and the objectness BCE on
    obj and on noobj cells, each a masked mean.

    ``denoms``: optional (obj_total, noobj_total) cell counts to divide by
    instead of this batch's own mask sums. The counts depend only on the
    targets, so with the full batch's counts the microbatches' losses add up
    to the full batch's (gradient accumulation).'''
    obj_mask, noobj_mask, target_x, target_w = targets
    obj = obj_mask.float()
    noobj = noobj_mask.float()
    if denoms is None:
        def mean_obj(x):
            return _masked_mean(x, obj)

        def mean_noobj(x):
            return _masked_mean(x, noobj)
    else:
        d_obj = torch.as_tensor(denoms[0]).clamp(min=1.0)
        d_noobj = torch.as_tensor(denoms[1]).clamp(min=1.0)

        def mean_obj(x):
            return (x * obj).sum() / d_obj

        def mean_noobj(x):
            return (x * noobj).sum() / d_noobj

    loss_x = mean_obj((decoded['sigma_c'] - target_x).square())
    loss_w = mean_obj((decoded['l'] - target_w).square())
    bce_o = _bce(decoded['sigma_o'], obj)      # the target is obj_mask
    loss_obj = mean_obj(bce_o)
    loss_noobj = mean_noobj(bce_o)
    loss = loss_x + loss_w + obj_coeff * loss_obj + noobj_coeff * loss_noobj
    return loss, {'loss_x': loss_x, 'loss_w': loss_w,
                  'loss_conf_obj': loss_obj, 'loss_conf_noobj': loss_noobj}


def _heads(dims, d_in, conv_layers, anchors_num, kernel_sizes, device):
    '''One modality's heads: a ``ProposalHead`` per kernel size, from the
    modality's width through its conv layers to 3 values an anchor.'''
    d_list = [d_in, *conv_layers, 3 * anchors_num]
    return nn.ModuleList(
        ProposalHead(d_list, k, dims.layer_norm, dims.dout_p, device)
        for k in kernel_sizes)


def _modality_heads(dims, heads, x, anchors, stride, dense_targets, denoms,
                    whole: int | None = None, key=None):
    '''Every head of one modality; the targets are made once, since they
    depend only on (grid size, stride, anchors). ``whole``: the sequence's
    length when ``x`` is a block of it (sequence parallelism): the targets
    are the block's cells of the whole grid's, and predictions without
    targets are gathered whole. ``key``: the modality's ``prng.Key``; head
    i draws from fold_in(key, i) (JAX :353).'''
    S = x.shape[1]
    whole = whole or S
    first = seq.offset(S, whole)
    targets = None
    if dense_targets is not None:
        targets = make_targets_dense(*dense_targets, anchors, stride, whole)
        if S != whole:
            targets = tuple(t[..., first:first + S] for t in targets)
    preds, total, terms = [], 0.0, {}
    for i, head in enumerate(heads):
        decoded = yolo_decode(
            head(x, whole, None if key is None else key.fold_in(i)),
            anchors, stride, first)
        p = decoded['predictions']
        if targets is None and S != whole:
            p = seq.gather(p.view(p.shape[0], -1, S, 3), whole, 2)
            p = p.reshape(p.shape[0], -1, 3)
        preds.append(p)
        if targets is not None:
            loss, ldict = yolo_losses(decoded, targets, dims.obj_coeff,
                                      dims.noobj_coeff, denoms)
            total = total + loss
            terms = {k: terms.get(k, 0.0) + v for k, v in ldict.items()}
    return torch.cat(preds, dim=1), total, terms


class MultimodalProposalGenerator(nn.Module):
    '''Bi-modal proposal generator.

    ``device``: where the model is built, the card unless the caller names
    another (``device='cpu'``); without a CUDA device the default raises
    rather than building on the CPU.
    ``generator``: a ``torch.Generator`` on ``device``; when given, every
    weight is drawn from it with the JAX package's recipe (the encoder as
    the captioner's, conv weights and biases from U(+-1/sqrt(d_in k))). The
    anchors start at zero; ``set_anchors`` gives them their values.'''

    def __init__(self, dims: PropModelDims, *, device='cuda',
                 generator: torch.Generator | None = None):
        super().__init__()
        device = build_device(device, 'MultimodalProposalGenerator')
        if dims.modality != 'audio_video':
            raise ValueError(f'modality {dims.modality!r}: the bi-modal '
                             f'generator is audio_video; '
                             f'UnimodalProposalGenerator builds the audio '
                             f'and video ones')
        self.dims = dims
        self.encoder = BiModalEncoder(dims.d_model_A, dims.d_model_V,
                                      dims.d_model, dims.d_ff_A, dims.d_ff_V,
                                      dims.N, dims.H, dims.dout_p, device,
                                      remat=dims.remat)
        self.heads_A = _heads(dims, dims.d_model_A, dims.conv_layers_A,
                              dims.anchors_num_A, dims.kernel_sizes_A, device)
        self.heads_V = _heads(dims, dims.d_model_V, dims.conv_layers_V,
                              dims.anchors_num_V, dims.kernel_sizes_V, device)
        if dims.use_linear_embedder:
            self.emb_A = FeatureEmbedder(dims.d_aud, dims.d_model_A, device)
            self.emb_V = FeatureEmbedder(dims.d_vid, dims.d_model_V, device)
        self.anchors_A = nn.Parameter(
            torch.zeros(dims.anchors_num_A, device=device),
            requires_grad=False)
        self.anchors_V = nn.Parameter(
            torch.zeros(dims.anchors_num_V, device=device),
            requires_grad=False)
        self.dropout = Dropout(dims.dout_p)
        for name, width in (('pe_A', dims.d_model_A),
                            ('pe_V', dims.d_model_V)):
            table = torch.tensor(positional_encoding_table(POS_ENC_LEN, width),
                                 device=device)
            self.register_buffer(name, table, persistent=False)
        if generator is not None:
            init_params(self, generator)

    @torch.no_grad()
    def set_anchors(self, anchors_A, anchors_V) -> None:
        '''The anchors in seconds (sequences or tensors of the anchors'
        lengths).'''
        for p, value in ((self.anchors_A, anchors_A),
                         (self.anchors_V, anchors_V)):
            p.copy_(torch.as_tensor(value, dtype=p.dtype))

    def forward(self, src: dict, dense_targets, masks: dict,
                attention_impl: str = 'torch', loss_denoms=None):
        '''src {'rgb', 'flow': (B, Sv, d_vid), 'audio': (B, Sa, d_aud)};
        dense_targets None (inference) or (centers, lengths, valid), each
        (B, E) in seconds; loss_denoms None or ((obj_A, noobj_A),
        (obj_V, noobj_V)) (see ``yolo_losses``).

        Returns (predictions (B, A_A Sa + A_V Sv, 3) fp32, the audio heads
        first, each head anchor-major; loss; losses_A; losses_V). Without
        targets the loss is 0.0 and the loss dicts are empty.'''
        dims = self.dims
        A, V = src['audio'], src['rgb'] + src['flow']
        Sa, Sv = masks['A_mask'].shape[-1], masks['V_mask'].shape[-1]
        if dims.use_linear_embedder:
            A, V = self.emb_A(A), self.emb_V(V)
        A = self.dropout(positional_encode(self.pe_A, A,
                                           seq.offset(A.shape[1], Sa)),
                         (stream_block(1, seq.part(A.shape[1], Sa)),))
        V = self.dropout(positional_encode(self.pe_V, V,
                                           seq.offset(V.shape[1], Sv)),
                         (stream_block(1, seq.part(V.shape[1], Sv)),))
        Av, Va = self.encoder(A, V, masks['A_mask'], masks['V_mask'],
                              attention_impl)
        denoms_A, denoms_V = (loss_denoms if loss_denoms is not None
                              else (None, None))
        preds_A, loss_A, losses_A = _modality_heads(
            dims, self.heads_A, Av, self.anchors_A, dims.stride_A,
            dense_targets, denoms_A, Sa, next_key())
        preds_V, loss_V, losses_V = _modality_heads(
            dims, self.heads_V, Va, self.anchors_V, dims.stride_V,
            dense_targets, denoms_V, Sv, next_key())
        return (torch.cat([preds_A, preds_V], dim=1), loss_A + loss_V,
                losses_A, losses_V)


class UnimodalProposalGenerator(nn.Module):
    '''Uni-modal proposal generator (``dims.modality`` 'audio' or
    'video'); the arguments as ``MultimodalProposalGenerator``'s. The
    uni-modal encoder (dense feed-forwards) and one set of heads, with the
    modality's width, stride, conv layers, kernel sizes and anchor
    count.'''

    def __init__(self, dims: PropModelDims, *, device='cuda',
                 generator: torch.Generator | None = None):
        super().__init__()
        device = build_device(device, 'UnimodalProposalGenerator')
        if dims.modality not in ('audio', 'video'):
            raise ValueError(f'modality {dims.modality!r}: the uni-modal '
                             f'generator is audio or video')
        self.dims = dims
        video = dims.modality == 'video'
        d_model = dims.d_model_V if video else dims.d_model_A
        self.stride = dims.stride_V if video else dims.stride_A
        self.encoder = Encoder(d_model, dims.d_ff_V if video else dims.d_ff_A,
                               dims.N, dims.H, dims.dout_p, device)
        anchors_num = dims.anchors_num_V if video else dims.anchors_num_A
        self.heads = _heads(
            dims, d_model, dims.conv_layers_V if video else dims.conv_layers_A,
            anchors_num, dims.kernel_sizes_V if video else dims.kernel_sizes_A,
            device)
        if dims.use_linear_embedder:
            self.emb = FeatureEmbedder(dims.d_vid if video else dims.d_aud,
                                       d_model, device)
        self.anchors = nn.Parameter(torch.zeros(anchors_num, device=device),
                                    requires_grad=False)
        self.dropout = Dropout(dims.dout_p)
        self.register_buffer('pe', torch.tensor(
            positional_encoding_table(POS_ENC_LEN, d_model), device=device),
            persistent=False)
        if generator is not None:
            init_params(self, generator)

    @torch.no_grad()
    def set_anchors(self, anchors) -> None:
        '''The anchors in seconds.'''
        self.anchors.copy_(torch.as_tensor(anchors, dtype=self.anchors.dtype))

    def forward(self, src: dict, dense_targets, masks: dict,
                attention_impl: str = 'torch', loss_denoms=None):
        '''src and dense_targets as ``MultimodalProposalGenerator``'s;
        loss_denoms None or one (obj, noobj) count pair.

        Returns (predictions (B, A S, 3) fp32, each head anchor-major; loss;
        the loss terms), as JAX ``unimodal_proposal_forward``.'''
        dims = self.dims
        if dims.modality == 'video':
            x, src_mask = src['rgb'] + src['flow'], masks['V_mask']
        else:
            x, src_mask = src['audio'], masks['A_mask']
        S = src_mask.shape[-1]
        if dims.use_linear_embedder:
            x = self.emb(x)
        x = self.dropout(positional_encode(self.pe, x,
                                           seq.offset(x.shape[1], S)),
                         (stream_block(1, seq.part(x.shape[1], S)),))
        x = self.encoder(x, src_mask, attention_impl)
        return _modality_heads(dims, self.heads, x, self.anchors, self.stride,
                               dense_targets, loss_denoms, S, next_key())


def proposal_class(dims: PropModelDims):
    '''``MultimodalProposalGenerator`` for audio_video, else
    ``UnimodalProposalGenerator``.'''
    return (MultimodalProposalGenerator if dims.modality == 'audio_video'
            else UnimodalProposalGenerator)
