'''Weight-only int8 quantization for serving (counterpart of
``bmt_tpu.ops.quant``).

Scheme (symmetric, no zero points):
  weights, once:     w_scale[j] = max_i |w[j, i]| / 127, one per output
                     channel; w_q = round(w / w_scale)        int8
  activations, per call: x_scale[r] = max_c |x[r, c]| / 127, one per row;
                     x_q = round(x / x_scale)                 int8
  y = (x_q @ w_q^T) * x_scale * w_scale + b                 int32 accumulate

The JAX package keeps a quantized linear as the dict {'w_q', 'w_scale', 'b'}
inside its parameter tree; here ``quantize_tree_int8`` swaps each
``nn.Linear`` of a model for an ``Int8Linear`` module.

The int8 x int8 product is exact. On the card it is ``torch._int_mm``
(cuBLASLt), which takes more than 16 rows and inner and outer sizes that are
multiples of 8: the weights are stored zero-padded to multiples of 8 on both
axes (d_model_C = 300 and the 10172-word vocabulary are not), and a call
pads its activations' columns and, at 16 rows or fewer (a decode step of a
small batch), its rows. A failed launch raises; nothing falls back to a
dequantized product. On the CPU the same integer product runs as a float64
matmul, which is exact here (|sum| <= 127^2 k < 2^53).
'''
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# an all-zero row or column quantizes to zeros instead of dividing by zero
_EPS = 1e-12
_MULTIPLE = 8          # torch._int_mm: inner and outer sizes
_MIN_ROWS = 17         # torch._int_mm: more than 16 rows


def per_127(x: torch.Tensor) -> torch.Tensor:
    '''x / 127, correctly rounded on every device: the divisor is a 0-dim
    tensor on x's device. A CPU scalar divisor would let the card's
    true-divide multiply by its reciprocal instead, which rounds some
    scales (and so the int8 levels) one ulp away from the CPU's and the
    JAX package's.'''
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def _round_up(n: int, m: int = _MULTIPLE) -> int:
    return -(-n // m) * m


def quantize_linear_int8(weight: torch.Tensor):
    '''A torch-layout weight (d_out, d_in) -> (w_q (d_out, d_in) int8,
    w_scale (d_out,) fp32), per-output-channel symmetric scales.'''
    w = weight.detach().float()
    scale = per_127(torch.clamp_min(w.abs().amax(dim=1), _EPS))
    return torch.round(w / scale[:, None]).to(torch.int8), scale


def quantize_rows_int8(x: torch.Tensor):
    '''Activations (..., k) -> (x_q int8, x_scale (..., 1) fp32), one
    symmetric scale per row.'''
    x32 = x.float()
    x_scale = per_127(torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True),
                                      _EPS))
    return torch.round(x32 / x_scale).to(torch.int8), x_scale


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    '''x_q (m, k) int8 @ w_q (n, k)^T int8 -> (m, n) int32, exact. ``k`` and
    ``n`` must be multiples of 8 on the card (``Int8Linear`` pads them).'''
    if not x_q.is_cuda:
        return (x_q.double() @ w_q.double().t()).to(torch.int32)
    m = x_q.shape[0]
    if m < _MIN_ROWS:
        x_q = F.pad(x_q, (0, 0, 0, _MIN_ROWS - m))
    return torch._int_mm(x_q, w_q.t())[:m]


def qlinear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor | None) -> torch.Tensor:
    '''int8 x int8 -> int32 linear with per-row dynamic activation scales;
    y = x @ w^T + b within quantization error, in x's dtype. ``w_q`` may be
    zero-padded beyond (len(w_scale), x.shape[-1]).'''
    n = w_scale.shape[0]
    x_q, x_scale = quantize_rows_int8(x)
    lead = x_q.shape[:-1]
    x_q = x_q.reshape(-1, x_q.shape[-1])
    if x_q.shape[1] != w_q.shape[1]:
        x_q = F.pad(x_q, (0, w_q.shape[1] - x_q.shape[1]))
    acc = int8_matmul(x_q, w_q)[:, :n].reshape(*lead, n)
    y = acc.float() * x_scale * w_scale
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


class Int8Linear(nn.Module):
    '''An ``nn.Linear`` with its weight stored int8 (``qlinear``). Buffers:
    ``w_q`` (d_out, d_in) zero-padded to multiples of 8, ``w_scale``
    (d_out,) fp32 and ``bias`` in the linear's dtype.'''

    def __init__(self, linear: nn.Linear):
        super().__init__()
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        w_q, w_scale = quantize_linear_int8(linear.weight)
        w_q = F.pad(w_q, (0, _round_up(self.in_features) - self.in_features,
                          0, _round_up(self.out_features) - self.out_features))
        self.register_buffer('w_q', w_q.contiguous())
        self.register_buffer('w_scale', w_scale)
        self.register_buffer('bias', None if linear.bias is None
                             else linear.bias.detach().clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return qlinear(x, self.w_q, self.w_scale, self.bias)

    def extra_repr(self) -> str:
        return f'in_features={self.in_features}, ' \
               f'out_features={self.out_features}, int8'


@torch.no_grad()
def quantize_tree_int8(model: nn.Module, skip=()) -> nn.Module:
    '''Swap every ``nn.Linear`` of ``model`` for an ``Int8Linear``, in place;
    returns the model. ``skip``: names of top-level children left as they
    are (e.g. 'emb_C'). A linear that carries a LoRA adapter has it folded
    into its weight first (``ops.lora.merge_linear_lora``), and the merged
    weight is quantized.'''
    from bmt_tpu_torch.ops.lora import has_lora, merge_linear_lora

    def swap(parent: nn.Module, top: bool = False):
        for name, child in parent.named_children():
            if top and name in skip:
                continue
            if isinstance(child, nn.Linear):
                if has_lora(child):
                    merge_linear_lora(child)
                setattr(parent, name, Int8Linear(child))
            else:
                swap(child)

    swap(model, top=True)
    return model


def count_quantized(model: nn.Module) -> int:
    '''The number of ``Int8Linear`` modules of a model.'''
    return sum(isinstance(m, Int8Linear) for m in model.modules())


def linear_out_dim(linear: nn.Module) -> int:
    '''Output width of an ``nn.Linear`` or an ``Int8Linear``.'''
    return linear.out_features
