'''Fused masked attention, forward and backward: the CUDA kernels' wrappers,
their plain versions, and the autograd Function around them.

Counterpart of ``bmt_tpu.ops.pallas_attention.flash_attention``, with the same
contract: q (B, H, Sq, d), k/v (B, H, Sk, d); ``mask`` is None, a
(B, 1, 1, Sk) key-padding mask, or a (B, 1, Sq, Sk) causal-and-padding mask
(True = attend). The mask reduces to a (B, Sk) int32 key-validity vector and
a causal flag; for a causal mask the vector is the last query row, which sees
every non-pad key. Logits and softmax are fp32 with -inf masking, and a row
with no valid key is NaN in the forward and gets zero gradients.

Three kernels, each with a wrapper, a plain version and a launch counter:

- ``flash_attn_fwd`` (``csrc/flash_attn_fwd.cu``): the output, and with
  ``with_lse`` the row log-sum-exp (B, H, Sq) fp32 that the backward reads.
  In fp32, when the blocks of a call would not fill the card, each row's key
  loop is split over several blocks and a second kernel combines their
  partials (``fp32_key_splits``); that is one launch all the same;
- ``flash_attn_bwd_dq`` and ``flash_attn_bwd_dkv`` (``csrc/flash_attn_bwd.cu``):
  dQ, and dK with dV, rebuilding the softmax from the lse.

``flash_attention`` is differentiable: under autograd it runs
``FlashAttention`` (forward with lse; backward D = rowsum(dO * O), then dQ,
then dK/dV). On a CPU tensor every wrapper runs its plain version. On a CUDA
tensor it launches its kernel or raises; it never falls back.

``attention_cost`` gives the FLOPs and bytes of each kernel's call from its
shapes alone, for the bound a measurement is held against.
'''
from __future__ import annotations

import ctypes
import functools
import math

import torch

KERNEL = 'flash_attn_fwd'
BWD_LIBRARY = 'flash_attn_bwd'
KERNEL_DQ = 'flash_attn_bwd_dq'
KERNEL_DKV = 'flash_attn_bwd_dkv'
MAX_HEAD_DIM = 256
# H100 SXM peaks (NVIDIA's data sheet, dense) and HBM3. bf16: the tensor
# cores' bf16 rate. float32: the TF32 rate over three, because fp32 work on
# the tensor cores takes three TF32 products for each fp32 product to keep
# fp32 accuracy (csrc/mma_tf32.cuh), as the fp32 kernels do
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 495e12 / 3}
PEAK_BYTES_PER_S = 3.35e12
# the fp32 forward kernel's tiles: query rows a block, keys a tile
FP32_BQ, FP32_BK = 64, 32


def fp32_key_splits(B: int, H: int, Sq: int, Sk: int, n_sms: int) -> int:
    '''How many blocks share each query tile's key loop in the fp32
    forward. B H ceil(Sq / 64) blocks that fill the card's ``n_sms`` SMs
    (one block an SM at d = 256) take 1. Fewer take min(key tiles, n_sms //
    blocks), so that all blocks still run in one wave, cut to the least
    count that gives the same number of key tiles a block (none empty).'''
    blocks = B * H * -(-Sq // FP32_BQ)
    tiles = -(-Sk // FP32_BK)
    if blocks >= n_sms:
        return 1
    splits = min(tiles, max(1, n_sms // blocks))
    return -(-tiles // -(-tiles // splits))


def key_mask_and_causal(mask: torch.Tensor | None, B: int, Sk: int,
                        device) -> tuple[torch.Tensor, bool]:
    '''Reduce an attention mask to ((B, Sk) int32 key validity, causal).'''
    if mask is None:
        return torch.ones((B, Sk), dtype=torch.int32, device=device), False
    causal = mask.shape[2] != 1
    key_mask = mask[:, 0, -1, :] if causal else mask[:, 0, 0, :]
    return key_mask.expand(B, Sk).to(torch.int32).contiguous(), causal


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    '''fp32 for fp32/bf16 inputs, fp64 for fp64 (gradcheck).'''
    return torch.promote_types(t.dtype, torch.float32)


def _valid(key_mask, causal: bool, Sq: int, Sk: int, device):
    '''(B, 1, 1|Sq, Sk) boolean validity of each logit.'''
    valid = (key_mask != 0)[:, None, None, :]
    if causal:
        rows = torch.arange(Sq, device=device)[:, None]
        cols = torch.arange(Sk, device=device)[None, :]
        valid = valid & (cols <= rows)
    return valid


def _logits(q, k, key_mask, causal: bool):
    '''Scaled logits in the accumulation dtype, and their validity.'''
    acc = _acc_dtype(q)
    Sq, Sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    return s * (1.0 / math.sqrt(d)), _valid(key_mask, causal, Sq, Sk,
                                            q.device)


def _masked_logits(q, k, key_mask, causal: bool):
    s, valid = _logits(q, k, key_mask, causal)
    return s.masked_fill(~valid, -math.inf)


def flash_attention_reference(q, k, v, key_mask: torch.Tensor,
                              causal: bool) -> torch.Tensor:
    '''The forward kernel's plain PyTorch version on the reduced mask: fp32
    logits scaled by 1/sqrt(d), -inf masking, fp32 softmax, p cast to v's
    dtype for the value product (as the Pallas kernels do).'''
    p = torch.softmax(_masked_logits(q, k, key_mask, causal), dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def flash_attention_lse_reference(q, k, v, key_mask: torch.Tensor,
                                  causal: bool):
    '''(out, lse): the forward and the row log-sum-exp (B, H, Sq) of the
    masked scaled logits in the accumulation dtype; -inf on empty rows.'''
    s = _masked_logits(q, k, key_mask, causal)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v), torch.logsumexp(s, dim=-1)


def _recon_p(q, k, key_mask, causal: bool, lse):
    '''P = where(valid, exp(s - lse), 0) (``_recon_p``, pallas_attention.py
    :332-348): an empty row (lse = -inf, no valid column) is all zero.'''
    s, valid = _logits(q, k, key_mask, causal)
    return torch.where(valid, torch.exp(s - lse[..., None]), 0.0)


def row_dot(out, dout) -> torch.Tensor:
    '''D = rowsum(dO * O) in fp32 (B, H, Sq), NaN (empty rows) -> 0, as
    ``_flash_attention_tiled_bwd`` computes it outside the kernels.'''
    acc = _acc_dtype(out)
    D = (dout.to(acc) * out.to(acc)).sum(-1)
    return torch.where(D.isnan(), 0.0, D)


def _dS(q, k, v, key_mask, causal: bool, lse, drow, dout):
    '''(P, dS = P * (dO v^T - D) * scale) in the accumulation dtype.'''
    acc = _acc_dtype(q)
    p = _recon_p(q, k, key_mask, causal, lse)
    dp = torch.matmul(dout.to(acc), v.to(acc).transpose(-1, -2))
    return p, p * (dp - drow[..., None]) * (1.0 / math.sqrt(q.shape[-1]))


def flash_attention_bwd_dq_reference(q, k, v, key_mask, causal: bool, lse,
                                     drow, dout) -> torch.Tensor:
    '''The dQ kernel's plain version (``_dq_kernel``, :351-389): dS cast to
    k's dtype before dQ = dS k, as the Pallas kernel does.'''
    _, ds = _dS(q, k, v, key_mask, causal, lse, drow, dout)
    return torch.matmul(ds.to(k.dtype), k).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, key_mask, causal: bool, lse,
                                      drow, dout):
    '''The dK/dV kernel's plain version (``_dkv_kernel``, :392-431): P cast
    to dO's dtype before dV = P^T dO, dS to q's before dK = dS^T q.'''
    p, ds = _dS(q, k, v, key_mask, causal, lse, drow, dout)
    dv = torch.matmul(p.to(dout.dtype).transpose(-1, -2), dout).to(v.dtype)
    dk = torch.matmul(ds.to(q.dtype).transpose(-1, -2), q).to(k.dtype)
    return dk, dv


def flash_attention_backward_reference(q, k, v, key_mask, causal: bool, out,
                                       lse, dout):
    '''(dq, dk, dv) from the saved forward (out, lse) and the output
    gradient, by the math of the two backward kernels.'''
    drow = row_dot(out, dout)
    dq = flash_attention_bwd_dq_reference(q, k, v, key_mask, causal, lse,
                                          drow, dout)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, key_mask, causal,
                                               lse, drow, dout)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def attention_cost(kernel: str, B: int, H: int, Sq: int, Sk: int, d: int,
                   dtype: str, causal: bool, with_lse: bool = True):
    '''(FLOPs, bytes) of one call of ``kernel`` (KERNEL, KERNEL_DQ or
    KERNEL_DKV) at these shapes. FLOPs: 2 d per (query, key) pair and
    product, over the pairs the causal mask keeps (all of them without it):
    2 products in the forward (Q K^T, P V), 3 in dQ (S, dP, dQ), 4 in dK/dV
    (S, dP, dV, dK). Bytes: each input read once and each output written
    once: q, k, v (and dO) in ``dtype``, the (B, Sk) int32 key mask, the
    fp32 lse and D rows, and the outputs (out and, ``with_lse``, lse; dQ;
    dK and dV).'''
    size = {'bfloat16': 2, 'float32': 4}[dtype]
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    products, inputs, outputs, rows = {
        KERNEL: (2, Sq + 2 * Sk, Sq, int(with_lse)),
        KERNEL_DQ: (3, 2 * Sq + 2 * Sk, Sq, 2),
        KERNEL_DKV: (4, 2 * Sq + 2 * Sk, 2 * Sk, 2)}[kernel]
    flops = 2 * products * B * H * pairs * d
    nbytes = (B * H * (inputs + outputs) * d * size + B * Sk * 4
              + rows * B * H * Sq * 4)
    return flops, nbytes


def attention_bound_ms(flops: int, nbytes: int, dtype: str):
    '''(least ms the card could take, 'operations' or 'bytes'): the larger
    of FLOPs over the peak rate of ``dtype`` and bytes over HBM's rate.'''
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops > t_bytes else (t_bytes, 'bytes')


# ---------------------------------------------------------------------------
# kernel wrappers: plain version on the CPU, the kernel on CUDA, else raise.
# The dtype picks the kernel behind each C entry point; every kernel runs on
# tensor cores: 3xTF32 for float32, bf16 for bfloat16. Both are
# hand-written kernels of the same function; the choice is the input's
# type, not a fallback.
# ---------------------------------------------------------------------------

def flash_attention_forward(q, k, v, key_mask, causal: bool,
                            with_lse: bool = False):
    '''out, or (out, lse) with ``with_lse``. In fp32 the key loop is split
    over ``fp32_key_splits`` blocks for this card. The kernel's launches are
    counted in ``flash_attention.launches``.'''
    if q.device.type == 'cpu':
        if with_lse:
            return flash_attention_lse_reference(q, k, v, key_mask, causal)
        return flash_attention_reference(q, k, v, key_mask, causal)
    _check(KERNEL, q=q, k=k, v=v, mask=key_mask)
    B, H, Sq, d = q.shape
    key_splits = (fp32_key_splits(B, H, Sq, k.shape[2], _sm_count(q.device))
                  if q.dtype == torch.float32 else 1)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    fwd, fwd_split = _fwd_kernels()
    if key_splits == 1:
        _run(KERNEL, fwd, q, k, v, key_mask, out, lse, *_dims(q, k),
             int(causal))
    else:
        part = torch.empty(key_splits * B * H * Sq * (d + 2),
                           dtype=torch.float32, device=q.device)
        _run(KERNEL, fwd_split, q, k, v, key_mask, out, lse, part,
             *_dims(q, k), int(causal), key_splits)
    flash_attention.launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_dq(q, k, v, key_mask, causal: bool, lse, drow,
                           dout) -> torch.Tensor:
    '''dQ. ``.launches`` counts kernel launches.'''
    if q.device.type == 'cpu':
        return flash_attention_bwd_dq_reference(q, k, v, key_mask, causal,
                                                lse, drow, dout)
    _check(KERNEL_DQ, q=q, k=k, v=v, mask=key_mask, dout=dout, lse=lse,
           drow=drow)
    dq = torch.empty_like(q)
    _run(KERNEL_DQ, _bwd_kernels()[0], q, k, v, key_mask, dout, lse, drow,
         dq, *_dims(q, k), int(causal))
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, key_mask, causal: bool, lse, drow,
                            dout):
    '''(dK, dV). ``.launches`` counts kernel launches.'''
    if q.device.type == 'cpu':
        return flash_attention_bwd_dkv_reference(q, k, v, key_mask, causal,
                                                 lse, drow, dout)
    _check(KERNEL_DKV, q=q, k=k, v=v, mask=key_mask, dout=dout, lse=lse,
           drow=drow)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run(KERNEL_DKV, _bwd_kernels()[1], q, k, v, key_mask, dout, lse, drow,
         dk, dv, *_dims(q, k), int(causal))
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def launch_counts() -> dict:
    '''{kernel name: launches so far} of the three kernels.'''
    return {KERNEL: flash_attention.launches,
            KERNEL_DQ: flash_attention_bwd_dq.launches,
            KERNEL_DKV: flash_attention_bwd_dkv.launches}


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention_bwd_dq.launches = 0
    flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    '''Differentiable fused attention on the reduced mask (counterpart of
    ``_flash_attention_vjp`` with ``_fa_fwd``/``_fa_bwd``). Gradients of an
    empty row are zero, not NaN.'''

    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal: bool):
        out, lse = flash_attention_forward(q, k, v, key_mask, causal,
                                           with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        # merge_heads transposes, so dout may arrive as a strided view
        dout = dout.contiguous()
        drow = row_dot(out, dout)
        dq = flash_attention_bwd_dq(q, k, v, key_mask, ctx.causal, lse, drow,
                                    dout)
        dk, dv = flash_attention_bwd_dkv(q, k, v, key_mask, ctx.causal, lse,
                                         drow, dout)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask) -> torch.Tensor:
    '''Drop-in fused replacement for ``scaled_dot_attention(q, k, v, mask)``,
    differentiable. ``flash_attention.launches`` counts the forward
    kernel's launches.'''
    key_mask, causal = key_mask_and_causal(mask, q.shape[0], k.shape[2],
                                           q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, key_mask, causal)
    return flash_attention_forward(q, k, v, key_mask, causal)


flash_attention.launches = 0


def _check(name, **tensors):
    q = tensors['q']
    for arg, t in tensors.items():
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError(f'{name}: {arg} is on {t.device}; all inputs '
                             f'must be on one CUDA device')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {arg} must be contiguous')
        if t.data_ptr() % 16:
            raise ValueError(f'{name}: {arg} must start on a 16-byte '
                             f'boundary (the kernels copy 16-byte chunks)')
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'{name}: dtype {q.dtype} is not supported (float32 '
                        f'or bfloat16)')
    for arg in ('k', 'v', 'dout'):
        if arg in tensors and tensors[arg].dtype != q.dtype:
            raise TypeError(f'{name}: q, k, v (and dout) must share one '
                            f'dtype')
    B, H, Sq, d = q.shape
    Sk = tensors['k'].shape[2]
    k, v = tensors['k'], tensors['v']
    if k.shape != (B, H, Sk, d) or v.shape != k.shape:
        raise ValueError(f'{name}: shapes q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)} disagree')
    if 'dout' in tensors and tensors['dout'].shape != q.shape:
        raise ValueError(f'{name}: dout {tuple(tensors["dout"].shape)} is '
                         f'not q\'s shape {tuple(q.shape)}')
    for arg in ('lse', 'drow'):
        if arg in tensors and (tensors[arg].shape != (B, H, Sq)
                               or tensors[arg].dtype != torch.float32):
            raise ValueError(f'{name}: {arg} must be float32 (B, H, Sq) = '
                             f'{(B, H, Sq)}')
    if tensors['mask'].shape != (B, Sk) or tensors['mask'].dtype != \
            torch.int32:
        raise ValueError(f'{name}: key mask {tuple(tensors["mask"].shape)} '
                         f'{tensors["mask"].dtype} is not int32 (B, Sk) = '
                         f'{(B, Sk)}')
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f'{name}: head dim {d} must be <= {MAX_HEAD_DIM} '
                         f'and a multiple of 8')
    if min(B, H, Sq, Sk) == 0:
        raise ValueError(f'{name}: empty input')


def _dims(q, k):
    B, H, Sq, d = q.shape
    return B, H, Sq, k.shape[2], d


def _run(name, fn, *args):
    '''Call a kernel's C entry point: tensors as pointers, then the ints,
    then the dtype flag and the current stream; raise on a launch error.'''
    q = args[0]
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed: cudaError_t {err}')


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _fwd_kernels():
    '''(flash_attn_fwd, flash_attn_fwd_split) of the forward library.'''
    from bmt_tpu_torch.ops._build import load_library
    lib = load_library(KERNEL)
    fwd, split = lib.flash_attn_fwd, lib.flash_attn_fwd_split
    fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p])
    split.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                      + [ctypes.c_void_p])
    fwd.restype = split.restype = ctypes.c_int
    return fwd, split


@functools.cache
def _bwd_kernels():
    from bmt_tpu_torch.ops._build import load_library
    lib = load_library(BWD_LIBRARY)
    dq, dkv = lib.flash_attn_bwd_dq, lib.flash_attn_bwd_dkv
    dq.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    dkv.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv
