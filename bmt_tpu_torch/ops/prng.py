'''The threefry2x32 PRNG of ``jax.random``, bit for bit, in PyTorch: keys,
``fold_in``, random bits, ``uniform``, ``gumbel`` and ``categorical``, and
the two CUDA kernels that draw from it (``csrc/threefry.cu``).

It follows JAX 0.9 with ``jax_threefry_partitionable`` on (its default) and
64-bit types off:

- a key is two uint32 words; ``key(seed)`` is (0, seed mod 2**32), as
  ``threefry_seed`` of a 32-bit seed;
- ``fold_in(key, data)`` hashes the pair (0, data) under the key, and the
  two words it gives are the new key;
- element i (its flat C-order index) of a tensor of random bits is
  threefry2x32(key, (i >> 32, i mod 2**32)), the two output words xored,
  cut to the low 16 bits for uint16. So every element is a function of its
  own global index: a rank draws its block of a global tensor from the
  block's offsets alone (``offsets``), and the block equals that slice of
  the whole draw.

Keys are (2,) uint32 tensors on the caller's device. The arithmetic here is
int64 masked to 32 bits (torch's uint32 has few operations); it is the
plain version of the kernels, and what runs on the CPU.

``Key`` is a base key and the data still to fold into it: the dropout
kernel folds them in on the device, so a site's key costs no launch of its
own, and a CUDA graph that reads the base key from a buffer draws fresh
masks at every replay. ``dropout`` applies the JAX package's dropout
(``bmt_tpu.ops.layers.dropout``): keep where the element's u16 bits are
below round(keep 2**16) (at most 65535), x / keep there and 0 elsewhere, in
x's dtype; in bf16 ``keep`` is rounded to bf16 first, as JAX's weak-typed
``x / keep`` does. It is differentiable, and its backward applies the same
mask to the gradient.

On a CUDA tensor ``dropout`` launches ``threefry_dropout_kernel`` and
``bits`` of uint32 ``threefry_bits32_kernel``; a CPU tensor runs the plain
version. A failed build or launch raises; nothing falls back.
'''
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence

import torch

from bmt_tpu_torch.ops import launches

LIBRARY = 'threefry'
KERNEL_DROPOUT = 'threefry_dropout'
KERNEL_BITS32 = 'threefry_bits32'
MASK32 = 0xFFFFFFFF
MAX_PATH = 8            # data a kernel folds into its key (csrc/threefry.cu)
MAX_DIMS = 4
# The integer instructions an element needs, every key-derived constant
# computed once a launch: 20 rounds of add, rotate (one funnel shift) and
# xor; the counter's low word plus k1; the five injections' adds to x1 and
# the last one's to x0 (the other x0 adds and the counter's high word fold
# into the next round's add, a 3-input IADD3); the xor of the two words.
# The dropout fuses that xor with the 16-bit mask (one LOP3) and compares.
# The rotations, xors and compare run on the INT32 lanes only (ALU_OPS);
# an add may also issue on the FP32 lanes, as IMAD.
THREEFRY_INT_OPS = 20 * 3 + 1 + 5 + 1 + 1
THREEFRY_ALU_OPS = 20 * 2 + 1
DROPOUT_INT_OPS = THREEFRY_INT_OPS + 1
DROPOUT_ALU_OPS = THREEFRY_ALU_OPS + 1
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    '''The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key (k0, k1): python ints or int64 tensors holding uint32
    values. Returns the two output words.'''
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) & MASK32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key_words(seed: int) -> tuple:
    '''The two words of ``jax.random.key(seed)``.'''
    return 0, int(seed) & MASK32


def fold_in_words(words: tuple, data: int) -> tuple:
    '''``fold_in`` on host words: the two words of fold_in(key, data).'''
    return threefry2x32(int(words[0]), int(words[1]), 0, int(data) & MASK32)


def key(seed: int, device='cuda') -> torch.Tensor:
    '''``jax.random.key(seed)`` (``PRNGKey``) as a (2,) uint32 tensor on
    ``device``.'''
    return torch.tensor(key_words(seed), dtype=torch.int64,
                        device=device).to(torch.uint32)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    '''``jax.random.fold_in(k, data)``, data in [0, 2**32).'''
    w = k.to(torch.int64)
    y0, y1 = threefry2x32(w[0], w[1], torch.zeros_like(w[1]),
                          torch.full_like(w[1], int(data) & MASK32))
    return torch.stack([y0, y1]).to(torch.uint32)


@dataclasses.dataclass(frozen=True, eq=False)
class Key:
    '''``base`` (a (2,) uint32 tensor) with the data of ``path`` folded into
    it in order; the kernels fold on the device.'''
    base: torch.Tensor
    path: tuple = ()

    def fold_in(self, *data: int) -> 'Key':
        return Key(self.base, self.path + tuple(int(d) & MASK32
                                                for d in data))

    def resolve(self) -> torch.Tensor:
        '''The key itself: the folds done with the plain arithmetic.'''
        k = self.base
        for d in self.path:
            k = fold_in(k, d)
        return k


def as_key(k) -> Key:
    return k if isinstance(k, Key) else Key(k)


def _layout(shape: Sequence[int], block: Optional[Sequence[int]],
            offsets: Optional[Sequence[int]]) -> tuple:
    shape = tuple(int(s) for s in shape)
    block = shape if block is None else tuple(int(s) for s in block)
    offsets = (0,) * len(shape) if offsets is None else tuple(
        int(o) for o in offsets)
    if not len(shape) == len(block) == len(offsets):
        raise ValueError(f'shape {shape}, block {block} and offsets '
                         f'{offsets} differ in rank')
    for s, b, o in zip(shape, block, offsets):
        if o < 0 or b < 0 or o + b > s:
            raise ValueError(f'block {block} at {offsets} is not inside '
                             f'{shape}')
    return shape, block, offsets


def global_index(shape, block=None, offsets=None, device='cpu'
                 ) -> torch.Tensor:
    '''The flat C-order index in ``shape`` of each element of the block
    (int64, the block's shape).'''
    shape, block, offsets = _layout(shape, block, offsets)
    idx = torch.zeros(block, dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        view = [1] * len(shape)
        view[d] = block[d]
        idx = idx + ((torch.arange(block[d], device=device) + offsets[d])
                     * stride).view(view)
        stride *= shape[d]
    return idx


def _bits_reference(k: Key, shape, block=None, offsets=None,
                    device='cpu') -> torch.Tensor:
    '''The uint32 bits of the block, int64 (the plain arithmetic).'''
    w = k.resolve().to(torch.int64).to(device)
    idx = global_index(shape, block, offsets, device)
    y0, y1 = threefry2x32(w[0], w[1], idx >> 32, idx & MASK32)
    return y0 ^ y1


def bits_reference(k, shape, dtype=torch.uint32, block=None,
                   offsets=None) -> torch.Tensor:
    '''``bits``' plain version, on the key's device.'''
    k = as_key(k)
    b = _bits_reference(k, shape, block, offsets, k.base.device)
    if dtype == torch.uint16:
        return (b & 0xFFFF).to(torch.uint16)
    if dtype == torch.uint32:
        return b.to(torch.uint32)
    raise ValueError(f'bits: dtype {dtype} is not uint16 or uint32')


def bits(k, shape, dtype=torch.uint32, block=None, offsets=None
         ) -> torch.Tensor:
    '''``jax.random.bits(k, shape, dtype)``, or its block of extent
    ``block`` at ``offsets`` of the same draw, on the key's device. uint32
    bits on a CUDA key come from ``threefry_bits32_kernel``.'''
    k = as_key(k)
    if k.base.device.type == 'cuda' and dtype == torch.uint32:
        return bits32_kernel(k, shape, block, offsets)
    return bits_reference(k, shape, dtype, block, offsets)


def _uniform_from_bits(b: torch.Tensor, minval: float, maxval: float
                       ) -> torch.Tensor:
    '''float32 uniforms from uint32 bits (int64 or uint32 tensor), as
    ``jax.random.uniform`` makes them: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval), at least
    minval.'''
    f = ((b.to(torch.int64) >> 9) | 0x3F800000).to(torch.int32)
    f = f.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=b.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=b.device)
    # XLA fuses f (hi - lo) + lo into one fused multiply-add: the product
    # is exact in fp64, and the sum is rounded to fp32 from there
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def uniform(k, shape, minval: float = 0.0, maxval: float = 1.0,
            block=None, offsets=None) -> torch.Tensor:
    '''``jax.random.uniform(k, shape, float32, minval, maxval)`` (or a
    block of it).'''
    return _uniform_from_bits(bits(k, shape, torch.uint32, block, offsets),
                              minval, maxval)


def gumbel(k, shape, block=None, offsets=None) -> torch.Tensor:
    '''``jax.random.gumbel(k, shape, float32)`` (its "low" mode, the
    default): -log(-log(u)), u uniform in [tiny, 1).'''
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(k, shape, tiny, 1.0, block, offsets)
    return -torch.log(-torch.log(u))


def categorical(k, logits: torch.Tensor, rows=None) -> torch.Tensor:
    '''``jax.random.categorical(k, logits, axis=-1)`` of (n, V) float32
    logits: argmax(logits + Gumbel noise). ``rows`` = (lo, B): the logits
    are rows lo.. of a B-row draw, and take those rows' noise.'''
    n, V = logits.shape
    lo, B = (0, n) if rows is None else rows
    noise = gumbel(k, (B, V), (n, V), (lo, 0))
    return (logits + noise).argmax(dim=-1)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def keep_threshold(p: float) -> int:
    '''The u16 bound below which an element is kept: round(keep 2**16), at
    most 65535 (``bmt_tpu.ops.layers.dropout``).'''
    return min(round((1.0 - p) * 65536.0), 65535)


def keep_value(p: float, dtype) -> float:
    '''1 - p as x's dtype holds it: the divisor of the kept elements.'''
    return torch.tensor(1.0 - p, dtype=dtype).item()


def dropout_reference(x: torch.Tensor, k, p: float, shape=None,
                      offsets=None) -> torch.Tensor:
    '''The dropout kernel's plain version: x is the block at ``offsets`` of
    a tensor of ``shape`` (default: x is whole).'''
    k = as_key(k)
    shape = x.shape if shape is None else shape
    b = _bits_reference(k, shape, x.shape, offsets, x.device) & 0xFFFF
    keep = torch.tensor(keep_value(p, x.dtype), dtype=x.dtype,
                        device=x.device)
    return torch.where(b < keep_threshold(p), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _apply(x, k, p, shape, offsets):
    if x.device.type == 'cpu':
        return dropout_reference(x, k, p, shape, offsets)
    return dropout_kernel(x, k, p, shape, offsets)


class _Dropout(torch.autograd.Function):
    '''The mask of (key, shape, offsets) on x; the backward applies it to
    the gradient (g / keep where kept), drawn again, not saved.'''

    @staticmethod
    def forward(ctx, x, k, p, shape, offsets):
        ctx.args = (k, p, shape, offsets)
        return _apply(x, k, p, shape, offsets)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, *ctx.args), None, None, None, None


def dropout(x: torch.Tensor, k, p: float, shape=None, offsets=None
            ) -> torch.Tensor:
    '''JAX's dropout of x with key ``k`` (a ``Key`` or a key tensor),
    differentiable; x the block at ``offsets`` of a tensor of ``shape``
    (default: x is whole).'''
    k = as_key(k)
    shape = tuple(x.shape) if shape is None else tuple(shape)
    offsets = (0,) * x.dim() if offsets is None else tuple(offsets)
    return _Dropout.apply(x, k, float(p), shape, offsets)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

def memory_order(x: torch.Tensor) -> Optional[tuple]:
    '''The dims of x from the outermost in memory to the innermost, when x
    is dense in some order of its dims (a transposed view, as the
    proposal heads' (B, D, S) conv outputs are of their (B, S, D)
    draws); None otherwise.'''
    order = tuple(sorted(range(x.dim()), key=lambda d: (-x.stride(d), d)))
    return order if x.permute(order).is_contiguous() else None


def divider(d: int) -> tuple:
    '''(magic, shift) that divide an n < 2**31 by d >= 1 with one high
    multiply, an add and a shift: n // d = (umulhi(n, magic) + n) >> shift
    (the division of PyTorch's ``IntDivider``).'''
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def _index_args(shape, block, offsets, order=None) -> tuple:
    '''(int64[21]: the block's extents, their dividers' magics and shifts
    (``divider``), the global tensor's C-order strides and the block's
    offsets, in the memory order ``order`` of the block's dims (default C
    order), 4 dims each with leading ones, then 1 when the block is the
    whole tensor in C order; the block's element count).'''
    shape, block, offsets = _layout(shape, block, offsets)
    if len(shape) > MAX_DIMS:
        raise ValueError(f'threefry kernels: {len(shape)} dims, at most '
                         f'{MAX_DIMS}')
    strides, s = [0] * len(shape), 1
    for d in range(len(shape) - 1, -1, -1):
        strides[d] = s
        s *= shape[d]
    order = tuple(range(len(shape))) if order is None else tuple(order)
    whole = int(block == shape and order == tuple(range(len(shape))))
    pad = MAX_DIMS - len(shape)
    n = math.prod(block)
    if n >= 2 ** 31 or s >= 2 ** 64:
        raise ValueError(f'threefry kernels: a block of {n} elements of '
                         f'{s}: too large')
    extents = (1,) * pad + tuple(block[d] for d in order)
    magics, shifts = zip(*(divider(b) if b else (1, 0) for b in extents))
    arr = (ctypes.c_longlong * 21)(
        *extents, *magics, *shifts,
        *(1,) * pad, *(strides[d] for d in order),
        *(0,) * pad, *(offsets[d] for d in order), whole)
    return arr, n


def _path_arg(k: Key):
    if len(k.path) > MAX_PATH:
        raise ValueError(f'threefry kernels: {len(k.path)} folds, at most '
                         f'{MAX_PATH}')
    return (ctypes.c_uint32 * MAX_PATH)(*k.path), len(k.path)


def _check_key(name: str, k: Key, device) -> None:
    b = k.base
    if b.device != device or b.dtype != torch.uint32 or b.shape != (2,) \
            or not b.is_contiguous():
        raise ValueError(f'{name}: the key must be a contiguous (2,) uint32 '
                         f'tensor on {device}, not {tuple(b.shape)} '
                         f'{b.dtype} on {b.device}')


def dropout_kernel(x: torch.Tensor, k: Key, p: float, shape, offsets
                   ) -> torch.Tensor:
    '''``threefry_dropout_kernel`` on x (fp32 or bf16, CUDA): one
    launch. x dense in any order of its dims is read in place, and the
    result has its strides; any other x is copied first.'''
    if x.device.type != 'cuda':
        raise ValueError(f'{KERNEL_DROPOUT}: x is on {x.device}; the kernel '
                         f'takes CUDA tensors (a CPU tensor runs its plain '
                         f'version)')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'{KERNEL_DROPOUT}: dtype {x.dtype}, not float32 or '
                         f'bfloat16')
    _check_key(KERNEL_DROPOUT, k, x.device)
    order = memory_order(x)
    if order is None:
        x = x.contiguous()
    out = torch.empty_like(x)            # x's strides, x dense
    index, n = _index_args(shape, x.shape, offsets, order)
    path, n_path = _path_arg(k)
    if n:
        with torch.cuda.device(x.device):
            err = _kernels()[0](
                x.data_ptr(), out.data_ptr(), k.base.data_ptr(), path,
                n_path, index, n, keep_threshold(p),
                keep_value(p, x.dtype), int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'{KERNEL_DROPOUT} launch failed: '
                               f'cudaError_t {err}')
        launches.launched(KERNEL_DROPOUT)
    return out


def bits32_kernel(k: Key, shape, block=None, offsets=None) -> torch.Tensor:
    '''``threefry_bits32_kernel``: the uint32 bits of the block on the key's
    (CUDA) device; one launch.'''
    device = k.base.device
    _check_key(KERNEL_BITS32, k, device)
    index, n = _index_args(shape, block, offsets)
    out = torch.empty(tuple(shape if block is None else block),
                      dtype=torch.uint32, device=device)
    path, n_path = _path_arg(k)
    if n:
        with torch.cuda.device(device):
            err = _kernels()[1](
                out.data_ptr(), k.base.data_ptr(), path, n_path, index, n,
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f'{KERNEL_BITS32} launch failed: '
                               f'cudaError_t {err}')
        launches.launched(KERNEL_BITS32)
    return out


launches.register(KERNEL_DROPOUT, dropout_kernel)
launches.register(KERNEL_BITS32, bits32_kernel)


@functools.cache
def _kernels():
    '''(threefry_dropout, threefry_bits32) of the library, built on first
    use.'''
    from bmt_tpu_torch.ops._build import load_library
    lib = load_library(LIBRARY)
    drop, bits32 = lib.threefry_dropout, lib.threefry_bits32
    drop.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.c_uint32, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    bits32.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_longlong,
        ctypes.c_void_p]
    drop.restype = bits32.restype = ctypes.c_int
    return drop, bits32


def dropout_cost(n: int, dtype) -> tuple:
    '''(integer ops, of them those only the INT32 lanes run, bytes) of one
    dropout launch on n elements: x read and the result written once.'''
    size = torch.tensor([], dtype=dtype).element_size()
    return n * DROPOUT_INT_OPS, n * DROPOUT_ALU_OPS, 2 * n * size


def bits32_cost(n: int) -> tuple:
    '''(integer ops, INT32-lane ops, bytes) of one bits launch on n
    elements.'''
    return n * THREEFRY_INT_OPS, n * THREEFRY_ALU_OPS, 4 * n
