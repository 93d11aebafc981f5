'''Building-block layers (counterpart of ``bmt_tpu.ops.layers``).

Each module keeps the JAX parameter names as attribute names (a JAX linear
``{w, b}`` becomes an ``nn.Linear``), so ``bmt_tpu_torch.params`` can carry a
JAX parameter tree across by walking them. ``Dropout`` modules sit where the
JAX package draws dropout; serving runs in ``eval()``, where they are no-ops.

In training, a step's dropout masks come from one of two sources, as the
JAX package's ``--prng_impl`` picks:

- threefry2x32: a key stream (``key_stream``), the counterpart of JAX's
  ``_rng_stream``: the i-th key a stream hands out is fold_in(key, i), and
  every ``Dropout`` takes the next one at the point where the JAX model
  calls ``next(rngs)``, so each mask is JAX's bit for bit
  (``ops.prng.dropout``, one kernel launch a site on the card). A mask is a
  function of the key and of each element's global index, so a rank whose
  tensor is a block of the global one (its batch rows, ``row_block``; its
  tensor-parallel slice, sequence or expert block, ``Dropout``'s
  ``blocks``) draws its part of the one global mask. A recompute under
  ``checkpoint`` draws the same key again;
- rbg (or outside a stream): an explicit ``torch.Generator``: under
  ``dropout_generator(g)`` every ``Dropout`` draws its mask from ``g``, so a
  step's masks depend only on how ``g`` was seeded, not on what ran before.
  ``checkpoint`` (the counterpart of ``jax.checkpoint``) replays those
  draws when the backward recomputes a block, eagerly and inside a CUDA
  graph (``RematStarts``). JAX leaves rbg's bits to the backend, so these
  masks are the port's own.
'''
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from bmt_tpu_torch.ops import prng
from bmt_tpu_torch.parallel import tensor
from bmt_tpu_torch.parallel.tensor import (ColumnParallelLinear,
                                           RowParallelLinear)

_generator: torch.Generator | None = None


class KeyStream:
    '''fold_in(key, 1), fold_in(key, 2), ...: JAX's ``_rng_stream`` of a
    ``prng.Key``.'''

    def __init__(self, key: prng.Key):
        self.key, self.count = key, 0

    def next(self) -> prng.Key:
        self.count += 1
        return self.key.fold_in(self.count)


# process-wide, not per thread: on the card the autograd engine runs the
# backward, and with it a remat layer's recompute, on a thread of its own
_stream: KeyStream | None = None
_rows: tuple | None = None


@contextlib.contextmanager
def key_stream(key):
    '''Inside the block every ``Dropout`` in training mode takes its key
    from a fresh stream of ``key`` (a ``prng.Key`` or a key tensor); None
    leaves the active stream as it is.'''
    global _stream
    if key is None:
        yield
        return
    previous, _stream = _stream, KeyStream(prng.as_key(key))
    try:
        yield
    finally:
        _stream = previous


def next_key() -> prng.Key | None:
    '''The active stream's next key, None without a stream.'''
    return None if _stream is None else _stream.next()


def stream_block(dim: int, part: tuple | None) -> tuple | None:
    '''A sequence- or expert-parallel block (i, n) at ``dim`` as one of
    ``Dropout``'s ``blocks``: under a key stream the rank draws that block
    of the global mask. None for a whole tensor, and without a stream,
    where the generator's ranks draw masks of their own.'''
    return None if part is None or _stream is None else (dim, *part)


@contextlib.contextmanager
def row_block(i: int, n: int):
    '''The batch dim of every tensor that a ``Dropout`` draws for inside
    the block is the i-th of n equal row blocks of the global batch (a data
    parallel rank's rows): its masks are those rows of the global masks.'''
    global _rows
    previous, _rows = _rows, (int(i), int(n))
    try:
        yield
    finally:
        _rows = previous


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator | None):
    '''Draw the mask of every ``Dropout`` in training mode from
    ``generator`` inside the block.'''
    global _generator
    previous, _generator = _generator, generator
    try:
        yield
    finally:
        _generator = previous


class Dropout(nn.Module):
    '''Inverted dropout: in training, zero each element with probability p
    and scale the rest by 1/(1-p); the identity in eval mode or at p = 0,
    which takes no key (every site of a model has the same p, and the
    JAX sites that take none are the reference's dropout-free ones).

    Inside a ``key_stream``: JAX's threefry mask of ``key``, or of the
    stream's next key (``ops.prng.dropout``). Else the mask comes from the
    generator of ``dropout_generator``, or from torch's default generator
    outside one, drawn and scaled in x's dtype.

    ``blocks``: (dim, i, n) each, or None: x is the i-th of n equal slices
    along ``dim`` of the tensor that one process would draw for (an mp
    rank's, ``parallel.tensor.block``; a sequence- or expert-parallel
    rank's, ``stream_block``), and under ``row_block`` the rows of its
    batch dim ``batch_dim``. The mask is the whole tensor's there, so a rank
    drops what one process would drop.'''

    def __init__(self, p: float = 0.0, batch_dim: int = 0):
        super().__init__()
        self.p = p
        self.batch_dim = batch_dim

    def take(self) -> prng.Key | None:
        '''The key of this dropout's next draw, taken now from the active
        stream (where JAX evaluates ``next(rngs)`` before the sublayer that
        the dropout follows); None when it draws no key.'''
        if not self.training or self.p == 0.0:
            return None
        return next_key()

    def forward(self, x: torch.Tensor, blocks=(),
                key: prng.Key | None = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if key is None:
            key = next_key()
        parts = [(dim % x.dim(), i, n) for dim, i, n in
                 (b for b in blocks if b is not None)]
        if key is not None and _rows is not None:
            parts.append((self.batch_dim % x.dim(), *_rows))
        shape, offsets = list(x.shape), [0] * x.dim()
        for dim, i, n in parts:
            offsets[dim] = i * x.shape[dim]
            shape[dim] = n * x.shape[dim]
        if key is not None:
            return prng.dropout(x, key, self.p, shape, offsets)
        keep = x.new_empty(shape) if parts else torch.empty_like(x)
        keep.bernoulli_(1.0 - self.p, generator=_generator)
        for dim, _, _ in parts:
            keep = keep.narrow(dim, offsets[dim], x.shape[dim])
        return x * keep.div_(1.0 - self.p)

    def extra_repr(self) -> str:
        return f'p={self.p}'


class RematStarts:
    '''Where each ``checkpoint`` block of a train step starts drawing its
    dropout masks, for a CUDA graph of the step (``train.graphs``).

    A graph cannot move a generator back: its draws read the seed and the
    offset from device memory that each replay fills, and
    ``get_state``/``set_state`` act on the host copy only. So the eager
    warm-up step records each block's starting offset (``offsets``), and
    the captured step recomputes block j from a generator of its own
    (``generators[j]``, registered with the graph), which ``reseed`` sets
    before every replay to the step's seed at offsets[j]: the recompute then
    draws the masks of the first run.'''

    def __init__(self):
        self.offsets: list = []
        self.generators: list = []
        self._next = 0

    def make_generators(self, generator: torch.Generator) -> list:
        '''One generator a block, cloned from ``generator`` (before the
        capture, to be registered with the graph).'''
        self.generators = [generator.clone_state() for _ in self.offsets]
        return self.generators

    def take(self) -> torch.Generator:
        '''The next block's generator, during the capture.'''
        if self._next >= len(self.generators):
            raise RuntimeError(
                f'the captured step runs more checkpoint blocks than its '
                f'warm-up ({len(self.generators)})')
        self._next += 1
        return self.generators[self._next - 1]

    def reseed(self, seed: int) -> None:
        for g, offset in zip(self.generators, self.offsets):
            g.manual_seed(seed)
            g.set_offset(offset)


_remat: RematStarts | None = None


@contextlib.contextmanager
def remat_starts(starts: RematStarts | None):
    '''Record (eagerly) or hand out (while a CUDA graph captures) the
    ``checkpoint`` blocks' dropout starts in ``starts``.'''
    global _remat
    previous, _remat = _remat, starts
    try:
        yield
    finally:
        _remat = previous


def checkpoint(module: nn.Module, *args):
    '''``torch.utils.checkpoint`` of module(*args) (non-reentrant): its
    activations are recomputed in the backward instead of kept.

    The recompute must see what the first run saw: the parameter tensors the
    module held then (under ``torch.func.functional_call`` those are the
    compute-dtype copies, which are gone by the backward), and the dropout
    generator where it stood then, set back for the recompute and restored
    after it; while a CUDA graph captures, a generator of the block's own
    that each replay sets there (``RematStarts``).'''
    params = dict(module.named_parameters())
    g = _generator
    start = replay = None
    if g is not None and _remat is not None \
            and torch.cuda.is_current_stream_capturing():
        replay = _remat.take()
    elif g is not None:
        start = g.get_state()
        if _remat is not None:
            _remat.offsets.append(g.get_offset())
    calls = 0

    def run(params, *a):
        nonlocal calls
        calls += 1
        if calls == 1 or g is None:
            return torch.func.functional_call(module, params, a)
        if replay is not None:
            with dropout_generator(replay):
                return torch.func.functional_call(module, params, a)
        resume = g.get_state()
        g.set_state(start)
        try:
            with dropout_generator(g):
                return torch.func.functional_call(module, params, a)
        finally:
            g.set_state(resume)
    return torch.utils.checkpoint.checkpoint(run, params, *args,
                                             use_reentrant=False)


class LayerNorm(nn.Module):
    '''LayerNorm over the last dim, eps 1e-5, statistics in fp32, result cast
    back to the input dtype (``layers.py:layer_norm``).'''

    def __init__(self, d: int, eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class FeedForward(nn.Module):
    '''Linear -> ReLU -> dropout -> Linear (the dense ``ffn_apply`` path);
    under tensor parallelism ``fc1`` is column-parallel and ``fc2``
    row-parallel over the hidden width (``parallel.tensor``).'''

    def __init__(self, d_model: int, d_ff: int, dout_p: float = 0.0,
                 device=None):
        super().__init__()
        self.fc1 = ColumnParallelLinear(d_model, d_ff, device=device)
        self.fc2 = RowParallelLinear(d_ff, d_model, device=device)
        self.dropout = Dropout(dout_p)

    def forward(self, x: torch.Tensor, seq: tuple | None = None
                ) -> torch.Tensor:
        '''``seq`` = (i, n): x is that block of its sequence (dim 1).'''
        h = self.dropout(F.relu(self.fc1(x)), (tensor.block(self.fc1, -1),
                                               stream_block(1, seq)))
        return self.fc2(h)


def residual(norm: LayerNorm, x: torch.Tensor, sublayer,
             dropout: nn.Module, seq: tuple | None = None) -> torch.Tensor:
    '''Pre-norm residual: x + dropout(sublayer(LN(x))). The dropout's key
    is taken before the sublayer runs, as JAX's ``residual(..., next(rngs))``
    takes it; ``seq`` = (i, n): x is that block of its sequence (dim 1).'''
    if not isinstance(dropout, Dropout):
        return x + dropout(sublayer(norm(x)))
    key = dropout.take()
    return x + dropout(sublayer(norm(x)), (stream_block(1, seq),), key)


class Bridge(nn.Module):
    '''LN -> Linear -> dropout -> ReLU (``layers.py:bridge``).'''

    def __init__(self, d_in: int, d_out: int, dout_p: float = 0.0,
                 device=None):
        super().__init__()
        self.norm = LayerNorm(d_in, device=device)
        self.linear = nn.Linear(d_in, d_out, device=device)
        self.dropout = Dropout(dout_p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.dropout(self.linear(self.norm(x))))


@functools.lru_cache(maxsize=16)
def positional_encoding_table(seq_len: int, d_model: int) -> np.ndarray:
    '''The reference's sinusoid table: sin(pos / 10000^(j/d)) for even j and
    cos(pos / 10000^(j/d)) for odd j -- the cos term uses the odd index's own
    exponent. (seq_len, d_model) fp32, made once per shape.'''
    pos = np.arange(seq_len, dtype=np.float64)[:, None]
    j = np.arange(d_model, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, j / d_model)
    table = np.where(j % 2 == 0, np.sin(angle), np.cos(angle))
    table = table.astype(np.float32)
    table.flags.writeable = False      # shared by every caller
    return table


def positional_encode(table: torch.Tensor, x: torch.Tensor,
                      offset: int = 0) -> torch.Tensor:
    '''x + table[offset:offset + S], the table cast to x's dtype.'''
    S = x.shape[-2]
    return x + table[offset:offset + S].to(x.dtype)


class VocabularyEmbedder(nn.Module):
    '''Token lookup, then the optional Linear+ReLU adapter (present when the
    table is narrower or wider than ``emb_dim``, as with GloVe), then
    x sqrt(emb_dim).'''

    def __init__(self, voc_size: int, emb_dim: int,
                 table_dim: int | None = None, device=None):
        super().__init__()
        table_dim = table_dim or emb_dim
        self.emb_dim = emb_dim
        self.table = nn.Parameter(torch.empty(voc_size, table_dim,
                                              device=device))
        nn.init.xavier_uniform_(self.table)
        self.adapter = (nn.Linear(table_dim, emb_dim, device=device)
                        if table_dim != emb_dim else None)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.table)
        if self.adapter is not None:
            x = F.relu(self.adapter(x))
        return x * math.sqrt(self.emb_dim)


class FeatureEmbedder(nn.Module):
    '''Linear -> x sqrt(d_model) -> ReLU (``layers.py:feature_embed``).'''

    def __init__(self, d_feat: int, d_model: int, device=None):
        super().__init__()
        self.linear = nn.Linear(d_feat, d_model, device=device)
        self.d_model = d_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.linear(x) * math.sqrt(self.d_model))
