'''Data, sequence, expert and tensor parallelism, and ZeRO-3 (counterpart
of ``bmt_tpu.parallel.mesh``; the reference wraps its models in
``nn.DataParallel``, scripts/train_captioning_module.py:61).

Two forms, as the JAX package has one mesh for both:

- ``DataParallel``: one process per card in a ``torch.distributed`` group
  (``maybe_init_distributed``), for the trainers and the evaluation. The
  ranks form a grid of ``dp x sp x ep x mp`` in the JAX mesh's axis order,
  rank r at coordinates ``unravel(r, (dp, sp, ep, mp))``. The global batch
  (``Config.train_batch_size = B * dp_devices``) is split into contiguous
  row blocks by the **dp** coordinate (``local_rows``, the datasets'
  per-process hook; ``shard``), so the ranks of one sp, ep or mp group see
  the same rows, as under JAX's ``P('dp')``. Under sp, ``shard`` also
  takes the rank's block of each ``(B, S, D)`` feature leaf whose S
  divides sp (``parallel.seq``). The train steps sum the ranks' gradients
  over the ranks that share the ep and mp coordinates (``data`` group:
  dp x sp) with one all-reduce of a flat buffer a step (summed, not
  averaged: the losses are already divided by the global
  token and cell counts, which are all-reduced first), and decode outputs
  are gathered in row order over dp (``decode``). ``--fsdp`` shards the
  large parameters and their optimizer state over dp
  (``parallel.sharding_rules.ParamShards``), ``--ep_devices`` the MoE
  experts over ep (``ops.moe``), and ``mp`` (``DataParallel(mp=)``, a
  library argument as in the JAX package; main.py has no flag for it) the
  attention heads, the feed-forward widths and the vocabulary over the mp
  ranks (``parallel.tensor``).
- ``LocalReplicas``: copies of a model on local devices in one process, for
  serving (``serve.CaptionEngine(dp=)``) and the acceptance chain: a batch's
  row blocks decode in one thread each, on a CUDA stream of their own, so one
  replica's per-step host sync does not hold the others. The threads share
  one interpreter lock, so a host-bound decode gains no host time from them:
  today replicas cost throughput (two on one H100 decode at 0.30-0.43x one's
  rate, PERF.md section 5), and on several cards the gain is not measured.

The backend is NCCL when every rank has a card of its own; gloo on the
CPU, and on the card only when the caller of ``launch.spawn`` names it (two
ranks sharing one card, where NCCL refuses). Nothing falls back: fewer
cards than ranks raises, naming both counts. Collectives on CUDA tensors
under gloo go through host copies (``Group``), one implementation for both
backends.

Where each flag acts follows the JAX package (``axes``): ``--sp_devices`` in
train_prop, ``--ep_devices`` in train_cap, ``--fsdp`` in both; evaluate and
the acceptance chain are data-parallel only. ``--fsdp`` composes with
each: the dp shards are replicated over sp (their gradients summed over
dp x sp), under ep the experts keep their ep blocks whole over dp (the JAX
rules split them over dp too; the results do not depend on the layout),
and under mp a leaf's mp block is what is cut over dp. Pipeline
parallelism is ``parallel.pipeline``, over a group of its own.
'''
from __future__ import annotations

import contextlib
import copy
import os
import sys
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

def default_backend(device_type: str) -> str:
    '''NCCL on the card, gloo on the CPU.'''
    return 'nccl' if device_type == 'cuda' else 'gloo'


def maybe_init_distributed(device_type: str = 'cuda',
                           backend: Optional[str] = None) -> bool:
    '''Join a ``torch.distributed`` group when the environment names one:
    torchrun's ``RANK``, ``WORLD_SIZE`` (with ``MASTER_ADDR`` and
    ``MASTER_PORT``), or the JAX package's ``JAX_COORDINATOR_ADDRESS``
    (host:port), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``. Returns
    whether a group is up; does nothing when neither is set. The backend
    is ``backend``, or ``default_backend(device_type)``.'''
    if dist.is_initialized():
        return True
    env = os.environ
    if 'RANK' in env and 'WORLD_SIZE' in env:
        init, rank, world = 'env://', int(env['RANK']), int(env['WORLD_SIZE'])
    elif 'JAX_COORDINATOR_ADDRESS' in env:
        init = f'tcp://{env["JAX_COORDINATOR_ADDRESS"]}'
        rank, world = int(env['JAX_PROCESS_ID']), int(env['JAX_NUM_PROCESSES'])
    else:
        return False
    dist.init_process_group(backend or default_backend(device_type),
                            init_method=init, world_size=world, rank=rank)
    return True


def local_rank() -> int:
    '''This process's index on its host: ``LOCAL_RANK`` (torchrun), else
    the global rank (one host).'''
    if 'LOCAL_RANK' in os.environ:
        return int(os.environ['LOCAL_RANK'])
    return dist.get_rank() if dist.is_initialized() else 0


def check_cards(n: int, backend: str) -> int:
    '''Raise when ``n`` ranks (or replicas) need more cards than are
    visible; NCCL needs a card per rank, gloo (named by the caller of
    ``launch.spawn``) may share them. Prints the JAX package's NOTE when
    cards are left unused. Returns the visible card count.'''
    count = torch.cuda.device_count()
    if backend == 'nccl' and n > count:
        raise ValueError(
            f'a group of {n} ranks (--dp_devices x --sp_devices x '
            f'--ep_devices x mp) needs {n} CUDA devices (one a rank under '
            f'NCCL), but {count} are visible')
    if 0 < n < count:
        print(f'NOTE: data parallelism over {n} of {count} visible CUDA '
              f'devices; pass --dp_devices {count} to use all of them',
              file=sys.stderr)
    return count


def rank_device(device, backend: str) -> torch.device:
    '''This rank's device: its own card (``cuda:LOCAL_RANK``) under NCCL,
    the card it shares (``LOCAL_RANK`` modulo the visible cards) under
    gloo, the CPU for a CPU run.'''
    device = torch.device(device)
    if device.type != 'cuda':
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError('data parallelism on cuda, but no CUDA device is '
                           'available')
    idx = local_rank()
    if backend == 'nccl' and idx >= count:
        raise ValueError(f'rank {idx} has no CUDA device of its own: {count} '
                         f'are visible')
    return torch.device('cuda', idx % count)


PROCEDURE_AXES = {'train_cap': ('ep',), 'train_prop': ('sp',)}


def axes(cfg) -> tuple:
    '''(dp, sp, ep) of the config's procedure, where the JAX package
    reads each flag: ``--sp_devices`` in train_prop only, ``--ep_devices``
    in train_cap only; evaluate is data-parallel only. An unset
    ``--dp_devices`` is 1.'''
    live = PROCEDURE_AXES.get(getattr(cfg, 'procedure', None), ())
    return (getattr(cfg, 'dp_devices', 1) or 1,
            (getattr(cfg, 'sp_devices', 1) or 1) if 'sp' in live else 1,
            (getattr(cfg, 'ep_devices', 1) or 1) if 'ep' in live else 1)


class Group:
    '''A set of ranks for collectives: ``size``, this rank's index
    ``rank`` in it, the ``torch.distributed`` handle (None: the default
    group), whether CUDA tensors travel through host copies (gloo), and
    ``ranks``, the members' global ranks in group order (for point-to-point
    sends, ``parallel.pipeline``). A copy of a module keeps the same group
    (``__deepcopy__``).'''

    def __init__(self, handle=None, size: int = 1, rank: int = 0,
                 host: bool = False, ranks=None):
        self.handle, self.size, self.rank, self.host = handle, size, rank, host
        self.ranks = list(range(size)) if ranks is None else list(ranks)

    def __deepcopy__(self, memo):
        return self

    def _buf(self, t: torch.Tensor) -> torch.Tensor:
        if self.host and t.device.type != 'cpu':
            return t.detach().cpu()
        return t.detach().clone().contiguous()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        '''The reduction over the group of ``t`` (a new tensor on ``t``'s
        device).'''
        if self.size == 1:
            return t
        buf = self._buf(t)
        dist.all_reduce(buf, op=op, group=self.handle)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> list:
        '''Every rank's equal-shaped ``t``, in group order, on ``t``'s
        device.'''
        if self.size == 1:
            return [t]
        src = self._buf(t)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.handle)
        return [x.to(t.device) for x in parts]


def axis_group(shape: tuple, rank: int, keep: tuple, host: bool) -> Group:
    '''The group of the ranks that share this rank's coordinates on the
    axes not in ``keep`` (indices into ``shape``). Every rank creates every
    such group, in one order, as ``new_group`` asks.'''
    world = int(np.prod(shape))
    size = int(np.prod([shape[i] for i in keep]))
    if size == 1:
        return Group()
    if size == world:
        return Group(None, size, rank, host)
    grid = np.arange(world).reshape(shape)
    moved = np.moveaxis(grid, keep, range(len(shape) - len(keep), len(shape)))
    mine = None
    for ranks in moved.reshape(-1, size):
        members = [int(r) for r in ranks]
        handle = dist.new_group(members)
        if rank in ranks:
            mine = Group(handle, size, members.index(rank), host, members)
    return mine


def _leading(tree) -> Optional[int]:
    '''The leading dim of the first array leaf of a dict tree.'''
    for v in (tree.values() if isinstance(tree, dict) else [tree]):
        if isinstance(v, dict):
            n = _leading(v)
        elif isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim:
            n = v.shape[0]
        else:
            continue
        if n is not None:
            return n
    return None


class DataParallel:
    '''This process's place in the ``dp x sp x ep x mp`` grid: ``n_dp``,
    ``n_sp``, ``n_ep``, ``n_mp`` ranks a side (1 outside a group), its
    global ``rank`` and coordinates ``dp_rank``, ``sp_rank``, ``ep_rank``,
    ``mp_rank``, its ``device``, and the groups of the ranks that differ
    only in dp (``dp_group``), sp (``sp_group``), ep (``ep_group``), mp
    (``mp_group``), and in dp or sp (``data_group``: the ranks that share the
    ep and mp coordinates, over which losses, counts and gradients sum).
    ``dp``, ``sp``, ``ep``: the configured counts (``axes``), ``mp`` the
    JAX ``DataParallel``'s argument; their product must equal the group's
    size (a group joined by ``maybe_init_distributed`` or the spawn in
    ``__main__``), as ``make_mesh`` asks for devices. ``fsdp``: the
    trainers shard the large parameters over dp (``shard_params``).'''

    def __init__(self, dp: Optional[int] = None, device=None, sp: int = 1,
                 ep: int = 1, mp: int = 1, fsdp: bool = False):
        dp, sp, ep, mp = dp or 1, sp or 1, ep or 1, mp or 1
        counts = (f'--dp_devices {dp} x --sp_devices {sp} x --ep_devices '
                  f'{ep} x mp {mp}')
        if min(dp, sp, ep, mp) < 1:
            raise ValueError(f'{counts}: every count must be at least 1')
        self.fsdp = bool(fsdp)
        self.device = torch.device(device or 'cuda')
        self.shards = None
        want = dp * sp * ep * mp
        if dist.is_initialized():
            world = dist.get_world_size()
            if want != world:
                raise ValueError(
                    f'{counts} = {want} ranks, but the process group has '
                    f'{world} ranks; they must be equal')
            self.rank, self.backend = dist.get_rank(), dist.get_backend()
        elif want > 1:
            raise RuntimeError(
                f'{counts}: parallelism runs one process a rank; launch '
                f'through python -m bmt_tpu_torch (it spawns them) or '
                f'torchrun')
        else:
            self.rank, self.backend = 0, None
        self.n_dp, self.n_sp, self.n_ep, self.n_mp = dp, sp, ep, mp
        self.size = want
        self.dp_rank, self.sp_rank, self.ep_rank, self.mp_rank = (
            int(i) for i in np.unravel_index(self.rank, (dp, sp, ep, mp)))
        host = self.backend == 'gloo' and self.device.type != 'cpu'
        shape = (dp, sp, ep, mp)
        self.world = Group(None, want, self.rank, host) if want > 1 \
            else Group()
        self.dp_group = axis_group(shape, self.rank, (0,), host)
        self.sp_group = axis_group(shape, self.rank, (1,), host)
        self.ep_group = axis_group(shape, self.rank, (2,), host)
        self.mp_group = axis_group(shape, self.rank, (3,), host)
        self.data_group = axis_group(shape, self.rank, (0, 1), host)

    @property
    def is_main(self) -> bool:
        '''Rank 0: the one that writes checkpoints, logs and scores.'''
        return self.rank == 0

    @property
    def seed_rank(self) -> int:
        '''The index of this rank's dropout stream under rbg
        (``steps.step_seed``): its (dp, sp) place, so the ep and mp ranks
        of one row block draw the same masks (an mp rank keeps its slice
        of a mask inside a tensor-parallel block, ``ops.layers.Dropout``)
        and each sp rank draws for its own rows; 0 in one process. Under
        threefry no rank needs one: each draws its block of the one global
        mask from its offsets.'''
        return self.dp_rank * self.n_sp + self.sp_rank

    def local_rows(self, B: int) -> Optional[tuple]:
        '''This rank's contiguous row block (lo, hi) of a (B, ...) batch by
        its dp coordinate; None with one dp rank (the whole batch is local),
        as the JAX package's.'''
        if self.n_dp == 1:
            return None
        if B % self.n_dp:
            raise ValueError(f'batch of {B} rows does not split over '
                             f'{self.n_dp} ranks')
        n = B // self.n_dp
        return self.dp_rank * n, (self.dp_rank + 1) * n

    def shard(self, batch, seq: bool = True):
        '''This rank's rows of every array leaf of a batch (a dict tree of
        (B, ...) numpy arrays or tensors), as tensors on its device; other
        leaves as they are. Under sp (unless ``seq`` is off: a model
        without sequence parallelism then runs the rows whole on each sp
        rank), each (B, S, D) leaf whose S divides sp keeps only this
        rank's sequence block, and the batch gains ``'seq_split'``, the
        names of those leaves (``parallel.seq``).'''
        B = _leading(batch)
        rows = self.local_rows(B)
        split = set()
        n_sp = self.n_sp if seq else 1
        if rows is None and n_sp == 1:
            return batch
        lo, hi = rows if rows is not None else (0, B)

        def take(x, key=None):
            if isinstance(x, dict):
                return {k: take(v, k) for k, v in x.items()}
            if not (isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim):
                return x
            x = x[lo:hi]
            if n_sp > 1 and x.ndim == 3 and x.shape[1] % n_sp == 0:
                n = x.shape[1] // n_sp
                x = x[:, self.sp_rank * n:(self.sp_rank + 1) * n]
                split.add(key)
            return torch.as_tensor(x).to(self.device)
        out = take(batch)
        if split:
            out['seq_split'] = tuple(sorted(split))
        return out

    def maybe_shard(self, batch):
        '''``shard`` when the batch splits evenly over the dp ranks, else
        the batch as it is (every rank then runs all of it).'''
        B = _leading(batch)
        if self.size > 1 and B is not None and B % self.n_dp == 0:
            return self.shard(batch)
        return batch

    # -- collectives --------------------------------------------------------

    def _host(self, t: torch.Tensor) -> bool:
        return self.backend == 'gloo' and t.device.type != 'cpu'

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        '''The sum of ``t`` over the ranks that share this rank's ep
        coordinate (the row and sequence blocks of one global batch).'''
        return self.data_group.all_reduce(t)

    def gather_params(self) -> None:
        '''Before a train step's forward: the whole parameters of the
        ``--fsdp`` leaves (``ParamShards.gather``); nothing without.'''
        if self.shards is not None:
            self.shards.gather()

    def all_reduce_grads(self, params) -> None:
        '''Sum every parameter's ``.grad`` over the data group, in place:
        one all-reduce of a flat buffer per dtype. A parameter without a
        gradient joins as zeros, as the optimizer reads it. Under
        ``--fsdp`` each rank keeps its shard of the large leaves' sums and
        the parameters go back to their shards
        (``ParamShards.reduce_grads``).'''
        if self.shards is not None:
            params = self.shards.reduce_grads(params)
        sum_grads(params, self.data_group)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        '''The dp ranks' equal-shaped row blocks joined in rank order.'''
        if self.n_dp == 1:
            return t
        return torch.cat(self.dp_group.all_gather(t))

    def broadcast_object(self, obj, src: int = 0):
        '''Rank ``src``'s ``obj`` on every rank (a picklable value).'''
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, device=(
            self.device if self.backend == 'nccl' else None))
        return box[0]

    def any(self, flag: bool) -> bool:
        '''Whether ``flag`` holds on any rank (so all stop together).'''
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=(
            self.device if self.backend == 'nccl' else 'cpu'))
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module, src: int = 0) -> None:
        '''Rank ``src``'s parameters into every rank's ``module``, in place
        (before ``shard_params``: every rank then holds the whole model).'''
        if self.size == 1:
            return
        params = list(module.parameters())
        flat = torch.cat([p.detach().reshape(-1).float() for p in params])
        buf = flat.cpu() if self._host(flat) else flat
        dist.broadcast(buf, src=src)
        flat = buf.to(flat.device)
        for p, chunk in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(chunk.view_as(p))

    def shard_params(self, state, min_elems: Optional[int] = None):
        '''Shard ``state``'s model, optimizer state and EMA as the grid
        asks (``--fsdp`` over dp, the MoE experts over ep, the tensor-
        parallel leaves over mp): returns the ``ParamShards`` (kept as
        ``self.shards``, which the train steps read), or None when nothing
        shards.'''
        from bmt_tpu_torch.parallel.sharding_rules import (FSDP_MIN_ELEMS,
                                                           ParamShards)
        self.shards = None
        if not ((self.fsdp and self.n_dp > 1) or self.n_ep > 1
                or self.n_mp > 1):
            return None
        self.shards = ParamShards(
            state, self, self.fsdp,
            FSDP_MIN_ELEMS if min_elems is None else min_elems)
        return self.shards

    def whole(self, everything: bool = False):
        '''A context in which the ``--fsdp`` leaves, the mp blocks and the
        EMA are whole on every rank (for validation), and with
        ``everything`` the MoE experts and the optimizer's moments too (for
        checkpoints and resumes); on exit each rank keeps its shards again.
        A no-op when nothing is sharded. A collective: every rank enters
        it.'''
        if self.shards is None:
            return contextlib.nullcontext()
        return self.shards.whole(everything)

    def decode(self, fn, model, stacks: dict) -> torch.Tensor:
        '''fn(model, stacks) over this rank's rows, gathered in row order on
        every rank; the whole batch when its rows do not split evenly.
        A sampler draws the global batch's noise (``row_blocks``).'''
        B = _leading(stacks)
        local = self.maybe_shard(stacks)
        if local is stacks or self.n_dp == 1:
            return fn(model, local)
        out = row_blocks(fn)(model, local, (self.local_rows(B)[0], B))
        return self.gather_rows(out)


def sum_grads(params, group: Group) -> None:
    '''Sum every parameter's ``.grad`` over ``group``, in place: one
    all-reduce of a flat buffer per dtype; a parameter without a gradient
    joins as zeros.'''
    if group.size == 1:
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = group.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        torch._foreach_copy_(grads, [
            chunk.view_as(g) for chunk, g in zip(
                flat.split([g.numel() for g in grads]), grads)])


class ReduceFromGroup(torch.autograd.Function):
    '''y = sum over ``group`` of x; the backward passes dL/dy through
    unchanged, since every rank holds the same dL/dy of the sum (the
    Megatron "g" operator).'''

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToGroup(torch.autograd.Function):
    '''y = x, the same on every rank of ``group``; the backward sums the
    ranks' partial gradients (the Megatron "f" operator).'''

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


def row_blocks(fn):
    '''The decoder ``fn(model, stacks)`` of one batch split into row
    blocks: part(model, block, rows), ``rows`` = (lo, B) placing the block
    in the B-row batch. A sampler (``decode.sample``, ``fn.for_batch``)
    takes its call number here, once a batch on the caller's thread, and
    each block draws its rows of the batch's noise, so the split batch
    samples the undivided one's captions; other decoders decode a block as
    a batch of its own.'''
    bind = getattr(fn, 'for_batch', None)
    if bind is not None:
        return bind()
    return lambda model, block, rows: fn(model, block)


def decode_parallel(n: Optional[int], device):
    '''The data parallelism of a decode-only run (evaluate, the acceptance
    chain) over ``n`` ways: the process group's ``DataParallel`` when one
    is up, else ``n`` local replicas (``LocalReplicas`` over
    ``replica_devices``), None for one way.'''
    n = n or 1
    if dist.is_initialized():
        dp = DataParallel(n, device)
        return dp if dp.size > 1 else None
    return LocalReplicas(replica_devices(n, device)) if n > 1 else None


def replica_devices(n: int, device='cuda') -> list:
    '''``n`` local devices for ``LocalReplicas``: the first ``n`` cards
    (fewer raise, naming both counts), or the CPU ``n`` times.'''
    device = torch.device(device)
    if device.type != 'cuda':
        return [device] * n
    check_cards(n, 'nccl')
    return [torch.device('cuda', i) for i in range(n)]


class LocalReplicas:
    '''Replicas of a model on ``devices`` (repeats allowed: two replicas may
    share a card when the caller names it so), in one process. ``decode``
    splits a batch's rows into ``n_dp`` equal blocks, runs each block's
    decode on its replica in a thread of its own (on a CUDA stream of its
    own) and joins the tokens in row order on the CPU.'''

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.n_dp = self.size = len(self.devices)
        self._models: list = []
        self._source = None
        self._streams = [torch.cuda.Stream(d) if d.type == 'cuda' else None
                         for d in self.devices]

    def replicas(self, model) -> list:
        '''The replicas of ``model``, made on first use: ``model`` itself on
        the first device when it lives there, copies elsewhere.'''
        if self._source is not model:
            first = next(model.parameters()).device
            self._models = [
                model if i == 0 and first == d
                else copy.deepcopy(model).to(d)
                for i, d in enumerate(self.devices)]
            self._source = model
        return self._models

    def decode(self, fn, model, stacks: dict) -> torch.Tensor:
        '''fn(replica, block) over the replicas, tokens joined on the CPU;
        a batch whose rows do not split evenly runs whole on the first
        replica.'''
        models = self.replicas(model)
        B = _leading(stacks)
        if B % self.n_dp:
            with torch.inference_mode():
                return fn(models[0], {k: v.to(self.devices[0])
                                      for k, v in stacks.items()}).cpu()
        n = B // self.n_dp
        part = row_blocks(fn)
        out, errors = [None] * self.n_dp, []

        def work(i):
            try:
                dev, stream = self.devices[i], self._streams[i]
                if stream is not None:
                    # the batch was made on the device's default stream
                    stream.wait_stream(torch.cuda.default_stream(dev))
                with torch.inference_mode(), (
                        torch.cuda.stream(stream) if stream is not None
                        else contextlib.nullcontext()):
                    block = {k: v[i * n:(i + 1) * n].to(dev)
                             for k, v in stacks.items()}
                    out[i] = part(models[i], block, (i * n, B)).cpu()
            except BaseException as e:          # re-raised by the caller
                errors.append(e)
        if self.n_dp == 1:
            work(0)
        else:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(self.n_dp)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        return torch.cat(out)
