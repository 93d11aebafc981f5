'''CUDA graphs of train steps: the card's counterpart of a ``lax.scan``
dispatch of K steps (``train.steps.make_multistep``).

``StepGraphs`` keeps a ``TrainState``'s graphs, one for each (step, batch
geometry), all in one memory pool. A geometry's first batch warms up: the
step runs eagerly on the graphs' side stream (lazy initialisation, the
optimizer's moments, cuBLAS's workspace for that stream) and records where
each remat block's dropout draws start. Its second batch captures the
step's body (``TrainStep.body``) into a graph whose inputs are buffers of
the geometry's shapes; the graph is then replayed for that batch and every
later one:

1. the batch is copied into the input buffers from pinned host memory, and
   under threefry the step's key with it (``'rng'``, from the host's step
   count): the dropout kernels read the key from that buffer, so a replay
   draws the step's own masks, and a remat block's recompute draws its
   first run's (the key is the same; no state moves);
2. under rbg the dropout generator, and a generator for each remat block's
   recompute (``ops.layers.RematStarts``), are reseeded to
   ``step.seed(state)``, each registered with the graph, so a replay draws
   the masks of the eager step at the same (seed, step, rank);
3. the graph is replayed: the forward, the backward and the optimizer
   update, the learning rate of the device-held update count read from
   the optimizer's rate table;
4. the metrics are cloned out of the graph's outputs, and the host's counts
   advance: ``state.step``, ``optimizer.calls``, and the attention
   kernels' launch counts by the launches the capture recorded.

A graph holds the addresses of the state's tensors: the parameters, the
optimizer's moments and counters, the EMA. Loading a checkpoint into the
state after a capture copies into them (``train.checkpoint``); a replay
checks that none was rebound and raises if one was. Everything the body
allocates comes from the pool, and nothing of it outlives a replay but the
metrics, which are cloned at once: the graphs of other geometries reuse
that memory for their own work.
'''
from __future__ import annotations

import dataclasses
from time import perf_counter
from typing import Optional

import numpy as np
import torch

from bmt_tpu_torch.ops import launches as kernel_launches
from bmt_tpu_torch.ops.layers import RematStarts, remat_starts


@dataclasses.dataclass
class _Graph:
    '''One geometry's graph: its remat starts, then (once captured) the
    graph, its input buffers, its outputs and the kernel launches the
    capture recorded.'''
    starts: RematStarts
    graph: Optional[torch.cuda.CUDAGraph] = None
    inputs: Optional[dict] = None
    outputs: Optional[dict] = None
    launches: Optional[dict] = None


def _geometry(step, host: dict) -> tuple:
    return (id(step), step.key) + tuple(
        (k, v.shape, v.dtype.str) for k, v in sorted(host.items()))


class StepGraphs:
    '''The CUDA graphs of one train state's steps on ``device``: one a
    (step, batch geometry), sharing one memory pool, captured and replayed
    on one side stream's terms (module docstring). ``captured``,
    ``replayed`` and ``warmed`` count graphs captured, replays and warm-up
    steps; ``capture_s`` is the host seconds spent capturing;
    ``pool_mib()`` the MiB the pool holds.'''

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.entries: dict = {}
        self.captured = self.replayed = self.warmed = 0
        self.capture_s = 0.0
        self._addresses = None

    def run(self, step, state, batch: dict) -> dict:
        '''One train step of ``state`` on ``batch``; its metrics.'''
        host = step.host_inputs(batch, state)
        key = _geometry(step, host)
        entry = self.entries.get(key)
        if entry is None:
            self.entries[key] = entry = _Graph(RematStarts())
            return self._warm_up(step, state, batch, entry)
        if entry.graph is None:
            self._capture(step, state, host, entry)
        return self._replay(step, state, host, entry)

    def _warm_up(self, step, state, batch, entry) -> dict:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream), remat_starts(entry.starts):
            state, metrics = step(state, batch)
        current.wait_stream(self.stream)
        self.warmed += 1
        return metrics

    def _capture(self, step, state, host, entry) -> None:
        entry.inputs = {k: torch.empty(v.shape, device=self.device,
                                       dtype=torch.from_numpy(v[:0]).dtype)
                        for k, v in host.items()}
        graph = torch.cuda.CUDAGraph()
        if state.generator is not None:
            graph.register_generator_state(state.generator)
            for g in entry.starts.make_generators(state.generator):
                graph.register_generator_state(g)
        launches, calls = kernel_launches.counts(), state.optimizer.calls
        t0 = perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  stream=self.stream), \
                    remat_starts(entry.starts):
                entry.outputs = step.body(state, entry.inputs)
        except Exception as e:
            raise RuntimeError(
                f'capturing the train step in a CUDA graph failed (batch '
                f'geometry {sorted((k, v.shape) for k, v in host.items())})'
                f': {type(e).__name__}: {e}') from e
        self.capture_s += perf_counter() - t0
        # the capture ran the step's Python once and launched nothing: its
        # counts are the replay's to add
        after = kernel_launches.counts()
        entry.launches = {k: after[k] - launches[k] for k in after}
        kernel_launches.add({k: -n for k, n in entry.launches.items()})
        state.optimizer.calls = calls
        entry.graph = graph
        if self._addresses is None:
            self._addresses = self._state_addresses(state)
        self.captured += 1

    def _replay(self, step, state, host, entry) -> dict:
        if self._state_addresses(state) != self._addresses:
            raise RuntimeError(
                'a tensor of the train state was rebound after its CUDA '
                'graphs were captured (a load must copy_ into the '
                'parameters, moments and EMA): the graphs would update the '
                'old tensors')
        for k, buf in entry.inputs.items():
            pinned = torch.from_numpy(np.ascontiguousarray(host[k]))
            buf.copy_(pinned.pin_memory(), non_blocking=True)
        if state.generator is not None:
            seed = step.seed(state)
            state.generator.manual_seed(seed)
            entry.starts.reseed(seed)
        entry.graph.replay()
        state.step += 1
        state.optimizer.calls += 1
        kernel_launches.add(entry.launches)
        self.replayed += 1
        return {k: v.clone() for k, v in entry.outputs.items()}

    @staticmethod
    def _state_addresses(state) -> tuple:
        opt = state.optimizer
        tensors = list(state.model.parameters()) + opt.device_state()
        for p in opt.params:
            tensors += [v for v in opt.inner.state.get(p, {}).values()
                        if isinstance(v, torch.Tensor)]
        if state.ema is not None:
            tensors += list(state.ema.values())
        return tuple(t.data_ptr() for t in tensors)

    def pool_mib(self) -> float:
        '''The MiB of the segments that the graphs' pool holds.'''
        pool = tuple(self.pool)
        return sum(seg['total_size'] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get('segment_pool_id', ())) == pool) / 2**20

    def report(self) -> dict:
        return {'graphs': self.captured, 'replays': self.replayed,
                'warm_up_steps': self.warmed,
                'capture_s': round(self.capture_s, 3),
                'pool_mib': round(self.pool_mib(), 1)}
