'''Parallelism (counterpart of ``bmt_tpu.parallel``): data, sequence
(``seq``), expert and tensor (``tensor``) parallelism over a ``dp x sp x ep
x mp`` grid of a ``torch.distributed`` group (``DataParallel``), ZeRO-3
over dp and the cut of the mp and ep leaves (``sharding_rules``), pipeline
parallelism over a group of its own (``pipeline``), and data parallelism
over model replicas in one process (``LocalReplicas``). The multi-chip dry
run is ``scripts.dryrun_multichip`` with its two-process worker
``dryrun_dist``.

``sharding_rules`` and ``pipeline`` import the model's layers, which import
``parallel.tensor``, so their names are imported from those modules.'''
from bmt_tpu_torch.parallel.mesh import (DataParallel, LocalReplicas,
                                         check_cards, decode_parallel,
                                         default_backend,
                                         maybe_init_distributed,
                                         rank_device, replica_devices)
from bmt_tpu_torch.parallel.seq import sequence_parallel
from bmt_tpu_torch.parallel.tensor import (ColumnParallelLinear,
                                           RowParallelLinear)

__all__ = ['ColumnParallelLinear', 'DataParallel', 'LocalReplicas',
           'RowParallelLinear', 'check_cards', 'decode_parallel',
           'default_backend', 'maybe_init_distributed', 'rank_device',
           'replica_devices', 'sequence_parallel']
