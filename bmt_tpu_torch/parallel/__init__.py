'''Parallelism (counterpart of ``bmt_tpu.parallel``): data, sequence
(``seq``) and expert parallelism over a ``dp x sp x ep`` grid of a
``torch.distributed`` group (``DataParallel``), ZeRO-3 over dp
(``sharding_rules``), and data parallelism over model replicas in one
process (``LocalReplicas``). Tensor and pipeline parallelism are not ported
yet (ROADMAP queue 1 item 11).'''
from bmt_tpu_torch.parallel.mesh import (DataParallel, LocalReplicas,
                                         check_cards, decode_parallel,
                                         default_backend,
                                         maybe_init_distributed,
                                         rank_device, replica_devices)

__all__ = ['DataParallel', 'LocalReplicas', 'check_cards', 'decode_parallel',
           'default_backend',
           'maybe_init_distributed', 'rank_device', 'replica_devices']
