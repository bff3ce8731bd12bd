"""Input paths: the device-resident synthetic table and the streaming path.

- :mod:`.synthetic` — the seeded token table (every arm's default, no IO);
- :mod:`.stream` — the fault-tolerant sharded record reader (checksummed
  records, skip-and-quarantine, bounded retry, exact-resume cursor);
- :mod:`.prefetch` — the bounded host prefetcher: each rank's rows into a
  pinned buffer and onto the card on a copy stream, with the measured wait
  behind ``data_stall_frac``;
- :mod:`.make_shards` — the shard generator
  (``python -m distributed_llm_training_benchmark_framework_tpu_torch.data.make_shards``).
"""

from .prefetch import DataStallTimeout, HostPrefetcher
from .stream import (
    EXIT_DATA_STALL,
    DataReadError,
    DataStalled,
    MissingShardError,
    ShardedTokenStream,
)
from .synthetic import SyntheticDataset, step_batch

__all__ = [
    "DataReadError",
    "DataStallTimeout",
    "DataStalled",
    "EXIT_DATA_STALL",
    "HostPrefetcher",
    "MissingShardError",
    "ShardedTokenStream",
    "SyntheticDataset",
    "step_batch",
]
