"""The input pipeline (the port's ``byteps_tpu/data``): host→device
prefetch and the elastic shard map."""

from byteps_tpu_torch.data.elastic import (
    ElasticShardMap,
    live_ids_from_bitmap,
)
from byteps_tpu_torch.data.loader import (
    PrefetchLoader,
    shard_batch,
)

__all__ = ["ElasticShardMap", "PrefetchLoader", "live_ids_from_bitmap",
           "shard_batch"]
