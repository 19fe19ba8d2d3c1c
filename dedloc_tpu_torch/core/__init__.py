from dedloc_tpu_torch.core.timeutils import get_dht_time, DHTExpiration, PerformanceEMA
from dedloc_tpu_torch.core.serialization import (
    CompressionType,
    serialize_array,
    deserialize_array,
    serialize_tree,
    deserialize_tree,
)
from dedloc_tpu_torch.core.config import Registry
