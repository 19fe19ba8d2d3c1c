from dedloc_tpu_torch.averaging.partition import (
    TreeLayout,
    flatten_tree,
    partition_weighted,
    unflatten_tree,
)
from dedloc_tpu_torch.averaging.allreduce import GroupAllReduce, AllreduceFailed
from dedloc_tpu_torch.averaging.matchmaking import Matchmaking, GroupInfo
from dedloc_tpu_torch.averaging.topology import (
    CliquePlan,
    TopologyPlan,
    clique_groups,
    plan_from_groups,
    plan_topology,
)
from dedloc_tpu_torch.averaging.averager import DecentralizedAverager
from dedloc_tpu_torch.averaging.device_flat import (
    DeviceFlatPipeline,
    FlatFetch,
    named_device_leaves,
)
