from .distributed import init_distributed
from .mesh import (SCENARIO_AXES, Mesh, gather_scenarios, pad_to_mesh,
                   scenario_mesh, scenario_sharding, shard_scenarios,
                   sharded_mean_var)
