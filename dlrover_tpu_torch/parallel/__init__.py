"""Strategy, its planner auto_strategy, the measured search
(parallel/engine.py), and auto_accelerate, which makes the train step
(with remat, parallel/remat.py); the mesh (a DeviceMesh over a process
group, a seq axis one rank a process on it or held whole in process),
the logical rule table's placements and manual tensor parallelism
(parallel/manual_tp.py), the seq axis' ring and Ulysses attention, and
the MoE FFN (parallel/moe.py)."""

from dlrover_tpu_torch.parallel.accelerate import (  # noqa: F401
    AccelerateResult,
    TrainState,
    auto_accelerate,
)
from dlrover_tpu_torch.parallel.engine import (  # noqa: F401
    DryRunner,
    DryRunResult,
    ModelAnalysis,
    StrategySearchEngine,
    analyse_params,
    candidate_strategies,
    estimate_hbm_per_device,
    search_strategy,
)
from dlrover_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    axis_index,
    axis_size,
    batch_place,
    build_mesh,
    get_mesh,
    set_mesh,
)
from dlrover_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    sequence_sharded_attention,
    ulysses_attention,
)
from dlrover_tpu_torch.parallel.shard_ops import (  # noqa: F401
    ShardContext,
)
from dlrover_tpu_torch.parallel.sharding import (  # noqa: F401
    distribute_logical,
    logical_placements,
    logical_to_mesh_axes,
    shard_logical,
    tree_logical_placements,
)
from dlrover_tpu_torch.parallel.strategy import (  # noqa: F401
    MeshConfig,
    Strategy,
    auto_strategy,
)
