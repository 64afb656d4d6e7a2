"""Strategy and auto_accelerate, which makes the train step; the mesh
and its seq axis' ring attention."""

from dlrover_tpu_torch.parallel.accelerate import (  # noqa: F401
    AccelerateResult,
    TrainState,
    auto_accelerate,
)
from dlrover_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    axis_index,
    build_mesh,
    get_mesh,
    set_mesh,
)
from dlrover_tpu_torch.parallel.sequence import (  # noqa: F401
    ring_attention,
    sequence_sharded_attention,
)
from dlrover_tpu_torch.parallel.strategy import MeshConfig, Strategy  # noqa: F401
