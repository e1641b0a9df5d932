"""Multi-device plans on a mesh of torch devices, held by one process
(counterpart of ``flex_tpu.parallel``)."""
from flex_tpu_torch.parallel.gcn_sharded import (
    make_train_step_2d, shard_params_2d,
)
from flex_tpu_torch.parallel.mesh import Mesh, make_mesh
from flex_tpu_torch.parallel.spmm_sharded import (
    ShardedEllPlan, prepare_ell_sharded,
)
from flex_tpu_torch.parallel.window_sharded import (
    ShardedWindowedPlan, prepare_windowed_sharded,
)

__all__ = [
    "Mesh", "make_mesh", "ShardedEllPlan", "prepare_ell_sharded",
    "ShardedWindowedPlan", "prepare_windowed_sharded", "shard_params_2d",
    "make_train_step_2d",
]
