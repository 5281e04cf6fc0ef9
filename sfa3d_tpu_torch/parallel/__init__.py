"""The training and eval steps of the port, on one device or data-parallel
over the ranks of a `torch.distributed` process group (`parallel/mesh.py`),
with the rows split over a 'spatial' axis too (`make_mesh_2d`)."""

from sfa3d_tpu_torch.parallel.mesh import (  # noqa: F401
    SPATIAL_AXIS,
    make_mesh,
    make_mesh_2d,
    maybe_init_distributed,
    replicate,
    shard_batch,
    shard_rows,
)
from sfa3d_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    ema_decay_at,
    make_eval_step,
    make_train_step,
)
