"""The training and eval steps of the port, on one device or data-parallel
over the ranks of a `torch.distributed` process group (`parallel/mesh.py`)."""

from sfa3d_tpu_torch.parallel.mesh import make_mesh, maybe_init_distributed, replicate, shard_batch  # noqa: F401
from sfa3d_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    ema_decay_at,
    make_eval_step,
    make_train_step,
)
