"""The training and eval steps of the port, on one device."""

from sfa3d_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    create_train_state,
    ema_decay_at,
    make_eval_step,
    make_train_step,
)
