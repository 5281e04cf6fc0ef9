"""Detection losses of the port (focal + masked L1 + balanced L1)."""

from sfa3d_tpu_torch.losses.losses import (  # noqa: F401
    balanced_l1_loss,
    compute_loss,
    focal_loss,
    gather_slots,
    masked_l1_loss,
)
