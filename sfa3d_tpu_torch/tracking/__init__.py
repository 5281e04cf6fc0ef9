"""3D multi-object tracking of the port (see tracker.py)."""

from sfa3d_tpu_torch.tracking.metrics import (  # noqa: F401
    clear_mot,
    tracker_output_to_frames,
)
from sfa3d_tpu_torch.tracking.tracker import (  # noqa: F401
    TrackState,
    init_tracks,
    track_sequence,
    tracker_step,
)
