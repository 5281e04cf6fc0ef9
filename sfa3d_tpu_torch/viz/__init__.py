"""Host-side visualization of the port (numpy drawing through
`viz/raster.py`; no cv2, PIL or matplotlib).

Stays off the device by design: the detector hands back fixed-K masked box
arrays; everything here is presentation.
"""

from sfa3d_tpu_torch.viz.draw import (
    bev_map_to_image,
    draw_box_3d,
    draw_predictions_bev,
    draw_rotated_box,
    merge_rgb_to_bev,
    show_rgb_image_with_boxes,
)

__all__ = [
    "bev_map_to_image",
    "draw_box_3d",
    "draw_predictions_bev",
    "draw_rotated_box",
    "merge_rgb_to_bev",
    "show_rgb_image_with_boxes",
]
