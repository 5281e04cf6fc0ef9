"""Drawing helpers of the port, the counterpart of `sfa3d_tpu/viz/draw.py`:
the 3D cuboid projection and drawing, the RGB + BEV composite, the rotated
BEV boxes, the credit overlay, and the BEV panel the CLIs draw on
(`bev_panel_image`, `draw_bev_panel`). Every cv2 call of the JAX module goes
through `viz/raster.py` with the same arguments; images are uint8 (H, W, 3)
BGR, drawn in place.
"""

from __future__ import annotations

import numpy as np

from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.viz import raster


def roty(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def compute_box_3d(dim, location, ry) -> np.ndarray:
    """Camera-frame 8 corners, box origin at the bottom centre."""
    h, w, l = dim
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [0, 0, 0, 0, -h, -h, -h, -h]
    z = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = roty(ry) @ np.array([x, y, z], dtype=np.float32)
    return (corners + np.asarray(location, np.float32).reshape(3, 1)).T


def project_to_image(pts_3d: np.ndarray, P: np.ndarray) -> np.ndarray:
    """(N, 3) camera points -> (N, 2) int32 pixels (truncated toward zero; a
    point on or behind the camera plane gives numpy's cast of inf / nan)."""
    homo = np.concatenate([pts_3d, np.ones((len(pts_3d), 1), np.float32)], axis=1)
    uv = (np.asarray(P) @ homo.T).T
    return (uv[:, :2] / uv[:, 2:]).astype(np.int32)


def draw_box_3d(image, corners, color=(0, 0, 255)):
    """12-edge cuboid with a cross on the front face (anti-aliased)."""
    face_idx = [[0, 1, 5, 4], [1, 2, 6, 5], [2, 3, 7, 6], [3, 0, 4, 7]]
    corners = corners.astype(np.int32)
    for ind_f in range(3, -1, -1):
        f = face_idx[ind_f]
        for j in range(4):
            raster.line(image, tuple(corners[f[j], :2]), tuple(corners[f[(j + 1) % 4], :2]),
                        color, 2, lineType=raster.LINE_AA)
        if ind_f == 0:
            raster.line(image, tuple(corners[f[0], :2]), tuple(corners[f[2], :2]),
                        color, 1, lineType=raster.LINE_AA)
            raster.line(image, tuple(corners[f[1], :2]), tuple(corners[f[3], :2]),
                        color, 1, lineType=raster.LINE_AA)
    return image


def show_rgb_image_with_boxes(img, labels, calib):
    """Draw metric camera-frame boxes on the camera image, skipping objects
    closer than 2 m. `labels` rows: [cls, x, y, z, h, w, l, ry]."""
    for label in labels:
        cls_id = int(label[0])
        location, dim, ry = label[1:4], label[4:7], label[7]
        if location[2] < 2.0 or cls_id < 0:
            continue
        corners_2d = project_to_image(compute_box_3d(dim, location, ry), calib.P2)
        img = draw_box_3d(img, corners_2d, color=cnf.colors[cls_id % len(cnf.colors)])
    return img


def merge_rgb_to_bev(img_rgb, img_bev, output_width: int):
    """Vertical camera-over-BEV composite, both resized to `output_width`."""
    rh, rw = img_rgb.shape[:2]
    out_rh = int(output_width / rw * rh)
    top = raster.resize(img_rgb, (output_width, out_rh))
    bh, bw = img_bev.shape[:2]
    out_bh = int(output_width / bw * bh)
    bottom = raster.resize(img_bev, (output_width, out_bh))
    out = np.zeros((out_rh + out_bh, output_width, 3), np.uint8)
    out[:out_rh] = top
    out[out_rh:] = bottom
    return out


def get_corners_bev(x, y, w, l, yaw) -> np.ndarray:
    """Rotated-box corners in BEV pixels, float32."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array(
        [
            [x - w / 2 * c - l / 2 * s, y - w / 2 * s + l / 2 * c],
            [x - w / 2 * c + l / 2 * s, y - w / 2 * s - l / 2 * c],
            [x + w / 2 * c + l / 2 * s, y + w / 2 * s - l / 2 * c],
            [x + w / 2 * c - l / 2 * s, y + w / 2 * s + l / 2 * c],
        ],
        dtype=np.float32,
    )


def draw_rotated_box(img, x, y, w, l, yaw, color):
    """The box's closed outline plus its heading edge highlighted."""
    corners = get_corners_bev(x, y, w, l, yaw).astype(int)
    raster.polylines(img, [corners.reshape(-1, 1, 2)], True, color, 2)
    raster.line(img, tuple(corners[0]), tuple(corners[3]), (255, 255, 0), 2)
    return img


def bev_map_to_image(bev_hwc: np.ndarray) -> np.ndarray:
    """(H, W, 3) float BEV raster -> uint8 image ready for drawing (channel
    0 intensity -> B, 1 height -> G, 2 density -> R)."""
    img = (np.asarray(bev_hwc) * 255).astype(np.uint8)
    return np.ascontiguousarray(img)


def write_credit(img, org_author=(500, 400), text_author="github.com/maudzung",
                 org_fps=(50, 1000), fps=None):
    """Credit + FPS text overlay on demo frames."""
    font, scale, color, thick = raster.FONT_HERSHEY_SIMPLEX, 1, (255, 255, 255), 2
    raster.put_text(img, text_author, org_author, font, scale, color, thick, raster.LINE_AA)
    if fps is not None:
        raster.put_text(img, "Speed: {:.1f} FPS".format(fps), org_fps, font, scale, color, thick,
                        raster.LINE_AA)
    return img


def draw_predictions_bev(bev_img: np.ndarray, boxes_bev: np.ndarray, mask: np.ndarray):
    """Draw decoded detections on the BEV image. `boxes_bev` rows:
    [cls, score, x, y, z, h, w, l, yaw] in BEV pixels."""
    for row, ok in zip(np.asarray(boxes_bev), np.asarray(mask)):
        if not ok:
            continue
        cls, _score, x, y, _z, _h, w, l, yaw = row
        draw_rotated_box(bev_img, x, y, w, l, yaw, cnf.colors[int(cls) % len(cnf.colors)])
    return bev_img


def bev_panel_image(bev_hwc: np.ndarray) -> np.ndarray:
    """The raster as the BEV image the CLIs draw on, at the BEV size."""
    return raster.resize(bev_map_to_image(bev_hwc), (cnf.BEV_WIDTH, cnf.BEV_HEIGHT))


def draw_bev_panel(bev_hwc: np.ndarray, boxes_bev: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """The detections drawn on the BEV image, turned 180 degrees (the
    `test` and `demo` CLIs' panel)."""
    img = bev_panel_image(bev_hwc)
    draw_predictions_bev(img, boxes_bev, mask)
    return raster.rotate_180(img)
