"""The 2D camera-detection split for training YOLOv8, the port of
`sfa3d_tpu/data/yolo2d.py`: KITTI-layout camera frames (image_2 PNGs) and
label_2 2D boxes -> dense fixed-shape arrays that live on the device for
the whole run (`parallel/yolo_step.py` gathers its batches there).

Every frame letterboxes to one (h, w) of stride-32 multiples (the default
(192, 640) fits a 375 x 1242 KITTI frame with almost no padding), and the
ground truth pads to `max_boxes` slots with a validity mask. PNGs are read
by `data/png.py` and resized by cv2's uint8 INTER_LINEAR arithmetic
(`models/yolov8.py::_resize_uint8`), so the arrays equal the JAX loader's
bit for bit.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from sfa3d_tpu_torch.data.kitti import read_label
from sfa3d_tpu_torch.data.png import read_png_rgb
from sfa3d_tpu_torch.models.yolov8 import _resize_uint8

ImgSize = Union[int, Tuple[int, int]]


def as_hw(imgsz: ImgSize) -> Tuple[int, int]:
    """int -> (s, s); (h, w) passes through. Both must be multiples of 32
    (the stride of the P5 feature map)."""
    hw = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    if len(hw) != 2 or any(int(s) % 32 for s in hw):
        raise ValueError(f"imgsz must be stride-32 multiples, got {imgsz}")
    return int(hw[0]), int(hw[1])


def letterbox_rect(img: np.ndarray, hw: Tuple[int, int]):
    """Resize with the aspect kept and centre-pad with 114 to (h, w).
    uint8 in, uint8 out. Returns (canvas (h, w, 3), scale, (pad_x, pad_y))."""
    th, tw = hw
    h, w = img.shape[:2]
    r = min(th / h, tw / w)
    nw, nh = round(w * r), round(h * r)
    if (nw, nh) != (w, h):
        img = _resize_uint8(img, nh, nw)
    pad_x, pad_y = (tw - nw) // 2, (th - nh) // 2
    canvas = np.full((th, tw, 3), 114, np.uint8)
    canvas[pad_y:pad_y + nh, pad_x:pad_x + nw] = img
    return canvas, r, (pad_x, pad_y)


def list_sample_ids(root: str):
    """The ids of every frame with a label file under root/training/label_2."""
    lab_dir = os.path.join(root, "training", "label_2")
    return sorted(int(f.split(".")[0]) for f in os.listdir(lab_dir) if f.endswith(".txt"))


def load_yolo2d_split(
    root: str,
    split: str = "train",
    imgsz: ImgSize = (192, 640),
    max_boxes: int = 32,
    sample_ids: Optional[Sequence[int]] = None,
    min_box_px: float = 2.0,
) -> Dict[str, np.ndarray]:
    """KITTI-layout `root/training/{image_2,label_2}` -> dense arrays:

      images (N, h, w, 3) uint8 letterboxed RGB
      boxes  (N, G, 4) float32 xyxy in letterboxed pixels
      labels (N, G) int32 class ids (0 = Pedestrian, 1 = Car, 2 = Cyclist)
      mask   (N, G) bool valid slots
      ids    (N,) int32 sample ids

    Rows with a negative class id (DontCare and the rest) and boxes under
    `min_box_px` after the letterbox are dropped. `split` is not read: with
    `sample_ids` None every frame with a label file is taken."""
    del split
    hw = as_hw(imgsz)
    img_dir = os.path.join(root, "training", "image_2")
    lab_dir = os.path.join(root, "training", "label_2")
    if sample_ids is None:
        sample_ids = list_sample_ids(root)
    n = len(sample_ids)
    images = np.zeros((n, hw[0], hw[1], 3), np.uint8)
    boxes = np.zeros((n, max_boxes, 4), np.float32)
    labels = np.zeros((n, max_boxes), np.int32)
    mask = np.zeros((n, max_boxes), bool)
    for i, sid in enumerate(sample_ids):
        path = os.path.join(img_dir, f"{sid:06d}.png")
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        canvas, r, (px, py) = letterbox_rect(read_png_rgb(path), hw)
        images[i] = canvas
        k = 0
        for obj in read_label(os.path.join(lab_dir, f"{sid:06d}.txt")):
            if obj.cls_id < 0 or k >= max_boxes:
                continue
            x1, y1, x2, y2 = obj.box2d * r
            x1, x2 = x1 + px, x2 + px
            y1, y2 = y1 + py, y2 + py
            if (x2 - x1) < min_box_px or (y2 - y1) < min_box_px:
                continue
            boxes[i, k] = (x1, y1, x2, y2)
            labels[i, k] = obj.cls_id
            mask[i, k] = True
            k += 1
    return {
        "images": images,
        "boxes": boxes,
        "labels": labels,
        "mask": mask,
        "ids": np.asarray(list(sample_ids), np.int32),
    }
