"""The port's 2D camera-detection split (`data/yolo2d.py`) against the JAX
package's on the CPU: `as_hw`, `letterbox_rect` (cv2's INTER_LINEAR,
exact) and `load_yolo2d_split` on a mini-KITTI that the JAX package wrote
with cv2 (images, boxes, labels, mask and ids exact), and on the port's
own mini-KITTI (the same boxes as JAX's reader of those files)."""

import numpy as np
import pytest

from sfa3d_tpu.data import synthetic as jsynthetic
from sfa3d_tpu.data import yolo2d as jyolo2d
from sfa3d_tpu_torch.data import synthetic, yolo2d


@pytest.fixture(scope="module")
def jax_mini_kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolo2d") / "kitti"
    return jsynthetic.write_mini_kitti(str(root), n_frames=3, seed=2)


def test_as_hw_matches_jax():
    for imgsz in (640, (192, 640), [96, 320]):
        assert yolo2d.as_hw(imgsz) == jyolo2d.as_hw(imgsz)
    for bad in (100, (192, 630), (1, 2, 3)):
        with pytest.raises(ValueError):
            yolo2d.as_hw(bad)


@pytest.mark.parametrize("src,hw", [((375, 1242), (192, 640)), ((375, 1242), (96, 320)), ((120, 90), (64, 64)),
                                    ((30, 50), (64, 128)), ((192, 640), (192, 640))])
def test_letterbox_rect_equals_jax(src, hw):
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3)).astype(np.uint8)
    got, r, pad = yolo2d.letterbox_rect(img, hw)
    want, wr, wpad = jyolo2d.letterbox_rect(img, hw)
    assert (r, pad) == (wr, wpad) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,max_boxes", [((192, 640), 32), ((96, 320), 4)])
def test_split_equals_jax_on_jax_written_frames(jax_mini_kitti, hw, max_boxes):
    """cv2 wrote these PNGs (BGR in, RGB on disk); the JAX loader reads them
    with cv2.imread + cvtColor, the port with data/png.py."""
    ids = [2, 0]
    want = jyolo2d.load_yolo2d_split(jax_mini_kitti, imgsz=hw, max_boxes=max_boxes, sample_ids=ids)
    got = yolo2d.load_yolo2d_split(jax_mini_kitti, imgsz=hw, max_boxes=max_boxes, sample_ids=ids)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["mask"].sum() > 2
    everything = yolo2d.load_yolo2d_split(jax_mini_kitti, imgsz=hw, max_boxes=max_boxes)
    assert everything["ids"].tolist() == [0, 1, 2]


def test_split_of_port_written_frames(tmp_path):
    root = synthetic.write_mini_kitti(str(tmp_path / "k"), n_frames=2, seed=2)
    got = yolo2d.load_yolo2d_split(root, imgsz=(192, 640))
    want = jyolo2d.load_yolo2d_split(root, imgsz=(192, 640))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
