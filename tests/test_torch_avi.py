"""The port's MJPEG AVI writer and reader (`sfa3d_tpu_torch/data/avi.py`)
against cv2's video I/O (FFmpeg backend).

Tolerances: none. cv2.VideoCapture opens the port's file with the right
frame count, rate and size, and the frames it stores are the encoder's
bytes; the frames of a cv2.VideoWriter MJPG file come back through
`read_avi_frames` and decode as `cv2.imdecode` decodes the same bytes (not
as VideoCapture does: FFmpeg's own IDCT rounds otherwise).
"""

import cv2
import numpy as np
import pytest

from sfa3d_tpu_torch.data.avi import AviMjpegWriter, read_avi_frames, read_avi_info
from sfa3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) % 256], axis=-1)
    return [np.clip(base + rng.integers(-3, 4, (h, w, 3)) + 9 * i, 0, 255).astype(np.uint8) for i in range(n)]


@pytest.mark.parametrize("size", [(48, 64), (37, 53)])
def test_port_file_opens_in_cv2(tmp_path, size):
    h, w = size
    frames = _frames(5, h, w)
    path = str(tmp_path / "port.avi")
    with AviMjpegWriter(path, 30, (w, h)) as writer:
        for f in frames:
            writer.write(f)
    cap = cv2.VideoCapture(path)
    assert cap.isOpened()
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5 and cap.get(cv2.CAP_PROP_FPS) == 30.0
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        assert frame.shape == (h, w, 3)
        n += 1
    cap.release()
    assert n == 5
    stored = read_avi_frames(path)
    assert stored == [encode_jpeg(f) for f in frames]
    assert read_avi_info(path) == {"width": w, "height": h, "fps": 30.0, "compression": "MJPG", "frames": 5}
    for f, data in zip(frames, stored):
        assert 30 < 10 * np.log10(255.0 ** 2 / np.mean((decode_jpeg(data).astype(float) - f) ** 2))


def test_cv2_file_reads_back_through_the_port(tmp_path):
    frames = _frames(4, 48, 64, seed=1)
    path = str(tmp_path / "cv2.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30, (64, 48))
    for f in frames:
        writer.write(f)
    writer.release()
    stored = read_avi_frames(path)
    assert len(stored) == 4
    info = read_avi_info(path)
    assert (info["width"], info["height"], info["compression"], info["frames"]) == (64, 48, "MJPG", 4)
    for data in stored:
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = decode_jpeg(data)
        assert got.shape == (48, 64, 3)
        np.testing.assert_array_equal(got, want)


def test_writer_refuses_a_frame_of_another_size(tmp_path):
    writer = AviMjpegWriter(str(tmp_path / "a.avi"), 30, (64, 48))
    with pytest.raises(ValueError, match="frame of 63 x 48"):
        writer.write(np.zeros((48, 63, 3), np.uint8))
    writer.release()
    with pytest.raises(ValueError, match="released"):
        writer.write(np.zeros((48, 64, 3), np.uint8))
    assert read_avi_frames(str(tmp_path / "a.avi")) == []
