"""The port's ORB (`sfa3d_tpu_torch/slam/orb.py`) and grey PNG read against
cv2, stage by stage, on the JAX writer's mini-KITTI stereo pair (375 x
1242) and on seeded textured images.

Required exact: the grey read (`cv2.imread(IMREAD_GRAYSCALE)`), the
pyramid (`cv2.resize(INTER_LINEAR_EXACT)` level from level), FAST corners
and scores (`cv2.FastFeatureDetector_create(20, True)`), fastAtan2, the
Gaussian taps, and the descriptors of cv2's own keypoints (`orb.detect`,
then the port's descriptor stage, against `orb.compute`): at least 99% of
keypoints, measured 100% on the fixture pair and on the textured images.
Reported, pinned at what was measured: the share of `detectAndCompute`'s
keypoints with an equal (x, y, octave) — 100% on every image here, in
cv2's order, with equal angles, responses, sizes and descriptors.
"""

import cv2
import numpy as np
import pytest
import torch

from sfa3d_tpu_torch.data.png import read_png_grey
from sfa3d_tpu_torch.slam import orb


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_pair(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_kitti

    root = write_mini_kitti(str(tmp_path_factory.mktemp("orb") / "kitti"), n_frames=1)
    return [f"{root}/training/image_{side}/000000.png" for side in (2, 3)]


def textured(seed, shape=(240, 320)):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (shape[0] // 4, shape[1] // 4)).astype(np.uint8)
    img = cv2.resize(img, shape[::-1], interpolation=cv2.INTER_CUBIC)
    return cv2.GaussianBlur(img, (3, 3), 0)


def test_read_png_grey_equals_cv2(fixture_pair, tmp_path):
    rng = np.random.default_rng(0)
    paths = list(fixture_pair)
    for i, shape in enumerate([(64, 96, 3), (37, 53, 3), (41, 29)]):
        p = str(tmp_path / f"{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, shape, dtype=np.uint8))
        paths.append(p)
    for p in paths:
        got = read_png_grey(p)
        assert got.dtype == np.uint8 and got.ndim == 2
        assert np.array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE)), p


def test_pyramid_equals_cv2_resize_linear_exact(fixture_pair):
    img = read_png_grey(fixture_pair[0])
    levels = orb.build_pyramid(torch.as_tensor(img))
    prev = img
    for level, (h, w) in enumerate(orb.level_sizes(*img.shape)):
        if level:
            prev = cv2.resize(prev, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)
        assert np.array_equal(levels[level].numpy(), prev), level
    # an upscale and odd sizes take the same taps
    small = textured(3, (37, 51))
    for h, w in ((53, 77), (20, 30), (37, 13)):
        got = orb.resize_linear_exact(torch.as_tensor(small), h, w).numpy()
        assert np.array_equal(got, cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)), (h, w)


@pytest.mark.parametrize("image", ["left-level0", "left-level2", "right-level0", "textured"])
def test_fast_equals_cv2(fixture_pair, image):
    if image == "textured":
        img = textured(5)
    else:
        img = read_png_grey(fixture_pair[0 if image.startswith("left") else 1])
        img = orb.build_pyramid(torch.as_tensor(img))[int(image[-1])].numpy()
    xs, ys, scores = orb.fast_corners(torch.as_tensor(img))
    want = cv2.FastFeatureDetector_create(20, True).detect(img)
    assert len(want) > 100
    assert [(k.pt[0], k.pt[1], k.response) for k in want] == list(
        zip(xs.astype(float).tolist(), ys.astype(float).tolist(), scores.astype(float).tolist()))


def test_fast_atan2_and_gaussian_taps_equal_cv2():
    rng = np.random.default_rng(1)
    y = np.concatenate([rng.integers(-40000, 40000, 3000), [0, 0, 5, -5, 0]]).astype(np.float32)
    x = np.concatenate([rng.integers(-40000, 40000, 3000), [0, 7, 0, 0, -7]]).astype(np.float32)
    got = orb.fast_atan2(y, x)
    want = np.array([cv2.fastAtan2(float(a), float(b)) for a, b in zip(y, x)], np.float32)
    assert np.array_equal(got, want)
    assert np.array_equal(orb.gaussian_taps(), cv2.getGaussianKernel(7, 2, ktype=cv2.CV_32F).ravel())
    assert orb.features_per_level(5000) == [1086, 905, 754, 628, 524, 436, 364, 303]


def _image(fixture_pair, name):
    return read_png_grey(fixture_pair[0 if name == "left" else 1]) if name in ("left", "right") else textured(9)


@pytest.mark.parametrize("name", ["left", "right", "textured"])
def test_descriptors_of_cv2_keypoints_equal_orb_compute(fixture_pair, name):
    img = _image(fixture_pair, name)
    cvorb = cv2.ORB_create(5000)
    kps, want = cvorb.compute(img, cvorb.detect(img, None))
    pts = np.array([k.pt for k in kps], np.float32)
    keep, got = orb.compute(img, pts, [k.octave for k in kps], [k.angle for k in kps], device="cpu")
    assert keep.all()
    share = (got.numpy() == want).all(1).mean()
    assert share >= 0.99 and share == 1.0, share


@pytest.mark.parametrize("name,n_features", [("left", 5000), ("right", 5000), ("textured", 500)])
def test_detect_and_compute_share_with_cv2(fixture_pair, name, n_features):
    img = _image(fixture_pair, name)
    want_kp, want_des = cv2.ORB_create(n_features).detectAndCompute(img, None)
    kp, des = orb.detect_and_compute(img, n_features, device="cpu")
    want = [(k.pt[0], k.pt[1], k.octave) for k in want_kp]
    got = list(zip(kp["pt"][:, 0].tolist(), kp["pt"][:, 1].tolist(), kp["octave"].tolist()))
    share = len(set(got) & set(want)) / len(want)
    assert share == 1.0  # measured
    assert got == want  # cv2's order too (libstdc++'s nth_element and partition)
    for key, attr in (("angle", "angle"), ("response", "response"), ("size", "size")):
        assert np.array_equal(kp[key], np.array([getattr(k, attr) for k in want_kp], np.float32)), key
    assert np.array_equal(des.numpy(), want_des)


def test_retain_best_keeps_ties_with_the_last_kept():
    responses = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3], np.float32)
    assert sorted(responses[orb.retain_best(responses, 2)].tolist()) == [9, 9, 9]
    assert sorted(responses[orb.retain_best(responses, 6)].tolist()) == [6, 7, 8, 9, 9, 9]
    assert len(orb.retain_best(responses, 20)) == 16 and len(orb.retain_best(responses, 0)) == 0


def test_orb_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        orb.detect_and_compute(textured(1))
    with pytest.raises(ValueError, match="uint8 grey"):
        orb.detect_and_compute(np.zeros((40, 40, 3), np.uint8), device="cpu")
