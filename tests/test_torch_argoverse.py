"""The port's Argoverse path against the JAX package on the CPU: SE3 and the
Argoverse calibration, the PLY reader, `ArgoverseDataset`, the 1000 x 1000
Argoverse raster (and the plain version of the tile kernel's Argoverse
mode, cut into the kernel's bands), `argoverse_prepare_batch`, the loader
factories on `--dataset argoverse`, and the fixture writer.

Inputs are numpy arrays from a seed; the dataset fixture is the JAX
package's `write_mini_argoverse`. Tolerances: geometry 1e-12 (the same
float64 numpy); cell rows, columns, masks, counts, the height and intensity
channels and the integer targets bit-exact; the density channel goes
through `log1p`, which differs by an ulp between XLA and PyTorch on some
counts: within DENSITY_TOL_255 on the 0-255 scale; float targets at
`tests/test_torch_targets.py`'s HM_RTOL.
"""

import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.data import argoverse as jargo
from sfa3d_tpu.geometry import argoverse_calib as jcalib
from sfa3d_tpu.geometry import se3 as jse3
from sfa3d_tpu.ops.bev import argoverse_points_to_bev as jargoverse_points_to_bev
from sfa3d_tpu_torch.data import argoverse as targo
from sfa3d_tpu_torch.geometry import argoverse_calib as tcalib
from sfa3d_tpu_torch.geometry import se3 as tse3
from sfa3d_tpu_torch.ops import bev as tbev
from sfa3d_tpu_torch.ops.bev_counts import (
    ARGOVERSE_BYTES_PER_CELL,
    argoverse_raster_reduce,
    argoverse_raster_reduce_plain,
    tile_plan,
)

GEOM_TOL = 1e-12
DENSITY_TOL_255 = 1e-4  # log1p: one float32 ulp between XLA and PyTorch, scaled to 0-255
HM_RTOL = 2.4e-7  # exp / sin / cos of the targets (tests/test_torch_targets.py)
H100_SMEM = 232448  # shared memory one block may use on an H100
H = W = 1000
N_FRAMES = 4
INT_TARGETS = ("indices_center", "obj_mask")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread: in a loaded multi-worker
    run more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mini_argo(tmp_path_factory):
    root = tmp_path_factory.mktemp("argo")
    return jargo.write_mini_argoverse(str(root / "jax"), n_frames=N_FRAMES, seed=3)


def _calib_path(root):
    return os.path.join(root, "vehicle_calibration_info.json")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_se3_matches_jax(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    t = rng.normal(size=3) * 10
    q2, t2 = rng.normal(size=4), rng.normal(size=3)
    np.testing.assert_allclose(tse3.quat2rotmat(q), jse3.quat2rotmat(q), rtol=0, atol=GEOM_TOL)
    assert abs(tse3.yaw_from_quaternion(q) - jse3.yaw_from_quaternion(q)) <= GEOM_TOL
    a, b = tse3.SE3.from_quaternion(q, t), jse3.SE3.from_quaternion(q, t)
    a2, b2 = tse3.SE3.from_quaternion(q2, t2), jse3.SE3.from_quaternion(q2, t2)
    pts = rng.uniform(-50, 50, (100, 3))
    for got, want in ((a, b), (a.inverse(), b.inverse()), (a.compose(a2), b.compose(b2))):
        np.testing.assert_allclose(got.transform_matrix, want.transform_matrix, rtol=0, atol=GEOM_TOL)
        np.testing.assert_allclose(got.transform_point_cloud(pts), want.transform_point_cloud(pts),
                                   rtol=0, atol=GEOM_TOL)
    with pytest.raises(ValueError, match="rotation"):
        tse3.SE3(np.eye(2), np.zeros(3))


def test_calibration_matches_jax(mini_argo):
    path = _calib_path(mini_argo)
    got, want = tcalib.ArgoverseCalibration(path), jcalib.ArgoverseCalibration(path)
    for name in ("P2", "L2C"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=GEOM_TOL)
    for a, b in zip(got.camera_config, want.camera_config):
        np.testing.assert_allclose(a, b, rtol=0, atol=GEOM_TOL)

    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(-40, 40, (200, 3)), [[20.0, 0.0, 1.4], [-20.0, 0.0, 1.4]]])
    for fn in ("project_lidar_to_image", "project_ego_to_image"):
        (uv, valid), (juv, jvalid) = getattr(got, fn)(pts), getattr(want, fn)(pts)
        np.testing.assert_array_equal(valid, jvalid)
        np.testing.assert_allclose(uv, juv, rtol=0, atol=GEOM_TOL)  # NaN where behind, both
        assert valid.any() and not valid.all()
    uvd = np.concatenate([rng.uniform(0, 1920, (50, 2)), rng.uniform(2, 60, (50, 1))], axis=1)
    np.testing.assert_allclose(got.project_image_to_ego(uvd), want.project_image_to_ego(uvd),
                               rtol=0, atol=GEOM_TOL)

    cams, jcams = tcalib.load_all_camera_calibs(path), jcalib.load_all_camera_calibs(path)
    stereo, jstereo = tcalib.load_stereo_calib(path), jcalib.load_stereo_calib(path)
    assert sorted(cams) == sorted(jcams) and sorted(stereo) == sorted(jstereo) == [
        "stereo_front_left_rect", "stereo_front_right_rect"]
    for name in cams:
        np.testing.assert_allclose(cams[name].L2C, jcams[name].L2C, rtol=0, atol=GEOM_TOL)
    b = tcalib.stereo_baseline_m(stereo["stereo_front_left_rect"], stereo["stereo_front_right_rect"])
    jb = jcalib.stereo_baseline_m(jstereo["stereo_front_left_rect"], jstereo["stereo_front_right_rect"])
    assert abs(b - jb) <= GEOM_TOL and b == pytest.approx(0.2986, abs=1e-6)
    with pytest.raises(ValueError, match="not found"):
        tcalib.get_calibration_config(tcalib.load_calib(path), "ring_side_left")


def test_distortion_and_motion_compensation_match_jax(mini_argo):
    r = np.linspace(0.0, 0.8, 50)
    for k in (tcalib.DEFAULT_DISTORTION, [-0.1, 0.05, -0.01]):
        np.testing.assert_allclose(tcalib.distort_radius(r, k), jcalib.distort_radius(r, k), rtol=0, atol=GEOM_TOL)
        rd = jcalib.distort_radius(r, k)
        np.testing.assert_allclose(tcalib.undistort_radius(rd, k), jcalib.undistort_radius(rd, k),
                                   rtol=0, atol=GEOM_TOL)

    stamps = sorted(int(f.split("_")[-1].split(".")[0]) for f in os.listdir(os.path.join(mini_argo, "log0", "poses")))
    poses = [tcalib.get_city_SE3_egovehicle_at_sensor_t(t, mini_argo, "log0") for t in stamps]
    jposes = [jcalib.get_city_SE3_egovehicle_at_sensor_t(t, mini_argo, "log0") for t in stamps]
    for p, jp in zip(poses, jposes):
        np.testing.assert_allclose(p.transform_matrix, jp.transform_matrix, rtol=0, atol=GEOM_TOL)
    assert tcalib.get_city_SE3_egovehicle_at_sensor_t(12345, mini_argo, "log0") is None
    pts = np.random.default_rng(6).uniform(-30, 30, (64, 3))
    moved = tcalib.motion_compensate_points(pts, poses[0], poses[2])
    np.testing.assert_allclose(moved, jcalib.motion_compensate_points(pts, jposes[0], jposes[2]), rtol=0, atol=GEOM_TOL)
    calib, jcal = tcalib.ArgoverseCalibration(_calib_path(mini_argo)), jcalib.ArgoverseCalibration(_calib_path(mini_argo))
    uv, valid = tcalib.project_lidar_to_img_motion_compensated(pts, calib, stamps[1], stamps[0], mini_argo, "log0")
    juv, jvalid = jcalib.project_lidar_to_img_motion_compensated(pts, jcal, stamps[1], stamps[0], mini_argo, "log0")
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_allclose(uv, juv, rtol=0, atol=GEOM_TOL)
    assert tcalib.project_lidar_to_img_motion_compensated(pts, calib, 1, 2, mini_argo, "log0") == (None, None)


# ---------------------------------------------------------------------------
# reader and dataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["binary_little_endian", "ascii"])
def test_ply_reader_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(7)
    n = 257
    pts = rng.uniform(-10, 10, (n, 4)).astype(np.float32)
    ring = rng.integers(0, 32, n).astype(np.uint8)
    path = str(tmp_path / "sweep.ply")
    header = (f"ply\nformat {fmt} 1.0\nelement vertex {n}\nproperty float x\nproperty float y\n"
              "property float z\nproperty float intensity\nproperty uchar laser_number\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        if fmt == "ascii":
            f.write("".join(f"{a!r} {b!r} {c!r} {d!r} {e}\n" for (a, b, c, d), e
                            in zip(pts.astype(float).tolist(), ring.tolist())).encode())
        else:
            rec = np.zeros(n, np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("i", "<f4"), ("l", "u1")]))
            rec["x"], rec["y"], rec["z"], rec["i"], rec["l"] = pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3], ring
            f.write(rec.tobytes())
    got = targo.load_ply_lidar(path)
    assert got.dtype == np.float32 and got.shape == (n, 4)
    np.testing.assert_array_equal(got, jargo.load_ply_lidar(path))
    np.testing.assert_array_equal(got, pts)
    np.testing.assert_array_equal(targo.load_lidar(path), got)


def _assert_samples_equal(a, b):
    assert (a.timestamp, a.img_path, a.lidar_path) == (b.timestamp, b.img_path, b.lidar_path)
    assert int(a.n_labels) == int(b.n_labels) and type(a.n_labels) is type(b.n_labels)
    for f in ("points", "valid", "labels"):
        ga, gb = getattr(a, f), getattr(b, f)
        assert ga.dtype == gb.dtype and ga.shape == gb.shape, f
        np.testing.assert_array_equal(ga, gb, err_msg=f)
    np.testing.assert_allclose(a.calib.L2C, b.calib.L2C, rtol=0, atol=GEOM_TOL)


@pytest.mark.parametrize("num_samples", [None, 2])
def test_dataset_samples_equal_jax(mini_argo, num_samples):
    ds = targo.ArgoverseDataset(mini_argo, mode="test", num_samples=num_samples)
    jds = jargo.ArgoverseDataset(mini_argo, mode="test", num_samples=num_samples)
    assert len(ds) == len(jds) == (num_samples or N_FRAMES)
    for i in range(len(ds)):
        _assert_samples_equal(ds[i], jds[i])
    s = ds[0]
    assert s.points.shape == (131072, 4) and s.valid.sum() > 10000 and int(s.n_labels) >= 1
    with pytest.raises(ValueError, match="mode"):
        targo.ArgoverseDataset(mini_argo, mode="bogus")


def test_writer_files_equal_jax(tmp_path):
    """Every file is byte for byte the JAX writer's: the lidar sweeps,
    labels, poses and calibration, and the camera frames, JPEGs of the
    seeded pixels (the port's encoder gives cv2.imwrite's bytes); the
    dataset pairs them as JAX's does."""
    port = targo.write_mini_argoverse(str(tmp_path / "port"), n_frames=3, seed=9)
    ref = jargo.write_mini_argoverse(str(tmp_path / "jax"), n_frames=3, seed=9)
    for sub in ("samplefile/lidar", "samplefile/ring_front_center", "annotations", "log0/poses", "."):
        names = sorted(f for f in os.listdir(os.path.join(ref, sub)) if os.path.isfile(os.path.join(ref, sub, f)))
        assert names == sorted(f for f in os.listdir(os.path.join(port, sub))
                               if os.path.isfile(os.path.join(port, sub, f))) and names, sub
        _, mismatch, errors = filecmp.cmpfiles(os.path.join(port, sub), os.path.join(ref, sub), names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)
    ds, jds = targo.ArgoverseDataset(port), jargo.ArgoverseDataset(ref)
    assert len(ds) == len(jds) == 3 and ds.image_files[0].endswith(".jpg")
    assert [os.path.basename(f) for f in ds.image_files] == [os.path.basename(f) for f in jds.image_files]
    for i in range(3):
        a, b = ds[i], jds[i]
        assert a.timestamp == b.timestamp and int(a.n_labels) == int(b.n_labels)
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.labels, b.labels)
    with open(os.path.join(port, "annotations", "track_label.json")) as f:
        assert len(json.load(f)) == 3


# ---------------------------------------------------------------------------
# the raster
# ---------------------------------------------------------------------------


@jax.jit
def _jax_cells(p, v):
    """The JAX raster's cell arithmetic (sfa3d_tpu/ops/bev.py:331-338), under
    jit as there: the strict range mask and the clipped row and column."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    ok = v & (x >= -50.0) & (x < 50.0) & (y >= -50.0) & (y < 50.0) & (z >= -3.0) & (z < 5.0)
    row = jnp.clip(((50.0 - x) / 0.1).astype(jnp.int32), 0, H - 1)
    col = jnp.clip(((y - -50.0) / 0.1).astype(jnp.int32), 0, W - 1)
    return ok, row, col


def _sweep(rng, n):
    """A sweep with points on cell edges (and one float32 ulp either side),
    at +-50 m on x and y, at the z bounds, subnormal and signed-zero
    coordinates, NaN x, and points outside the range."""
    p = np.empty((n, 4), np.float32)
    p[:, 0] = rng.uniform(-55, 55, n)
    p[:, 1] = rng.uniform(-55, 55, n)
    p[:, 2] = rng.uniform(-3.5, 5.5, n)
    p[:, 3] = rng.uniform(-0.2, 1.2, n)
    k = n // 4
    edges = (rng.integers(-500, 501, (k, 2)) * np.float32(0.1)).astype(np.float32)
    u = rng.random((k, 2))
    edges = np.where(u < 1 / 3, np.nextafter(edges, np.float32(1e3)), edges)
    p[:k, :2] = np.where(u > 2 / 3, np.nextafter(edges, np.float32(-1e3)), edges)
    m = max(1, n // 50)
    p[k:k + m, 0] = 50.0
    p[k + m:k + 2 * m, 0] = -50.0
    p[k + 2 * m:k + 3 * m, 1] = 50.0
    p[k + 3 * m:k + 4 * m, 1] = -50.0
    p[k + 4 * m:k + 5 * m, 2] = -3.0
    p[k + 5 * m:k + 6 * m, 2] = 5.0
    tiny = np.float32(1e-40)  # subnormal
    p[k + 6 * m:k + 7 * m, :] = rng.choice([tiny, -tiny, np.float32(0.0), np.float32(-0.0)], (m, 4))
    p[k + 7 * m:k + 8 * m, 0] = np.nan
    return p, rng.random(n) < 0.95


@pytest.mark.parametrize("n", [5000, 131072])
def test_argoverse_raster_matches_jax(n):
    rng = np.random.default_rng(n)
    frames = [_sweep(rng, n) for _ in range(2)]
    frames[1][0][: n // 2, 2] = rng.uniform(-3, 0, n // 2)  # negative heights: the 0 floor
    pts = np.stack([p for p, _ in frames])
    valid = np.stack([v for _, v in frames])
    row, col, z, r = tbev.argoverse_cell_indices(torch.from_numpy(pts), torch.from_numpy(valid))
    got = tbev.argoverse_points_to_bev(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    assert got.shape == (2, H, W, 3) and got.dtype == np.float32
    raw = argoverse_raster_reduce(row, col, z, r, H, W).numpy()
    for b in range(2):
        ok, jrow, jcol = (np.asarray(a) for a in _jax_cells(jnp.asarray(pts[b]), jnp.asarray(valid[b])))
        np.testing.assert_array_equal(row[b].numpy() >= 0, ok)
        np.testing.assert_array_equal(row[b].numpy()[ok], jrow[ok])
        np.testing.assert_array_equal(col[b].numpy()[ok], jcol[ok])
        assert (row[b].numpy()[~ok] == -1).all() and (col[b].numpy()[~ok] == -1).all()
        counts = np.zeros((H, W), np.float32)
        np.add.at(counts, (jrow[ok], jcol[ok]), 1)
        np.testing.assert_array_equal(raw[b, 0], counts)
        want = np.asarray(jargoverse_points_to_bev(jnp.asarray(pts[b]), jnp.asarray(valid[b])))
        np.testing.assert_array_equal(got[b, ..., 1], want[..., 1])
        np.testing.assert_array_equal(got[b, ..., 2], want[..., 2])
        np.testing.assert_allclose(got[b, ..., 0], want[..., 0], rtol=0, atol=DENSITY_TOL_255)
        assert got[b, ..., 0].max() == 255.0 and (got[b, ..., 0] > 0).sum() > n // 10
    single = tbev.argoverse_points_to_bev(torch.from_numpy(pts[0]), torch.from_numpy(valid[0])).numpy()
    np.testing.assert_array_equal(single, got[0])


def test_log1p_of_counts_within_one_ulp_of_jax():
    """Why the density channel is held within a tolerance: XLA's and
    PyTorch's float32 log1p differ by one ulp on some integer counts, and by
    no more."""
    counts = np.arange(200_000, dtype=np.float32)
    got = torch.log1p(torch.from_numpy(counts)).numpy()
    want = np.asarray(jnp.log1p(jnp.asarray(counts)))
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1 and (ulps == 0).mean() > 0.9


def test_argoverse_raster_of_an_empty_sweep_is_zero():
    pts, valid = np.zeros((2, 64, 4), np.float32), np.zeros((2, 64), bool)
    got = tbev.argoverse_points_to_bev(torch.from_numpy(pts), torch.from_numpy(valid)).numpy()
    want = np.asarray(jargoverse_points_to_bev(jnp.asarray(pts[0]), jnp.asarray(valid[0])))
    assert not got.any() and not want.any()


def _argoverse_tile_numpy(row, col, z, r, tile_rows, n_tiles):
    """The kernel's Argoverse mode in numpy: block (t, b) owns rows [t *
    tile_rows, ...) and takes a point where the unsigned row - r0 falls below
    its row count and 0 <= col < W; the maxima are int maxima of the bits of
    v > 0 ? v : +0, starting at the bits of +0."""
    B = row.shape[0]
    counts = np.zeros((B, H, W), np.int64)
    zmax, rmax = np.zeros((B, H, W), np.int32), np.zeros((B, H, W), np.int32)
    zbits = np.where(z > 0, z, np.float32(0)).astype(np.float32).view(np.int32)
    rbits = np.where(r > 0, r, np.float32(0)).astype(np.float32).view(np.int32)
    for b in range(B):
        for t in range(n_tiles):
            r0 = t * tile_rows
            lr = row[b].astype(np.uint32) - np.uint32(r0)
            ok = (lr < min(tile_rows, H - r0)) & (col[b] >= 0) & (col[b] < W)
            cell = (lr[ok].astype(np.int64) + r0, col[b][ok])
            np.add.at(counts[b], cell, 1)
            np.maximum.at(zmax[b], cell, zbits[b][ok])
            np.maximum.at(rmax[b], cell, rbits[b][ok])
    return np.stack([counts.astype(np.float32), zmax.view(np.float32), rmax.view(np.float32)], 1)


def test_argoverse_tile_bands_give_the_plain_version():
    """Cut into the bands of the kernel's plan on an H100 (19 rows a band at
    12 B a cell), the kernel's arithmetic equals the plain version bit for
    bit: rows and columns -3..1002 (outside the raster: nowhere), a cell hit
    5,000 times, an all-invalid frame, points on the rows where bands meet,
    and z and r negative, -0.0, +0.0, subnormal, NaN and +inf."""
    rng = np.random.default_rng(11)
    B, n = 3, 20000
    tile_rows, n_tiles = tile_plan(B, H, W, ARGOVERSE_BYTES_PER_CELL, H100_SMEM)
    assert (tile_rows, n_tiles) == (19, 53)
    row = rng.integers(-3, H + 3, (B, n)).astype(np.int32)
    col = rng.integers(-3, W + 3, (B, n)).astype(np.int32)
    edges = np.array([e for m in range(tile_rows, H, tile_rows) for e in (m - 1, m)])
    row[0, : n // 4] = rng.choice(edges, n // 4)
    row[0, n // 4: n // 4 + 5000], col[0, n // 4: n // 4 + 5000] = 123, 456
    row[2], col[2] = -1, -1
    special = np.array([-1.0, -0.0, 0.0, 1e-40, -1e-40, np.nan, np.inf, 2.5, 0.75], np.float32)
    z = np.where(rng.random((B, n)) < 0.3, rng.choice(special, (B, n)), rng.uniform(-3, 5, (B, n))).astype(np.float32)
    r = np.where(rng.random((B, n)) < 0.3, rng.choice(special, (B, n)), rng.uniform(-0.2, 1, (B, n))).astype(np.float32)
    want = _argoverse_tile_numpy(row, col, z, r, tile_rows, n_tiles)
    got = argoverse_raster_reduce_plain(*(torch.from_numpy(a) for a in (row, col, z, r)), H, W).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0, 0, 123, 456] >= 5000 and not got[2].any()
    assert np.isinf(got[:, 1]).any() and (got[:, 1:].view(np.uint32) != np.uint32(0x80000000)).all()


def test_argoverse_raster_reduce_checks_inputs():
    from sfa3d_tpu_torch.ops.bev_counts import argoverse_raster_reduce as reduce

    idx = torch.zeros((1, 8), dtype=torch.int32)
    vals = torch.zeros((1, 8))
    with pytest.raises(TypeError, match="float32"):
        reduce(idx, idx, vals.double(), vals, H, W)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        reduce(idx, idx, vals[:, :4], vals, H, W)
    with pytest.raises(TypeError, match="int32"):
        reduce(idx.long(), idx.long(), vals, vals, H, W)
    meta = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        reduce(meta, meta, vals.to("meta"), vals.to("meta"), H, W)


# ---------------------------------------------------------------------------
# batch preparation and loaders
# ---------------------------------------------------------------------------


def _assert_crop_close(got_nchw, want_nhwc):
    got = got_nchw.permute(0, 2, 3, 1).numpy()
    want = np.asarray(want_nhwc)
    assert got.shape == want.shape and got.shape[1:] == (608, 608, 3)
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=DENSITY_TOL_255 / 255.0)


def _assert_targets_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        if k in INT_TARGETS:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=HM_RTOL, atol=1e-30, err_msg=k)


def test_prepare_batch_matches_jax(mini_argo):
    ds = jargo.ArgoverseDataset(mini_argo)
    samples = [ds[i] for i in range(N_FRAMES)]
    arrays = (np.stack([s.points for s in samples]), np.stack([s.valid for s in samples]),
              np.stack([s.labels for s in samples]), np.asarray([s.n_labels for s in samples], np.int32))
    jbev, jtargets = jargo._argo_prepare_batch(*arrays)
    bev, targets = targo.argoverse_prepare_batch(*(torch.from_numpy(a) for a in arrays))
    assert bev.shape == (N_FRAMES, 3, 608, 608)
    _assert_crop_close(bev, jbev)
    _assert_targets_close(targets, jtargets)
    assert float(targets["obj_mask"].sum()) > 0 and targets["hm_cen"].max() == 1.0


def test_argoverse_targets_align_with_raster():
    """The port of tests/test_argoverse.py's alignment test: the heatmap
    peak lands where the object sits in the cropped, x-flipped raster, the
    raster is dense there, and the direction target is pi - yaw's."""
    x_obj, y_obj = 12.0, -8.0
    rng = np.random.default_rng(0)
    n = 4096
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(-40, 40, n)
    pts[:, 1] = rng.uniform(-40, 40, n)
    pts[:, 2] = rng.uniform(-1, 1, n)
    pts[:, 3] = 0.5
    pts[:512, 0] = x_obj + rng.uniform(-1, 1, 512)
    pts[:512, 1] = y_obj + rng.uniform(-1, 1, 512)
    valid = np.ones(n, bool)
    labels = np.zeros((50, 8), np.float32)
    labels[0] = [1, x_obj, y_obj, -1.5, 1.5, 1.8, 4.0, 0.3]
    arrays = (pts[None], valid[None], labels[None], np.asarray([1], np.int32))
    bev, tg = targo.argoverse_prepare_batch(*(torch.from_numpy(a) for a in arrays))
    jbev, jtg = jargo._argo_prepare_batch(*arrays)
    _assert_crop_close(bev, jbev)
    _assert_targets_close(tg, jtg)

    hm = tg["hm_cen"][0].numpy()  # (152, 152, 3)
    assert hm.max() == 1.0
    peak = np.unravel_index(hm[:, :, 1].argmax(), hm[:, :, 1].shape)
    want_row = int((((50.0 - x_obj) / 0.1) - 196) / 4)
    want_col = int((((y_obj + 50.0) / 0.1) - 196) / 4)
    assert abs(peak[0] - want_row) <= 1, (peak, want_row)
    assert abs(peak[1] - want_col) <= 1, (peak, want_col)
    density = bev[0, 0].numpy()
    window = density[4 * want_row - 8: 4 * want_row + 8, 4 * want_col - 8: 4 * want_col + 8]
    assert window.mean() > density.mean() * 2, "object cluster not under the target peak"
    d = tg["direction"][0, 0].numpy()
    want = np.array([np.sin(-(np.pi - 0.3)), np.cos(-(np.pi - 0.3))], np.float32)
    np.testing.assert_allclose(d, want, atol=1e-5)


def test_loader_factories_take_dataset_argoverse(mini_argo):
    """`--dataset argoverse` builds the Argoverse pair in both factories:
    the same batches as the JAX loader's, in the same order (train:
    shuffled, S = 2 x B = 1; val: in order, the tail kept)."""
    from sfa3d_tpu.config.train import parse_train_configs as jparse
    from sfa3d_tpu.data.loader import create_train_loader as jcreate_train
    from sfa3d_tpu.data.loader import create_val_loader as jcreate_val
    from sfa3d_tpu_torch.config.train import parse_train_configs
    from sfa3d_tpu_torch.data.loader import create_train_loader, create_val_loader

    flags = ["--dataset", "argoverse", "--dataset_dir", mini_argo, "--batch_size", "1",
             "--effective_batch", "2", "--num_workers", "0", "--num_samples", "3"]
    configs, jconfigs = parse_train_configs(flags + ["--platform", "cpu"]), jparse(flags)
    train, jtrain = create_train_loader(configs), jcreate_train(jconfigs)
    assert isinstance(train, targo.ArgoverseTrainLoader) and len(train) == len(jtrain) == 1
    train.set_epoch(2)
    jtrain.set_epoch(2)
    for got, want in zip(train, jtrain):
        assert got["bev"].shape == (2, 1, 3, 608, 608) and got["bev"].device.type == "cpu"
        _assert_crop_close(got["bev"].flatten(0, 1), np.asarray(want["bev"]).reshape(-1, 608, 608, 3))
        _assert_targets_close({k: v.flatten(0, 1) for k, v in got["targets"].items()},
                              {k: np.asarray(v).reshape((-1,) + v.shape[2:]) for k, v in want["targets"].items()})
    val, jval = create_val_loader(configs), jcreate_val(jconfigs)
    assert isinstance(val, targo.ArgoverseTrainLoader)
    shapes = [b["bev"].shape[:2] for b in val]
    assert shapes == [tuple(np.asarray(b["bev"]).shape[:2]) for b in jval] == [(1, 1)] * 3


def test_train_config_takes_dataset_argoverse():
    from sfa3d_tpu_torch.config.train import parse_train_configs

    cfg = parse_train_configs(["--dataset", "argoverse"])
    assert cfg.data.dataset == "argoverse" and cfg.data.dataset_dir.endswith(os.path.join("dataset", "argoverse"))
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        parse_train_configs(["--dataset", "argoverse", "--mesh_shape", "2"])
