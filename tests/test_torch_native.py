"""The port's native host reader (`sfa3d_tpu_torch/native/`) against its
numpy twin (`ops/bev.py::_filter_and_pad_numpy`) and against the JAX
package's native reader (`sfa3d_tpu.native`), bit for bit: the same kept
set in the same order, the same truncation and overflow warning, the same
zero padding and valid mask. The cases mirror tests/test_native.py. A
failed build raises unless SFA3D_TPU_NO_NATIVE=1 selects the twin.
"""

import logging
import warnings

import numpy as np
import pytest

from sfa3d_tpu import native as jnative
from sfa3d_tpu_torch import native
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.ops import bev as tbev
from sfa3d_tpu_torch.ops.bev import _filter_and_pad_numpy, filter_and_pad_points


@pytest.fixture(autouse=True)
def native_on(monkeypatch):
    monkeypatch.delenv("SFA3D_TPU_NO_NATIVE", raising=False)


def _random_cloud(rng, n, with_nans=True):
    pts = rng.uniform(-60, 60, (n, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-5, 3, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    if with_nans and n:
        bad = rng.integers(0, n, max(1, n // 50))
        pts[bad, rng.integers(0, 4, len(bad))] = np.nan
    return pts


def _assert_same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == b[0].dtype == np.float32 and a[1].dtype == b[1].dtype == bool
    assert a[0].tobytes() == b[0].tobytes()  # bit for bit (NaN payloads and -0.0 too)


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 120_000])
def test_filter_pad_bit_equal_to_twin_and_jax(n):
    rng = np.random.default_rng(n + 1)
    pts = _random_cloud(rng, n)
    if n >= 7:  # exact-boundary rows exercise the >= / <= edges
        pts[0] = [cnf.boundary["minX"], 0.0, 0.0, 0.5]
        pts[1] = [cnf.boundary["maxX"], 0.0, 0.0, 0.5]
        pts[2] = [10.0, cnf.boundary["minY"], 0.0, 0.5]
        pts[3] = [10.0, cnf.boundary["maxY"], 0.0, 0.5]
        pts[4] = [10.0, 0.0, cnf.boundary["minZ"], 0.5]
        pts[5] = [10.0, 0.0, cnf.boundary["maxZ"], -0.0]
        pts[6] = [10.0, 0.0, 0.0, np.nan]  # NaN intensity is KEPT
    for max_points in (64, 32768):
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got = native.filter_pad_points(pts, max_points, cnf.boundary)
        with warnings.catch_warnings(record=True) as want_w:
            warnings.simplefilter("always")
            want = _filter_and_pad_numpy(pts, max_points, cnf.boundary)
        _assert_same(got, want)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # JAX's reader warns as the port's does (compared above)
            _assert_same(got, jnative.filter_pad_points(pts, max_points, cnf.boundary))
        assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]


@pytest.mark.parametrize("n", [50_000, 600_000])  # one chunk of the reader, and three
def test_read_filter_pad_matches_in_memory_and_jax(tmp_path, n):
    rng = np.random.default_rng(0)
    pts = _random_cloud(rng, n)
    path = str(tmp_path / "scan.bin")
    pts.tofile(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 600k points overflow the budget on both sides
        got = native.read_velodyne_filtered(path, 32768, cnf.boundary)
        _assert_same(got, _filter_and_pad_numpy(pts, 32768, cnf.boundary))
        _assert_same(got, jnative.read_velodyne_filtered(path, 32768, cnf.boundary))


def test_read_missing_or_ragged_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.read_velodyne_filtered(str(tmp_path / "nope.bin"), 64, cnf.boundary)
    (tmp_path / "ragged.bin").write_bytes(bytes(16 * 3 + 4))
    with pytest.raises(ValueError, match="whole number"):
        native.read_velodyne_filtered(str(tmp_path / "ragged.bin"), 64, cnf.boundary)
    with pytest.raises(ValueError):  # the numpy read refuses it too
        np.fromfile(str(tmp_path / "ragged.bin"), dtype=np.float32).reshape(-1, 4)


def test_truncation_keeps_scan_order_and_warns():
    pts = np.zeros((1000, 4), np.float32)
    pts[:, 0] = 10.0
    pts[:, 3] = np.arange(1000)  # intensity records the original order
    with pytest.warns(RuntimeWarning, match="scan has 1000 in-range points; keeping the first 128") as w:
        got = filter_and_pad_points(pts, max_points=128)
    assert w[0].filename == __file__  # the warning points at the caller
    np.testing.assert_array_equal(got[0][:, 3], np.arange(128, dtype=np.float32))
    assert got[1].all()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _assert_same(got, jnative.filter_pad_points(pts, 128, cnf.boundary))


def test_public_api_takes_the_native_path_and_logs_it_once(monkeypatch, caplog):
    monkeypatch.setattr(native, "_logged", set())
    calls = []
    monkeypatch.setattr(native, "filter_pad_points", lambda *a: calls.append(a) or _filter_and_pad_numpy(*a))
    pts = _random_cloud(np.random.default_rng(4), 2000)
    with caplog.at_level(logging.INFO, logger="sfa3d_tpu_torch.native"):
        filter_and_pad_points(pts, max_points=8192)
        filter_and_pad_points(pts, max_points=8192)
        monkeypatch.setenv("SFA3D_TPU_NO_NATIVE", "1")
        assert not native.enabled()
        a = filter_and_pad_points(pts, max_points=8192)
    assert len(calls) == 2  # the native entry, never with SFA3D_TPU_NO_NATIVE
    assert [r.getMessage().split(" (")[0] for r in caplog.records] == ["host reader: native", "host reader: numpy"]
    _assert_same(a, _filter_and_pad_numpy(pts, 8192, cnf.boundary))


def test_failed_build_raises_unless_disabled(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    pts = _random_cloud(np.random.default_rng(5), 100)
    with pytest.raises((RuntimeError, OSError)):
        tbev.filter_and_pad_points(pts, max_points=64)
    monkeypatch.setenv("SFA3D_TPU_NO_NATIVE", "1")
    _assert_same(tbev.filter_and_pad_points(pts, max_points=64), _filter_and_pad_numpy(pts, 64, cnf.boundary))
    assert native._lib is None and not list((tmp_path / "build").glob("*.so"))


def test_build_is_atomic_and_named_by_source_and_host():
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.suffix == ".so"
    assert native.library_path() == path and native._host_tag() in path.name
    assert not list(native.BUILD_DIR.glob("*.tmp"))


@pytest.mark.parametrize("mode", ["val", "train"])
def test_dataset_identical_with_and_without_native(tmp_path, monkeypatch, mode):
    """KittiSample arrays are identical whether the fused native reader (no
    augmentation: the raw cloud is never read) or the numpy path made them;
    so are the raw-drive dataset's items."""
    from sfa3d_tpu_torch.data.kitti import DemoKittiDataset, KittiDataset
    from sfa3d_tpu_torch.data.synthetic import write_mini_drive, write_mini_kitti

    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=2)
    drive = write_mini_drive(str(tmp_path / "drive"), n_frames=2)
    samples, items = [], []
    for off in (False, True):
        if off:
            monkeypatch.setenv("SFA3D_TPU_NO_NATIVE", "1")
        ds = KittiDataset(root, mode=mode, lidar_aug=None, hflip_prob=0.0)
        samples.append(ds[0])
        items.append(DemoKittiDataset(drive)[1])
    a, b = samples
    assert a.valid.sum() > 0
    for field in ("points", "valid", "labels"):
        assert getattr(a, field).tobytes() == getattr(b, field).tobytes(), field
    for x, y in zip(items[0][:2], items[1][:2]):
        assert x.tobytes() == y.tobytes()


def _reply_rows(dets):
    return np.asarray([[d["class_id"], d["score"], d["x"], d["y"], d["z"], d["h"], d["w"], d["l"], d["yaw"]]
                       for d in dets], np.float32)


@pytest.fixture()
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_servers_read_bin_scans_natively(tmp_path, monkeypatch, one_torch_thread):
    """Both servers' `.bin` requests take the native fused read (the raw
    scan never materialised) and answer exactly as the numpy route does:
    the read scan submitted as points, and submit_file under
    SFA3D_TPU_NO_NATIVE."""
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene
    from sfa3d_tpu_torch.detector import Detector, FusedDetector
    from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
    from sfa3d_tpu_torch.runtime import serving
    from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer, BatchingFusedServer

    scan, _ = synthetic_scene(seed=3)
    path = str(tmp_path / "000003.bin")
    scan.astype(np.float32).tofile(path)
    reads = []
    real_read = native.read_velodyne_filtered
    monkeypatch.setattr(native, "read_velodyne_filtered", lambda *a: reads.append(a[0]) or real_read(*a))
    image = np.random.default_rng(0).integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    calib = KittiCalibration(None)

    lidar = BatchingDetectorServer(Detector(device="cpu", peak_thresh=0.0, seed=1), max_batch=2)
    fused = BatchingFusedServer(FusedDetector(device="cpu", imgsz=(64, 192)), max_batch=2)
    try:
        got = [lidar.submit_file(path).result(timeout=300),
               fused.submit_fused_file(path, image, calib).result(timeout=300)]
        assert reads == [path, path]
        want = [lidar.submit(np.fromfile(path, np.float32).reshape(-1, 4)).result(timeout=300),
                fused.submit_fused(np.fromfile(path, np.float32).reshape(-1, 4), image, calib).result(timeout=300)]
        monkeypatch.setenv("SFA3D_TPU_NO_NATIVE", "1")
        numpy_route = [lidar.submit_file(path).result(timeout=300),
                       fused.submit_fused_file(path, image, calib).result(timeout=300)]
        assert reads == [path, path]
    finally:
        lidar.stop()
        fused.stop()
    assert len(got[0]) == 50
    for replies in (want, numpy_route):
        assert _reply_rows(got[0]).tobytes() == _reply_rows(replies[0]).tobytes()
        assert got[1].keys() == replies[1].keys()
        for key in got[1]:
            np.testing.assert_array_equal(np.asarray(got[1][key]), np.asarray(replies[1][key]), err_msg=key)
    assert serving.read_scan_filtered(path, 32768)[0].tobytes() == filter_and_pad_points(
        np.fromfile(path, np.float32).reshape(-1, 4), max_points=32768)[0].tobytes()


@pytest.mark.parametrize("case", ["ragged", "missing"])
def test_server_bin_read_fails_as_the_dataset_read(tmp_path, case):
    """A malformed or missing `.bin` fails at submit_file with the error
    KittiDataset's read gives for the same file."""
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer, BatchingFusedServer

    class _Unused:  # the request fails on the caller's thread, before any device call
        max_points = cnf.MAX_POINTS_FILTERED

    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=1, cameras=False)
    path = tmp_path / "kitti" / "training" / "velodyne" / "000000.bin"
    if case == "ragged":
        path.write_bytes(path.read_bytes()[:-3])
    else:
        path.unlink()
    with pytest.raises(Exception) as dataset_err:
        KittiDataset(root, mode="val", lidar_aug=None, hflip_prob=0.0)[0]
    lidar, fused = BatchingDetectorServer(_Unused(), max_batch=1), BatchingFusedServer(_Unused(), max_batch=1)
    try:
        for submit in (lambda: lidar.submit_file(str(path)),
                       lambda: fused.submit_fused_file(str(path), np.zeros((8, 8, 3), np.uint8), None)):
            with pytest.raises(type(dataset_err.value)) as server_err:
                submit()
            assert str(server_err.value) == str(dataset_err.value)
    finally:
        lidar.stop()
        fused.stop()
    assert isinstance(dataset_err.value, ValueError if case == "ragged" else OSError)
