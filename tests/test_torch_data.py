"""The port's training data path against the JAX package's on the CPU:
synthetic scenes and the mini KITTI files, `KittiDataset` samples (with the
reference augmentation and hflip), `EpochSampler`, the loader's batches
(synchronous == threaded, and == the JAX loader's), the uint16 point format,
and `prepare_train_batch` (raster through the port's `bev_raster_reduce`,
W-flip, targets).

Tolerances: the raster's channels 0 and 1 and every index and mask are
bit-exact; the density channel and the heatmap go through `log` / `exp`,
which may differ by an ulp between XLA and PyTorch (DENSITY_TOL, HM_RTOL).
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.data import augment as jaugment
from sfa3d_tpu.data import kitti as jkitti
from sfa3d_tpu.data import loader as jloader
from sfa3d_tpu.data import synthetic as jsynthetic
from sfa3d_tpu.ops import bev as jbev
from sfa3d_tpu_torch.data import augment, kitti, loader, synthetic
from sfa3d_tpu_torch.ops import bev
from sfa3d_tpu_torch.ops.bev_counts import bev_raster_reduce

DENSITY_TOL = 1.2e-7
HM_RTOL = 2.4e-7
N_FRAMES = 4


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """The same mini KITTI written by both packages, without camera frames
    (tests/test_torch_png.py holds the rendered frames)."""
    root = tmp_path_factory.mktemp("mini")
    port = synthetic.write_mini_kitti(str(root / "port"), n_frames=N_FRAMES, seed=5, cameras=False)
    ref = jsynthetic.write_mini_kitti(str(root / "jax"), n_frames=N_FRAMES, seed=5, cameras=False)
    return port, ref


@pytest.mark.parametrize("seed", [0, 7, 1003])
def test_synthetic_scene_equals_jax(seed):
    for got, want in zip(synthetic.synthetic_scene(seed), jsynthetic.synthetic_scene(seed)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got = synthetic.synthetic_scene(seed, range_falloff=20.0)
    want = jsynthetic.synthetic_scene(seed, range_falloff=20.0)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_mini_kitti_files_equal_jax(mini_kitti):
    port, ref = mini_kitti
    for sub in ("training/velodyne", "training/calib", "training/label_2", "testing/velodyne", "ImageSets"):
        names = sorted(os.listdir(os.path.join(ref, sub)))
        assert names == sorted(os.listdir(os.path.join(port, sub))) and names, sub
        _, mismatch, errors = filecmp.cmpfiles(os.path.join(port, sub), os.path.join(ref, sub), names, shallow=False)
        assert not mismatch and not errors, (sub, mismatch, errors)
    pts, valid = synthetic.synthetic_batch_points(2, seed=3)
    want = jsynthetic.synthetic_batch_points(2, seed=3)
    assert np.array_equal(pts, want[0]) and np.array_equal(valid, want[1])


def _samples_equal(a, b):
    assert a.sample_id == b.sample_id and int(a.n_labels) == int(b.n_labels)
    assert getattr(a, "hflipped", False) == getattr(b, "hflipped", False)
    for f in ("points", "valid", "labels", "levels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_kitti_dataset_samples_equal_jax(mini_kitti, mode):
    port, ref = mini_kitti
    aug = mode == "train"
    kw = dict(mode=mode, hflip_prob=0.5 if aug else 0.0, seed=11)
    ds = kitti.KittiDataset(port, lidar_aug=augment.default_train_aug(0.9) if aug else None, **kw)
    jds = jkitti.KittiDataset(ref, lidar_aug=jaugment.default_train_aug(0.9) if aug else None, **kw)
    flips = set()
    for epoch in (1, 2):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            a, b = ds[i], jds[i]
            _samples_equal(a, b)
            flips.add(bool(getattr(a, "hflipped", False)))
            assert int(a.n_labels) > 0
    if aug:
        assert flips == {True, False}


def test_label_parsing_equals_jax(mini_kitti, tmp_path):
    port, _ = mini_kitti
    path = tmp_path / "000000.txt"
    lines = open(os.path.join(port, "training", "label_2", "000000.txt")).read()
    path.write_text(lines + "Tram 0 0 0 0 0 1 1 1 1 1 1 1 1 0\nDontCare -1 -1 -10 1 2 3 4 -1 -1 -1 -1000 -1000 -1000 -10\n"
                    "garbage row\n\n")
    for got, want in zip(kitti.parse_labels_camera(str(path)), jkitti.parse_labels_camera(str(path))):
        np.testing.assert_array_equal(got, want)
    got = [o.to_kitti_format() for o in kitti.read_label(os.path.join(port, "training", "label_2", "000001.txt"))]
    want = [o.to_kitti_format() for o in jkitti.read_label(os.path.join(port, "training", "label_2", "000001.txt"))]
    assert got == want and got


def test_epoch_sampler_equals_jax_and_shards_are_disjoint():
    for epoch in (0, 3):
        shards = []
        for p in range(3):
            s, js = loader.EpochSampler(17, seed=5, process_index=p, process_count=3), \
                jloader.EpochSampler(17, seed=5, process_index=p, process_count=3)
            s.set_epoch(epoch)
            js.set_epoch(epoch)
            shards.append(list(s))
            assert shards[-1] == list(js)
        flat = [i for sh in shards for i in sh]
        assert sorted(flat) == list(range(17))
    assert list(loader.EpochSampler(5, shuffle=False)) == [0, 1, 2, 3, 4]


def test_uint16_points_round_trip_equal_jax():
    rng = np.random.default_rng(2)
    pts, _ = bev.filter_and_pad_points(synthetic.synthetic_scene(4)[0], max_points=40000)
    q = bev.quantize_points_uint16(pts)
    np.testing.assert_array_equal(q, jbev.quantize_points_uint16(pts))
    import jax

    want = np.asarray(jax.jit(jbev.dequantize_points)(q))  # the loader's jitted form
    got = bev.dequantize_points(torch.from_numpy(q.view(np.int16))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bev.dequantize_points(torch.from_numpy(q)).numpy(), want)
    assert np.abs(got - pts).max() < 1e-3 and rng is not None


def _batch_equal(got, want):
    """A port batch (NCHW raster) against a JAX batch (NHWC raster)."""
    g = got["bev"].permute(0, 1, 3, 4, 2).numpy()
    w = np.asarray(want["bev"])
    assert g.shape == w.shape
    np.testing.assert_array_equal(g[..., :2], w[..., :2])
    np.testing.assert_allclose(g[..., 2], w[..., 2], rtol=0, atol=DENSITY_TOL)
    for k, v in want["targets"].items():
        v = np.asarray(v)
        if k == "hm_cen":
            np.testing.assert_allclose(got["targets"][k].numpy(), v, rtol=HM_RTOL, atol=1e-30)
        elif k == "direction":
            np.testing.assert_allclose(got["targets"][k].numpy(), v, rtol=0, atol=1.2e-7)
        else:
            np.testing.assert_array_equal(got["targets"][k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("point_format", ["float32", "uint16"])
def test_loader_batch_equals_jax(mini_kitti, point_format):
    """One epoch of S = 2 x B = 2 batches at the full 608x608 raster, with
    augmentation and hflip: the port's loader (threaded) against the JAX
    loader, and bev_raster_reduce's plain version ran once per batch."""
    port, ref = mini_kitti
    kw = dict(mode="train", hflip_prob=0.5, seed=3)
    ds = kitti.KittiDataset(port, lidar_aug=augment.default_train_aug(0.9), **kw)
    jds = jkitti.KittiDataset(ref, lidar_aug=jaugment.default_train_aug(0.9), **kw)
    tl = loader.KittiTrainLoader(ds, batch_size=2, subdivisions=2, seed=3, num_workers=2,
                                 point_format=point_format, device="cpu")
    jl = jloader.KittiTrainLoader(jds, batch_size=2, subdivisions=2, seed=3, point_format=point_format)
    tl.set_epoch(1)
    jl.set_epoch(1)
    got, want = list(tl), list(jl)
    assert len(got) == len(want) == len(tl) == 1
    assert got[0]["bev"].shape == (2, 2, 3, 608, 608)
    _batch_equal(got[0], want[0])
    assert got[0]["targets"]["obj_mask"].sum() > 0


def test_sync_and_threaded_loaders_give_the_same_stream(mini_kitti, monkeypatch):
    port, _ = mini_kitti
    small = lambda *a: loader.prepare_train_batch(*a, bev_size=(64, 64), hm_size=(16, 16))  # noqa: E731
    streams = []
    for workers in (0, 3):
        ds = kitti.KittiDataset(port, mode="train", lidar_aug=augment.default_train_aug(0.9),
                                hflip_prob=0.5, seed=1)
        tl = loader.KittiTrainLoader(ds, batch_size=1, subdivisions=2, seed=1, num_workers=workers,
                                     prefetch=1, prepare_fn=small, device="cpu")
        stream = []
        for epoch in (1, 2):
            tl.set_epoch(epoch)
            stream += list(tl)
        streams.append(stream)
    assert len(streams[0]) == len(streams[1]) == 4
    for a, b in zip(*streams):
        assert torch.equal(a["bev"], b["bev"])
        for k in a["targets"]:
            assert torch.equal(a["targets"][k], b["targets"][k]), k
    # the val loader keeps the tail as a smaller batch
    vds = kitti.KittiDataset(port, mode="val")
    vl = loader.KittiTrainLoader(vds, batch_size=3, shuffle=False, drop_last=False, prepare_fn=small,
                                 device="cpu")
    assert [b["bev"].shape[:2] for b in vl] == [(1, 3), (1, 1)]


def test_prepare_train_batch_equals_jax_and_launches_the_raster_once():
    """Two raw scans (one flipped) through prepare_train_batch against the
    JAX jit; the raster's reduce is one call for the whole batch."""
    pts, valid = synthetic.synthetic_batch_points(3, max_points=40000, seed=8)
    labels = np.zeros((3, 50, 8), np.float32)
    for i in range(3):
        lab = synthetic.synthetic_scene(8 + i)[1]
        labels[i, :len(lab)] = lab
    n = np.int32([12, 12, 5])
    hflip = np.array([False, True, True])
    calls = []
    real = loader.points_to_bev_nchw

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    loader.points_to_bev_nchw = counted
    try:
        before = bev_raster_reduce.launches
        got_bev, got_tg = loader.prepare_train_batch(*(torch.from_numpy(a) for a in (pts, valid, labels, n, hflip)))
    finally:
        loader.points_to_bev_nchw = real
    assert len(calls) == 1 and bev_raster_reduce.launches == before  # the CPU takes the plain version
    want_bev, want_tg = jloader.prepare_train_batch(*(jnp.asarray(a) for a in (pts, valid, labels, n, hflip)))
    _batch_equal({"bev": got_bev[None], "targets": {k: v[None] for k, v in got_tg.items()}},
                 {"bev": np.asarray(want_bev)[None], "targets": {k: np.asarray(v)[None] for k, v in want_tg.items()}})
    # frame 1 is frame 1's raster mirrored along W
    plain = bev.points_to_bev_nchw(torch.from_numpy(pts[1:2]), torch.from_numpy(valid[1:2]))
    assert torch.equal(got_bev[1], plain[0].flip(-1))
