"""The port's KITTI evaluation (`ops/rotated_iou.py`, `eval/kitti_eval.py`,
`detector.write_kitti_results`, `cli/eval.py`) against the JAX package's on
the CPU.

- Rotated BEV and 3D IoU on seeded boxes and on identical, contained,
  edge-touching and near-collinear pairs: within 1e-6 of JAX's jitted
  pairwise functions (XLA:CPU contracts some products into FMAs under jit,
  ROADMAP section 3) and within 1e-7 of JAX op by op. The clip step holds
  JAX's on an octagon cut at one corner (9 vertices for 8 slots: the
  overflow adds into the last slot).
- `evaluate_kitti_ap` (with AOS, 3D and BEV) and
  `evaluate_kitti_ap_by_difficulty` (levels and detection heights) within
  1e-7 of JAX's on seeded detections.
- `write_kitti_results` writes JAX's text; `cli/eval` runs two frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.eval import kitti_eval as jeval
from sfa3d_tpu.ops import rotated_iou as jiou
from sfa3d_tpu_torch.eval import kitti_eval as peval
from sfa3d_tpu_torch.ops import rotated_iou as piou

IOU_TOL = 1e-6
AP_TOL = 1e-7
BEV = [0, 1, 4, 5, 6]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread: these tensors are small,
    and in a loaded multi-worker run more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(0, 10, n)
    b[:, 1] = rng.uniform(-5, 5, n)
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3] = rng.uniform(1, 2, n)
    b[:, 4] = rng.uniform(0.5, 3, n)
    b[:, 5] = rng.uniform(0.5, 5, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def special_pairs():
    """(box1, box2) 7-DOF pairs: identical, contained, edge-touching,
    corner-touching, near-collinear edges, disjoint, tiny."""
    base = np.float32([3.0, 1.0, -1.5, 1.5, 2.0, 4.0, 0.3])
    pairs = [(base, base.copy())]
    inner = base.copy()
    inner[4:6] = [1.0, 2.0]
    pairs.append((base, inner))  # contained
    touch = base.copy()
    touch[6] = 0.0
    t2 = touch.copy()
    t2[0] += 4.0  # shares the edge x = 5
    pairs.append((touch, t2))
    t3 = touch.copy()
    t3[:2] += [4.0, 2.0]  # shares one corner
    pairs.append((touch, t3))
    near = base.copy()
    near[6] += np.float32(1e-6)  # edges nearly collinear with base's
    pairs.append((base, near))
    near2 = base.copy()
    near2[0] += np.float32(1e-5)
    pairs.append((base, near2))
    far = base.copy()
    far[0] += 50.0
    pairs.append((base, far))
    tiny = base.copy()
    tiny[4:6] = [1e-3, 1e-3]
    pairs.append((base, tiny))
    return [(a.astype(np.float32), b.astype(np.float32)) for a, b in pairs]


def test_pairwise_rotated_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = seeded_boxes(rng, 40), seeded_boxes(rng, 50)
    specials = special_pairs()
    a = np.concatenate([a, np.stack([p[0] for p in specials])])
    b = np.concatenate([b, np.stack([p[1] for p in specials])])
    got3 = piou.pairwise_iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    gotb = piou.pairwise_iou_bev_rotated(torch.from_numpy(a[:, BEV]), torch.from_numpy(b[:, BEV])).numpy()
    want3 = np.asarray(jiou.pairwise_iou_3d(a, b))
    wantb = np.asarray(jiou.pairwise_iou_bev_rotated(a[:, BEV], b[:, BEV]))
    assert (want3 > 0).sum() > 100
    np.testing.assert_allclose(got3, want3, rtol=0, atol=IOU_TOL)
    np.testing.assert_allclose(gotb, wantb, rtol=0, atol=IOU_TOL)
    # the special pairs on the diagonal of their block, op by op in JAX
    k = len(specials)
    for i in range(k):
        p, q = a[-k + i], b[-k + i]
        with jax.disable_jit():
            w3 = float(jiou.iou_3d(jnp.asarray(p), jnp.asarray(q)))
            wb = float(jiou.iou_bev_rotated(jnp.asarray(p[BEV]), jnp.asarray(q[BEV])))
        assert abs(got3[-k + i, -k + i] - w3) <= 1e-7, (i, got3[-k + i, -k + i], w3)
        assert abs(gotb[-k + i, -k + i] - wb) <= 1e-7, (i, gotb[-k + i, -k + i], wb)
    diag = np.diag(got3[-k:, -k:])
    assert diag[0] == pytest.approx(1.0, abs=1e-6) and diag[1] == pytest.approx(0.25, abs=1e-6)
    assert diag[2] == 0.0 and diag[3] == 0.0 and diag[6] == 0.0


def test_clip_overflow_adds_into_the_last_slot():
    """A regular octagon (8 slots full) cut at one corner emits 9 vertices:
    the ninth adds into slot 7 on both sides, and n stays 8."""
    ang = np.arange(8) * np.pi / 4
    octagon = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    a, b = np.float32([0.9, -1.0]), np.float32([0.9, 1.0])  # keeps x <= 0.9: cuts off the vertex at (1, 0)
    want_v, want_n = jiou._clip_by_halfplane(jnp.asarray(octagon), jnp.int32(8), jnp.asarray(a), jnp.asarray(b))
    got_v, got_n = piou._clip_by_halfplane(torch.from_numpy(octagon)[None], torch.tensor([8]),
                                           torch.from_numpy(a)[None], torch.from_numpy(b)[None])
    assert int(want_n) == int(got_n[0]) == 8
    np.testing.assert_allclose(got_v[0].numpy(), np.asarray(want_v), rtol=0, atol=1e-6)


def seeded_eval_frames(rng, n_frames=6):
    """Detections near the ground truth (some exact, some far), levels and
    projected heights: every class, bucket and the height rule see work."""
    dets, gts = [], []
    for _ in range(n_frames):
        m = int(rng.integers(2, 8))
        g = seeded_boxes(rng, m)
        g[:, 0] = rng.uniform(5, 45, m)
        g[:, 1] = rng.uniform(-15, 15, m)
        cls = rng.integers(0, 3, m)
        gts.append({"boxes": g, "classes": cls, "difficulty": rng.integers(1, 5, m)})
        d = g + rng.normal(0, 0.15, g.shape).astype(np.float32)
        extra = seeded_boxes(rng, 3)
        extra[:, 0] += 10
        d = np.concatenate([d, extra]).astype(np.float32)
        dets.append({"boxes": d, "scores": rng.uniform(0.1, 1.0, len(d)).astype(np.float32),
                     "classes": np.concatenate([cls, rng.integers(0, 3, 3)]),
                     "heights": rng.uniform(10, 80, len(d)).astype(np.float32)})
    return dets, gts


@pytest.mark.parametrize("metric", ["3d", "bev"])
def test_kitti_ap_matches_jax(metric, monkeypatch):
    dets, gts = seeded_eval_frames(np.random.default_rng(1))
    want = jeval.evaluate_kitti_ap(dets, gts, metric=metric, with_aos=True)
    got = peval.evaluate_kitti_ap(dets, gts, metric=metric, with_aos=True, device="cpu")
    assert got.keys() == want.keys() and 0 < want["mAP"] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
    want_t = jeval.evaluate_kitti_ap_by_difficulty(dets, gts, metric=metric)
    got_t = peval.evaluate_kitti_ap_by_difficulty(dets, gts, metric=metric, device="cpu")
    assert got_t.keys() == want_t.keys() == {"Easy", "Moderate", "Hard"}
    for bucket in want_t:
        assert got_t[bucket].keys() == want_t[bucket].keys()
        for k, v in want_t[bucket].items():
            assert abs(got_t[bucket][k] - v) <= AP_TOL, (bucket, k, got_t[bucket][k], v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # cuda unless the caller asks for the CPU
        peval.evaluate_kitti_ap(dets, gts)


def test_write_kitti_results_matches_jax(tmp_path):
    from sfa3d_tpu.detector import write_kitti_results as jwrite
    from sfa3d_tpu.geometry.calibration import KittiCalibration as JCalib
    from sfa3d_tpu_torch.detector import write_kitti_results
    from sfa3d_tpu_torch.geometry.calibration import KittiCalibration

    rng = np.random.default_rng(2)
    dets = [{"class_id": int(c), "class_name": ["Pedestrian", "Car", "Cyclist"][int(c)],
             "score": float(rng.uniform(0.2, 1)), "x": float(rng.uniform(5, 40)), "y": float(rng.uniform(-10, 10)),
             "z": float(rng.uniform(-2, 0)), "h": 1.5, "w": 1.6, "l": 3.9, "yaw": float(rng.uniform(-3, 3))}
            for c in rng.integers(0, 3, 5)]
    write_kitti_results(dets, KittiCalibration(None), str(tmp_path / "port" / "000001.txt"))
    jwrite(dets, JCalib(None), str(tmp_path / "jax" / "000001.txt"))
    text = (tmp_path / "port" / "000001.txt").read_text()
    assert text == (tmp_path / "jax" / "000001.txt").read_text() and len(text.splitlines()) == 5


def test_eval_cli_runs_two_frames(tmp_path, monkeypatch):
    from sfa3d_tpu_torch.cli.eval import main
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti

    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=2, cameras=False)
    res = main(["--dataset_dir", root, "--num_samples", "2", "--platform", "cpu", "--peak_thresh", "0.0",
                "--save_results", str(tmp_path / "res")])
    assert set(res["by_difficulty"]) == {"Easy", "Moderate", "Hard"} and "mAP" in res and "mAOS" in res
    assert sorted(p.name for p in (tmp_path / "res").iterdir()) == ["000000.txt", "000001.txt"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dataset_dir", root, "--num_samples", "1"])
