"""scripts/torch_trained_parity_check.py on the CPU: its comparison (equal
detections pass; a planted 2e-3 difference, a yaw 2e-3 across the +-pi cut
and a count mismatch fail; +pi against -pi and rows whose sort order is
float noise pass), its heatmap witness (a tie an ulp wide against a
planted fault), its main end to end, and the port's per-frame
detections on one BEV within the repo's 1e-3 of JAX's `detect_bev` on the
same BEV and weights (a JAX init carried over by `state_dict_from_jax`,
heatmap bias +2.0)."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DET_TOL = 1e-3


def _load():
    spec = importlib.util.spec_from_file_location("torch_trained_parity_check",
                                                  ROOT / "scripts" / "torch_trained_parity_check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(rng, n):
    rows = np.zeros((n, 8), np.float32)
    rows[:, 0] = rng.integers(0, 3, n)
    rows[:, 1:3] = rng.uniform(-20, 40, (n, 2))
    rows[:, 3:7] = rng.uniform(-2, 4, (n, 4))
    rows[:, 7] = rng.uniform(-np.pi, np.pi, n)
    return rows


def test_comparison_passes_and_fails_as_it_should():
    cmp = _load().compare_detections
    rng = np.random.default_rng(0)
    ours = _rows(rng, 12)
    ref = ours[rng.permutation(12)].copy()
    assert cmp(ours, ref) == (0.0, None)
    assert cmp(ours[:0], ref[:0]) == (0.0, None)

    planted = ref.copy()
    planted[3, 4] += 2e-3
    worst, count = cmp(ours, planted)
    assert count is None and worst > DET_TOL and worst == pytest.approx(2e-3, rel=1e-3)

    ours_pi, ref_pi = ours.copy(), ref.copy()
    ours_pi[0, 7] = np.float32(np.pi)
    ref_pi[np.flatnonzero((ref == ours[0]).all(1))[0], 7] = np.float32(-np.pi)
    worst, _ = cmp(ours_pi, ref_pi)
    assert worst < 1e-6  # +pi and -pi are one angle
    ref_cut = ref_pi.copy()
    ref_cut[np.flatnonzero((ref == ours[0]).all(1))[0], 7] = np.float32(-np.pi + 2e-3)
    assert cmp(ours_pi, ref_cut)[0] == pytest.approx(2e-3, abs=1e-6)  # across the cut: 2e-3, a failure

    assert cmp(ours, ref[:-1]) == (None, {"ours": 12, "ref": 11})

    peaks = np.zeros((3, 10), np.float32)
    peaks[:, 0] = [0.9999, 0.999, 0.5]  # the first at the clamped sigmoid's ceiling
    assert len(_load().saturated(peaks)) == 1

    # one heatmap row: one class, x equal to within float noise, y apart
    row = np.tile(ours[:1], (3, 1))
    row[:, 2] = [1.0, 5.0, 9.0]
    noisy = row.copy()
    noisy[:, 1] += np.float32([2e-6, -2e-6, 0.0])
    assert cmp(row, noisy)[0] < 1e-5


def test_heatmap_witness_tells_a_tie_from_a_fault():
    mod = _load()
    rng = np.random.default_rng(1)
    ref = rng.uniform(0.0, 0.1, (12, 16, 3)).astype(np.float32)
    ref[4, 5, 1], ref[4, 6, 1] = 0.6, np.nextafter(np.float32(0.6), np.float32(1))  # a near-tie pair
    ref[9, 12, 2] = 0.7
    ours = ref.copy()
    ours[4, 5, 1] = ref[4, 6, 1]  # one ulp up: an exact tie, both cells peaks
    tie = mod.peak_flips(ours, ref, 0.2)
    assert tie["gap"] == pytest.approx(6e-8, rel=0.2) and len(tie["flips"]) == 1
    flip = tie["flips"][0]
    assert (flip["y"], flip["x"], flip["cls"]) == (4, 5, 1)
    assert max(abs(flip["ours_margin"]), abs(flip["ref_margin"])) <= 2 * tie["gap"]
    assert sorted(tie["ref_peak_margins"] >= 0) == [True, True]  # (4, 6, 1) and (9, 12, 2)

    fault = ours.copy()
    fault[9, 12, 2], fault[2, 2, 0] = 0.05, 0.5  # one peak lost, another made: a large gap
    far = mod.peak_flips(fault, ref, 0.2)
    assert far["gap"] == pytest.approx(0.65, abs=1e-6) and len(far["flips"]) == 3
    assert max(max(abs(f["ours_margin"]), abs(f["ref_margin"])) for f in far["flips"]) > 0.3

    w = mod.Witness(keep=2)
    w.add(7, tie, 0.0, None, 1e-3)
    w.add(8, far, None, {"ours": 2, "ref": 1}, 1e-3)
    rep = w.report(0.2)
    assert rep["heatmap_worst_gap"] == far["gap"] and rep["peak_flips_above_threshold"] == 4
    assert rep["frames_with_flips"] == 2 and rep["frames_with_count_mismatch"] == 1 and len(rep["flips"]) == 2
    assert rep["ref_peaks_above_threshold"] == 4 and rep["ref_peaks_within_two_gaps"] == 4

    bev = torch.tensor([[0.0, 1.0], [0.5, -2.0]])
    up = mod.one_ulp_up(bev)
    assert up[0, 0] == 0 and bool((up[bev != 0] > bev[bev != 0]).all())
    assert torch.equal(up[bev != 0], torch.nextafter(bev, torch.full_like(bev, float("inf")))[bev != 0])


def _jax_kfpn():
    from sfa3d_tpu.models import create_model as jcreate_model
    from sfa3d_tpu.pipeline import init_detector

    jmodel = jcreate_model("fpn_resnet_18")
    variables = jax.tree_util.tree_map(np.array, init_detector(jmodel, jax.random.PRNGKey(0)))
    for i in range(3):  # random weights then give peaks above the threshold
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
    return jmodel, variables


def test_port_detections_on_one_bev_match_jax_and_main_runs(tmp_path):
    from sfa3d_tpu.data.synthetic import synthetic_scene
    from sfa3d_tpu.ops.bev import filter_and_pad_points, points_to_bev
    from sfa3d_tpu.pipeline import detect_bev
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.models.port import state_dict_from_jax

    mod = _load()
    jmodel, variables = _jax_kfpn()
    sd = state_dict_from_jax(variables)
    model = create_model("fpn_resnet_18")
    model.load_state_dict(sd, strict=True)
    model.eval()
    n_compared = 0
    for seed in (11, 12):
        pts, valid = filter_and_pad_points(synthetic_scene(seed=seed)[0])
        bev = points_to_bev(jnp.asarray(pts), jnp.asarray(valid))
        _, _, boxes_real, mask = detect_bev(jmodel, variables, bev[None], K=50, peak_thresh=0.2)
        want = np.asarray(boxes_real)[0][np.asarray(mask)[0]]
        got = mod.detect_rows(model, torch.from_numpy(np.array(bev)), 50, 0.2)[0]
        worst, count = mod.compare_detections(got, want)
        assert count is None and worst <= DET_TOL
        n_compared += len(got)
    assert n_compared > 0

    # main on the CPU (both sides there: the smoke) over a two-frame split
    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=2, cameras=False)
    ckpt = tmp_path / "w.pth"
    torch.save({"state_dict": sd, "ema_params": {k: v for k, v in sd.items() if "running" not in k
                                                 and "num_batches" not in k}}, ckpt)
    out = tmp_path / "p.json"
    rc = mod.main(["--dataset_dir", root, "--pretrained_path", str(ckpt), "--use_ema", "--num_samples", "2",
                   "--platform", "cpu", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rc == 0 and rep["pass"] and rep["frames"] == 2 and rep["total_detections_compared"] > 0
    assert rep["worst_abs_diff"] == 0.0 and rep["count_mismatch"] is None and rep["count_mismatches"] == []
    assert rep["worst_topk_score_diff"] == 0.0 and rep["peaks_at_ceiling"]["total"] >= 0
    assert rep["raster_card_vs_cpu"]["pass"] and rep["device"] == {"platform": "cpu"}
    same = rep["heatmap_card_vs_cpu"]  # both sides on the CPU: one heatmap
    assert same["heatmap_worst_gap"] == 0.0 and same["peak_flips_above_threshold"] == 0
    assert same["ref_peaks_above_threshold"] >= rep["total_detections_compared"]
    ulp = rep["cpu_vs_cpu_one_ulp"]
    assert 0.0 < ulp["heatmap_worst_gap"] < 1e-3 and ulp["ref_peaks_above_threshold"] == same["ref_peaks_above_threshold"]
    for key in ("checkpoint", "use_ema", "atol", "worst_frames", "note", "launches"):
        assert key in rep

    # a detection on one side only (a score across the threshold) fails the
    # run, is recorded with the scores nearest the threshold, and the other
    # frames are still compared
    real_rows, calls = mod.detect_rows, []

    def one_side_short(model, bev, K, peak_thresh):
        rows, peaks, heat = real_rows(model, bev, K, peak_thresh)
        calls.append(1)
        return (rows[:-1], peaks, heat) if len(calls) == 2 else (rows, peaks, heat)

    mod.detect_rows = one_side_short
    rc = mod.main(["--dataset_dir", root, "--pretrained_path", str(ckpt), "--num_samples", "2",
                   "--platform", "cpu", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rc == 1 and not rep["pass"] and len(rep["count_mismatches"]) == 1
    miss = rep["count_mismatch"]
    assert miss["ours"] == miss["ref"] + 1 and len(miss["ref_scores_nearest_threshold"]) == 2
    assert miss["ours_peaks_at_ceiling"] == miss["ref_peaks_at_ceiling"]
    assert rep["total_detections_compared"] > 0  # the second frame
