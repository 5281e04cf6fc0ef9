"""scripts/torch_argoverse_check.py's `eval_ckpt` against its JAX twin in
scripts/argoverse_check.py, on the CPU, on a tiny `write_mini_argoverse`
root and weights carried over from a JAX init (`state_dict_from_jax`;
heatmap bias +2.0, dim biases raised to car-sized boxes): the crop-frame
ground truth equal, the crop-frame detections within the repo's 1e-3, the
BEV AP equal. Then the script's main end to end with a stub trainer."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DET_TOL = 1e-3
DIM_BIAS = (1.5, 1.6, 3.9)  # m: car-sized boxes (random weights give millimetres)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables():
    from sfa3d_tpu.models import create_model as jcreate_model
    from sfa3d_tpu.pipeline import init_detector

    variables = jax.tree_util.tree_map(np.array, init_detector(jcreate_model("fpn_resnet_18"),
                                                               jax.random.PRNGKey(0)))
    for i in range(3):
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
        variables["params"][f"fpn{i}_dim"]["conv2"]["bias"] += np.float32(DIM_BIAS)
    return variables


def _capture(module, seen):
    real = module.evaluate_kitti_ap

    def evaluate(dets, gts, **kw):
        seen.append((dets, gts, kw))
        return real(dets, gts, **kw)

    return evaluate


def _paired_gap(a, b):
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    i, j = linear_sum_assignment(cost)
    return float(cost[i, j].max())


def test_eval_ckpt_matches_jax(tmp_path, monkeypatch):
    import sfa3d_tpu.eval
    import sfa3d_tpu.models
    import sfa3d_tpu_torch.eval
    from sfa3d_tpu_torch.data.argoverse import write_mini_argoverse
    from sfa3d_tpu_torch.models.port import state_dict_from_jax

    root = write_mini_argoverse(str(tmp_path / "val"), n_frames=2, seed=700000)
    variables = _jax_variables()
    ckpt = tmp_path / "w.pth"
    torch.save({"state_dict": state_dict_from_jax(variables)}, ckpt)
    seen_jax, seen_port = [], []
    real_jax, real_port = sfa3d_tpu.eval.evaluate_kitti_ap, sfa3d_tpu_torch.eval.evaluate_kitti_ap
    monkeypatch.setattr(sfa3d_tpu.models, "load_variables", lambda *a, **kw: variables)
    monkeypatch.setattr(sfa3d_tpu.eval, "evaluate_kitti_ap", _capture(sfa3d_tpu.eval, seen_jax))
    monkeypatch.setattr(sfa3d_tpu_torch.eval, "evaluate_kitti_ap", _capture(sfa3d_tpu_torch.eval, seen_port))

    want = _load("argoverse_check").eval_ckpt(str(ckpt), root, 2, 0.2, False)
    got = _load("torch_argoverse_check").eval_ckpt(str(ckpt), root, 2, 0.2, False, device="cpu")

    (jd, jg, jkw), (pd, pg, pkw) = seen_jax[0], seen_port[0]
    assert pkw["metric"] == jkw["metric"] == "bev" and pkw["iou_thresholds"] == jkw["iou_thresholds"]
    n_det = 0
    for d_p, d_j, g_p, g_j in zip(pd, jd, pg, jg):
        np.testing.assert_array_equal(g_p["classes"], g_j["classes"])
        np.testing.assert_array_equal(g_p["boxes"], np.asarray(g_j["boxes"]))
        assert len(d_p["scores"]) == len(d_j["scores"])
        np.testing.assert_array_equal(np.sort(d_p["classes"]), np.sort(d_j["classes"]))
        rows_p = np.concatenate([d_p["classes"][:, None], d_p["boxes"], d_p["scores"][:, None]], 1)
        rows_j = np.concatenate([d_j["classes"][:, None], d_j["boxes"], d_j["scores"][:, None]], 1)
        if len(rows_p):
            assert _paired_gap(rows_p, rows_j.astype(np.float64)) <= DET_TOL
        n_det += len(rows_p)
    assert n_det > 0 and sum(len(g["classes"]) for g in pg) > 0
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    # random weights score 0: the crop-frame ground truth added to the
    # detections (score 0.5) gives both evaluators a non-trivial AP
    mixed = [{"boxes": np.concatenate([d["boxes"], g["boxes"]]), "scores": np.concatenate(
        [d["scores"], np.full(len(g["classes"]), 0.5, np.float32)]), "classes": np.concatenate(
        [d["classes"], g["classes"]])} for d, g in zip(pd, pg)]
    ap_port = real_port(mixed, pg, **pkw)
    ap_jax = real_jax(mixed, pg, **jkw)
    assert 0 < ap_port["mAP"] < 1
    for k in ap_jax:
        assert ap_port[k] == pytest.approx(ap_jax[k], abs=1e-6), k


STUB_TRAINER = '''
import argparse, os, sys
p = argparse.ArgumentParser()
p.add_argument("--root-dir", dest="root_dir")
p.add_argument("--num_epochs", type=int)
p.add_argument("--checkpoint_freq", type=int)
p.add_argument("--saved_fn")
p.add_argument("--dataset")
args, _ = p.parse_known_args(sys.argv[1:])
assert args.dataset == "argoverse"
out = os.path.join(args.root_dir, "checkpoints", args.saved_fn)
os.makedirs(out, exist_ok=True)
for epoch in range(args.checkpoint_freq, args.num_epochs + 1, args.checkpoint_freq):
    open(os.path.join(out, "Model_%s_epoch_%d.pth" % (args.saved_fn, epoch)), "wb").write(b"x")
'''


def test_main_curve_and_gate(tmp_path, monkeypatch):
    mod = _load("torch_argoverse_check")
    stub = tmp_path / "stub.py"
    stub.write_text(STUB_TRAINER)
    cmds, evals = [], []
    real_cmd = mod.train_cmd

    def train_cmd(args, train_root, tmp):
        cmds.append(real_cmd(args, train_root, tmp))
        return [sys.executable, str(stub)] + cmds[-1][cmds[-1].index("train") + 1:]

    def eval_ckpt(ckpt, val_root, n_val, peak_thresh, use_ema, device=None):
        evals.append((Path(ckpt).name, Path(val_root).name, n_val, use_ema, str(device)))
        m = {"Model_argo_epoch_1.pth": 0.1, "Model_argo_epoch_2.pth": 0.3}[Path(ckpt).name]
        return {"mAP": m, "AP_0": m, "AP_1": m, "AP_2": m}

    monkeypatch.setattr(mod, "train_cmd", train_cmd)
    monkeypatch.setattr(mod, "eval_ckpt", eval_ckpt)
    flags = ["--platform", "cpu", "--frames_train", "2", "--frames_val", "1", "--epochs", "2",
             "--checkpoint_freq", "1", "--out", str(tmp_path / "a.json")]
    assert mod.main(flags) == 0
    rep = json.loads((tmp_path / "a.json").read_text())
    assert [r["epoch"] for r in rep["val_curve"]] == [1, 2]
    assert rep["best"]["epoch"] == 2 and rep["final"]["epoch"] == 2 and rep["climbed"]
    assert evals == [(f"Model_argo_epoch_{e}.pth", "val", 1, True, "cpu") for e in (1, 2)]
    cmd = cmds[0]
    assert cmd[1:4] == ["-m", "sfa3d_tpu_torch.cli", "train"] and "--compute_dtype" not in cmd
    assert cmd[cmd.index("--dataset") + 1] == "argoverse" and "--compilation_cache" not in cmd
    assert mod.main(flags + ["--min_final_map", "0.5", "--pretrained_path", "w.pth"]) == 1
    assert cmds[-1][cmds[-1].index("--pretrained_path") + 1] == "w.pth"
    assert mod.main(flags + ["--min_final_map", "0.5", "--smoke"]) == 0
