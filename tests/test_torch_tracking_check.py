"""scripts/torch_tracking_check.py against its JAX twin,
scripts/tracking_check.py, on the CPU: the oracle-mode CLEAR-MOT summary
exactly (the tracker is bit-equal to JAX's on the CPU), and
`detect_sequence` within the repo's 1e-3 detection tolerance on weights
carried over from a JAX init (`state_dict_from_jax`, heatmap bias +2.0)."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
DET_TOL = 1e-3  # the repo's detection parity tolerance
ORACLE_FLAGS = ["--oracle", "--n_seqs", "1", "--n_frames", "6", "--n_objects", "4"]


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


def test_oracle_summary_equals_jax(tmp_path):
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    _load("tracking_check").main(ORACLE_FLAGS + ["--cpu", "--out", str(jax_out)])
    rc = _load("torch_tracking_check").main(ORACLE_FLAGS + ["--platform", "cpu", "--out", str(port_out)])
    want, got = json.loads(jax_out.read_text()), json.loads(port_out.read_text())
    assert rc == 0
    assert got["summary"] == want["summary"]
    assert got["summary"]["overall"]["n_gt"] == 24  # 4 objects x 6 frames: not vacuous
    for g, w in zip(got["per_seq"], want["per_seq"]):
        assert {k: g[k] for k in w} == w
        assert len(g["track_ids"]) == 6
    for key in ("mode", "config"):
        assert got[key] == want[key]
    assert got["device"] == {"platform": "cpu"} and set(got["launches"].values()) == {0}


def test_oracle_gate_exit_code(tmp_path):
    mod = _load("torch_tracking_check")
    flags = ORACLE_FLAGS + ["--platform", "cpu", "--out", str(tmp_path / "t.json"), "--min_idf1", "1.01"]
    assert mod.main(flags) == 1
    assert mod.main(flags + ["--smoke"]) == 0


def _jax_kfpn():
    from sfa3d_tpu.models import create_model as jcreate_model
    from sfa3d_tpu.pipeline import init_detector

    jmodel = jcreate_model("fpn_resnet_18")
    variables = jax.tree_util.tree_map(np.array, init_detector(jmodel, jax.random.PRNGKey(0)))
    for i in range(3):  # random weights then give peaks above the threshold
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
    return jmodel, variables


def test_detect_sequence_matches_jax():
    from sfa3d_tpu.data.synthetic import moving_scene_sequence
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.models.port import state_dict_from_jax

    jmodel, variables = _jax_kfpn()
    model = create_model("fpn_resnet_18")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    frames = moving_scene_sequence(3, seed=777000, n_objects=4)
    args = SimpleNamespace(K=50, peak_thresh=0.3)
    want = _load("tracking_check").detect_sequence(jmodel, variables, frames, args)
    got = _load("torch_tracking_check").detect_sequence(model, torch.device("cpu"), frames, args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    (gb, gs, gv), (wb, ws, wv) = got, want
    assert wv.sum() > 0, "no detection above the threshold: the comparison would be vacuous"
    for f in range(len(frames)):
        assert gv[f].sum() == wv[f].sum()
        a = np.concatenate([gb[f][gv[f]], gs[f][gv[f]][:, None]], 1)
        b = np.concatenate([wb[f][wv[f]], ws[f][wv[f]][:, None]], 1)
        assert paired_gap(a, b) <= DET_TOL


def paired_gap(a, b):
    """Largest field difference of two equal-size detection sets [cls, ...]
    paired one to one within a class by an optimal assignment (random
    weights give detections of one heatmap row the same x to within float
    noise, so no sort pairs them reliably)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    cost[a[:, None, 0] != b[None, :, 0]] = np.inf
    i, j = linear_sum_assignment(cost)
    return float(cost[i, j].max())
