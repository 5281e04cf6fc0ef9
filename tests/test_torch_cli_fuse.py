"""`python -m sfa3d_tpu_torch.cli fuse --platform cpu` against the JAX
package's `cli/fuse.py` main, in the modes nms, weighted and bayesian and in
bayesian --gaussian_nms at sigma 0.5 and 0.3, `--side_by_side` in the first.
One setup for both: a one-frame mini-KITTI of the JAX writer, one `.pth`
from a JAX KFPN init (centre-heatmap biases + 2.0), one ultralytics `.pt`
from a JAX YOLOv8n init (`save_ultralytics_checkpoint`, DFL mass on bin 2),
`--imgsz 64 --confidence_threshold 0.0 --peak_thresh 0.0` (YOLO boxes at
confidence 0 exercise every label path). Each package's `fuse_frame` is
wrapped to record its inputs and result; the JAX runner's images are
captured where it hands them to `cv2.imwrite`, the port's where it hands
them to `data/png.py::write_image_bgr` (each file is checked to be the
JPEG bytes of its array, cv2.imencode's).

Tolerances: the port's `fuse_frame` on JAX's inputs equals JAX's result
(boxes, classes and sources exactly, scores within 1.2e-7, the soft-NMS IoU
ulp measured at every sigma); the two runners' network outputs within 1e-3;
`summary.txt` equal text; the images equal pixel for pixel, the FPS
header's box masked (its text differs run to run).
"""

import contextlib
import io
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

SCORE_TOL = 1.2e-7
CONFIGS = {
    "nms": ["--mode", "nms", "--side_by_side"],
    "weighted": ["--mode", "weighted"],
    "bayesian": ["--mode", "bayesian"],
    "bayesian-gaussian-0.5": ["--mode", "bayesian", "--gaussian_nms"],
    "bayesian-gaussian-0.3": ["--mode", "bayesian", "--gaussian_nms", "--gaussian_sigma", "0.3"],
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_weights(root):
    """(.pth of a JAX KFPN init with the heatmap bump, .pt of a JAX YOLOv8n
    init with DFL mass on bin 2)."""
    from sfa3d_tpu.models import create_model
    from sfa3d_tpu.models.port import export_kfpn_state_dict
    from sfa3d_tpu.models.yolov8 import YOLOv8, save_ultralytics_checkpoint
    from sfa3d_tpu.pipeline import init_detector

    variables = jax.tree_util.tree_map(np.array, init_detector(create_model("fpn_resnet_18"), jax.random.PRNGKey(0)))
    for i in range(3):
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
    pth = str(root / "kfpn.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_kfpn_state_dict(variables).items()}, pth)
    yvars = jax.tree_util.tree_map(
        np.array, YOLOv8(scale="n").init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3), jnp.float32), train=False))
    for i in range(3):
        yvars["params"]["detect"][f"cv2_{i}_2"]["bias"].reshape(4, 16)[:, 2] += 4.0
    pt = str(root / "yolo.pt")
    save_ultralytics_checkpoint(yvars, pt, scale="n", num_classes=80)
    return pth, pt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_kitti

    root = tmp_path_factory.mktemp("cli_fuse")
    kitti = write_mini_kitti(str(root / "kitti"), n_frames=1)
    pth, pt = write_weights(root)
    return kitti, pth, pt, root


def _recording(module, calls):
    real = module.fuse_frame

    def fuse_frame(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    return real, fuse_frame


@contextlib.contextmanager
def port_images(out):
    """The arrays the port hands to its image writer while the block runs,
    by path relative to `out`; afterwards each file must be the JPEG bytes
    of its array (cv2.imencode's)."""
    import sfa3d_tpu_torch.data.png as tpng

    images = {}
    real = tpng.write_image_bgr

    def write_image_bgr(path, img):
        images[os.path.relpath(path, out)] = np.array(img)
        real(path, img)

    tpng.write_image_bgr = write_image_bgr
    try:
        yield images
    finally:
        tpng.write_image_bgr = real
    for name, img in images.items():
        with open(os.path.join(out, name), "rb") as f:
            assert f.read() == cv2.imencode(".jpg", img)[1].tobytes(), name


@pytest.fixture(scope="module")
def runs(setup):
    """Per config: both runners' fuse_frame calls, images and summary."""
    import sfa3d_tpu.fusion.pipeline as jpipeline
    import sfa3d_tpu_torch.fusion.pipeline as tpipeline
    from sfa3d_tpu.cli import fuse as jfuse
    from sfa3d_tpu_torch.cli import fuse as tfuse

    kitti, pth, pt, root = setup
    base = ["--dataset_dir", kitti, "--pretrained_path", pth, "--yolo_weights", pt, "--imgsz", "64",
            "--confidence_threshold", "0.0", "--peak_thresh", "0.0"]
    results = {}
    for name, flags in CONFIGS.items():
        jout, tout = str(root / f"jax_{name}"), str(root / f"port_{name}")
        jcalls, tcalls, jimages = [], [], {}
        real_imwrite = cv2.imwrite
        jreal, jrec = _recording(jpipeline, jcalls)
        treal, trec = _recording(tpipeline, tcalls)
        cv2.imwrite = lambda path, img: jimages.__setitem__(os.path.basename(path), np.array(img)) or True
        jpipeline.fuse_frame, tpipeline.fuse_frame = jrec, trec
        try:
            with contextlib.redirect_stdout(io.StringIO()), port_images(tout) as timages:
                jfuse.main(base + flags + ["--output_dir", jout])
                tfuse.main(base + flags + ["--output_dir", tout, "--platform", "cpu"])
        finally:
            cv2.imwrite = real_imwrite
            jpipeline.fuse_frame, tpipeline.fuse_frame = jreal, treal
        results[name] = {
            "jax_calls": jcalls, "port_calls": tcalls, "jax_images": jimages, "port_images": timages,
            "jax_summary": open(os.path.join(jout, "summary.txt")).read(),
            "port_summary": open(os.path.join(tout, "summary.txt")).read(),
        }
    return results


def header_mask(shape):
    """The FPS header's box at (10, 25), scale 0.8, thickness 2, grown to the
    widest and deepest header the runners draw."""
    from sfa3d_tpu_torch.viz import raster

    sizes = [raster.get_text_size(f"{mode} fusion  99999.9 FPS", raster.FONT_HERSHEY_SIMPLEX, 0.8, 2)
             for mode in ("artifact", "bayesian", "weighted", "nms")]
    w, h, base = (max(s[0][0] for s in sizes), max(s[0][1] for s in sizes), max(s[1] for s in sizes))
    mask = np.zeros(shape[:2], bool)
    mask[max(25 - h - 3, 0):25 + base + 3, 0:10 + w + 3] = True
    return mask


@pytest.mark.parametrize("config", list(CONFIGS))
def test_port_fuse_frame_on_jax_inputs_equals_jax(runs, config):
    from sfa3d_tpu_torch.fusion.pipeline import fuse_frame

    (args, kwargs, want), = runs[config]["jax_calls"]
    got = fuse_frame(*args, **kwargs, device="cpu")
    assert len(want["boxes"]) > 0
    for key in ("boxes", "classes", "source"):
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_network_outputs_within_1e3(runs, config):
    (jargs, jkw, _), = runs[config]["jax_calls"]
    (targs, tkw, _), = runs[config]["port_calls"]
    jyb, jys, jyc, jreal, jscore, jmask = (np.asarray(a) for a in jargs[:6])
    tyb, tys, tyc, treal, tscore, tmask = (np.asarray(a) for a in targs[:6])
    assert np.array_equal(jmask, tmask) and jmask.sum() > 0
    np.testing.assert_allclose(treal[tmask], jreal[jmask], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tscore, jscore, rtol=0, atol=1e-3)
    assert len(tys) == len(jys) > 0
    np.testing.assert_allclose(np.sort(tys), np.sort(jys), rtol=0, atol=1e-3)
    for key in ("mode", "use_gaussian_nms", "gaussian_sigma", "confidence_threshold"):
        assert jkw[key] == tkw[key]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_summary_is_equal_text(runs, config):
    assert runs[config]["port_summary"] == runs[config]["jax_summary"]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_images_within_the_band(runs, config):
    """Every image equals JAX's pixel for pixel (LINE_8 rectangles, text at
    scale 0.5 and 0.8), but for the `_fused` image's FPS header."""
    r = runs[config]
    assert sorted(r["port_images"]) == sorted(r["jax_images"])
    for name, a in r["jax_images"].items():
        b = r["port_images"][name]
        assert a.shape == b.shape, name
        keep = ~header_mask(a.shape) if name.endswith("_fused.jpg") else np.ones(a.shape[:2], bool)
        assert np.array_equal(a[keep], b[keep]), name
    if config == "nms":
        assert {"000000_yolov8.jpg", "000000_sfa3d.jpg", "000000_fused.jpg"} <= set(r["port_images"])
