"""The PyTorch port stands alone: it imports with JAX, the JAX package, cv2,
PIL, matplotlib and ultralytics absent, its sources import none of them,
and its entry points never fall back to the CPU on their own."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sfa3d_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "sfa3d_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "scripts" / "torch_check_common.py"]
FORBIDDEN_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|sfa3d_tpu|cv2|PIL|matplotlib|ultralytics)\b",
                              re.MULTILINE)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(sfa3d_tpu_torch.__path__, "sfa3d_tpu_torch.")
    )


def test_port_imports_without_jax():
    modules = _port_modules()
    for name in ("ops.bev_counts", "ops.fusion_loops", "models.yolov8", "fusion.batch",
                 "fusion.pipeline", "geometry.calibration", "runtime.serving", "ops.targets",
                 "losses.losses", "data.loader", "data.kitti", "data.synthetic", "data.augment",
                 "parallel.train_step", "runtime.schedules", "runtime.checkpoint", "runtime.logger",
                 "config.train", "cli.train", "data.png", "data.yolo2d", "losses.yolo_loss",
                 "parallel.yolo_step", "eval.map2d", "eval.kitti_eval", "ops.rotated_iou", "cli.yolo_train",
                 "cli.eval", "tracking.tracker", "tracking.metrics", "ops.track_associate",
                 "runtime.tracking_service", "cli.serve", "models.centernet_deconv", "config.argoverse",
                 "geometry.se3", "geometry.argoverse_calib", "data.argoverse", "cli.argoverse_test",
                 "runtime.export", "cli.export", "cli.__main__", "viz.raster", "viz.hershey", "viz.draw",
                 "viz.bev_projection", "cli.test", "cli.fuse", "data.jpeg", "data.avi", "cli.demo", "cli.track",
                 "viz.kfpn_viz", "slam.pnp", "slam.epipolar", "slam.calib_sources", "slam.orb",
                 "slam.stereo", "cli.slam", "cli.stereo_calib", "native", "collectives", "parallel.mesh"):
        assert f"sfa3d_tpu_torch.{name}" in modules
    code = (
        "import sys\n"
        "for banned in ('jax', 'sfa3d_tpu', 'cv2', 'PIL', 'matplotlib', 'ultralytics'):\n"
        "    sys.modules[banned] = None\n"
        "import importlib\n"
        f"for name in {modules!r} + ['sfa3d_tpu_torch', 'chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "import sfa3d_tpu_torch.fusion as f\n"
        "assert f.build_fused_pipeline and f.hard_nms and f.fuse_frame\n"
        "assert not [m for m in sys.modules if m.startswith(('jax.', 'flax', 'sfa3d_tpu.', 'cv2.', 'PIL.', 'matplotlib.'))]\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_has_no_jax_import(path):
    hits = FORBIDDEN_IMPORT.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


CHECK_SCRIPTS = [ROOT / "scripts" / "torch_overfit_check.py", ROOT / "scripts" / "torch_bf16_audit.py",
                 ROOT / "scripts" / "torch_bf16_compare.py", ROOT / "scripts" / "torch_generalize_check.py",
                 ROOT / "scripts" / "torch_trained_parity_check.py", ROOT / "scripts" / "torch_tracking_check.py",
                 ROOT / "scripts" / "torch_fusion_check.py", ROOT / "scripts" / "torch_argoverse_check.py",
                 ROOT / "scripts" / "torch_check_runs.py"]
# the JAX check scripts' ports: the arguments each needs to get past its parser
JAX_CHECK_PORTS = {
    "torch_generalize_check.py": [],
    "torch_trained_parity_check.py": ["--dataset_dir", "d", "--pretrained_path", "p"],
    "torch_tracking_check.py": ["--oracle"],
    "torch_fusion_check.py": ["--dataset_dir", "d", "--pretrained_path", "p"],
    "torch_argoverse_check.py": [],
}


@pytest.mark.parametrize("path", CHECK_SCRIPTS, ids=lambda p: p.name)
def test_check_scripts_import_no_jax(path):
    """The port's check scripts import nothing banned, at their top or in
    their functions, and load and parse their flags with JAX absent."""
    assert not FORBIDDEN_IMPORT.findall(path.read_text())
    code = (
        "import sys, importlib.util\n"
        "for banned in ('jax', 'sfa3d_tpu', 'cv2', 'PIL', 'matplotlib', 'ultralytics'):\n"
        "    sys.modules[banned] = None\n"
        f"spec = importlib.util.spec_from_file_location('script', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "try:\n"
        "    mod.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "assert not [m for m in sys.modules if m.startswith(('jax.', 'flax', 'sfa3d_tpu.', 'cv2.', 'PIL.'))]\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("name", sorted(JAX_CHECK_PORTS))
def test_check_scripts_run_on_cuda_and_raise_without_gpu(monkeypatch, tmp_path, name):
    """The five ports of the JAX check scripts run on cuda by default and
    raise without a GPU before they write or read anything; none writes a
    JAX artefact by default."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name[:-3], ROOT / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(JAX_CHECK_PORTS[name] + ["--out", str(tmp_path / "out.json")])
    assert not list(tmp_path.iterdir())
    default_out = re.search(r'"--out", default=os\.path\.join\(_ROOT, "(\w+\.json)"\)',
                            (ROOT / "scripts" / name).read_text())
    assert default_out and default_out.group(1).startswith("TORCH_")


def test_detector_raises_without_gpu(monkeypatch):
    from sfa3d_tpu_torch.detector import Detector
    from sfa3d_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Detector()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_detect_frames_raises_without_gpu(monkeypatch):
    import numpy as np

    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.pipeline import detect_frames

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = create_model("fpn_resnet_18").eval()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect_frames(model, np.zeros((1, 8, 4), np.float32), np.zeros((1, 8), bool))


def test_fused_entry_points_raise_without_gpu(monkeypatch):
    from sfa3d_tpu_torch.detector import FusedDetector
    from sfa3d_tpu_torch.fusion.batch import build_fused_pipeline
    from sfa3d_tpu_torch.fusion.pipeline import fuse_frame
    from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8, YOLOv8Detector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedDetector()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLOv8Detector()
    run = build_fused_pipeline(create_model("fpn_resnet_18").eval(), YOLOv8().eval())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(*([None] * 9))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fuse_frame([], [], [], [[0] * 8], [0.0], [False], KittiCalibration(None), (375, 1242))


def test_training_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    from sfa3d_tpu_torch.cli.train import main
    from sfa3d_tpu_torch.config.train import OptimConfig, parse_train_configs
    from sfa3d_tpu_torch.data.loader import create_train_loader
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.parallel import make_eval_step, make_train_step
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = create_model("fpn_resnet_18")
    tx = create_optimizer(OptimConfig(), 1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(model, tx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_eval_step(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--dataset_dir", str(tmp_path), "--root-dir", str(tmp_path)])
    (tmp_path / "ImageSets").mkdir()
    (tmp_path / "ImageSets" / "train.txt").write_text("000000\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_loader(parse_train_configs(["--dataset_dir", str(tmp_path)]))
    # asked for, the CPU works; a model elsewhere than the step's device is refused
    make_train_step(model, tx, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="lies on"):
        make_train_step(model, tx, device="cuda")


def test_yolo_training_and_eval_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    from sfa3d_tpu_torch.cli.eval import main as eval_main
    from sfa3d_tpu_torch.cli.yolo_train import main as yolo_main
    from sfa3d_tpu_torch.eval import evaluate_kitti_ap
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8
    from sfa3d_tpu_torch.parallel.yolo_step import make_yolo_epoch_fn, make_yolo_eval_fn
    from sfa3d_tpu_torch.runtime.schedules import yolo_adamw

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = YOLOv8("n", 3)
    tx = yolo_adamw(1e-3, 5e-4, 1.0, 4, 1)
    for call in (lambda: make_yolo_epoch_fn(model, tx, (64, 128)), lambda: make_yolo_eval_fn(model),
                 lambda: yolo_main(["--dataset_dir", str(tmp_path)]),
                 lambda: eval_main(["--dataset_dir", str(tmp_path)]), lambda: evaluate_kitti_ap([], [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    make_yolo_epoch_fn(model, tx, (64, 128), device="cpu")
    make_yolo_eval_fn(model, device="cpu")


def test_tracking_and_serving_entry_points_raise_without_gpu(monkeypatch):
    from sfa3d_tpu_torch.runtime.tracking_service import TrackingSessions
    from sfa3d_tpu_torch.tracking import init_tracks, track_sequence

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_tracks(8), lambda: TrackingSessions(),
                 lambda: track_sequence([[[0.0] * 8]], [[0.0]], [[False]])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert init_tracks(8, "cpu").device == torch.device("cpu")


def test_count_kernel_has_no_silent_fallback():
    """Only CPU tensors take the plain version; any other device raises."""
    from sfa3d_tpu_torch.ops.bev_counts import bev_cell_counts, bev_raster_reduce

    row = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bev_cell_counts(row, row)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bev_raster_reduce(row, row, row)
    i64 = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        bev_cell_counts(i64, i64)
    with pytest.raises(TypeError, match="int32"):
        bev_raster_reduce(i64, i64, i64)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the launch path of
    a wrapper without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("entry,refused", [
    pytest.param("bev_cell_counts", "bev_cell_counts_cuda", id="bev_cell_counts"),
    pytest.param("bev_raster_reduce", "bev_raster_reduce_cuda", id="bev_raster_reduce"),
    pytest.param("argoverse_raster_reduce", "argoverse_raster_reduce_cuda", id="argoverse_raster_reduce"),
    pytest.param("argoverse_raster_reduce", "bev_smem_limit", id="argoverse_raster_reduce-smem_query"),
    pytest.param("argoverse_raster_reduce", "bev_sm_count", id="argoverse_raster_reduce-sm_query"),
])
def test_failed_launch_raises_never_falls_back(monkeypatch, entry, refused):
    """A CUDA-typed call whose launch, or a device query before it, returns
    a CUDA error raises; it never returns the plain result and never counts
    a launch. The Argoverse entry's one C call enqueues all three of its
    kernels and returns the first error."""
    from types import SimpleNamespace

    from sfa3d_tpu_torch.ops import bev_counts

    def query(value):
        def ask(device, out):
            out._obj.value = value
            return 0
        return ask

    def refuse(*args):
        return 98  # cudaErrorInvalidDeviceFunction

    def launched(*args):
        raise AssertionError("a launch followed a refused device query")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    entries = {"bev_smem_limit": query(232448), "bev_sm_count": query(132), "bev_cell_counts_cuda": launched,
               "bev_raster_reduce_cuda": launched, "argoverse_raster_reduce_cuda": launched}
    entries[refused] = refuse
    fake = SimpleNamespace(**entries)
    monkeypatch.setattr(bev_counts, "load_library", lambda name, signatures: fake)
    monkeypatch.setattr(bev_counts, "_smem_limits", {})
    monkeypatch.setattr(bev_counts, "_sm_counts", {})
    monkeypatch.setattr(bev_counts, f"{entry}_plain", plain)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    fn = getattr(bev_counts, entry)
    idx = torch.Tensor._make_subclass(_CudaTyped, torch.zeros((2, 64), dtype=torch.int32))
    vals = torch.Tensor._make_subclass(_CudaTyped, torch.zeros((2, 64)))
    args = {"bev_cell_counts": (idx, idx), "bev_raster_reduce": (idx, idx, idx),
            "argoverse_raster_reduce": (idx, idx, vals, vals, 1000, 1000)}[entry]
    before = fn.launches
    message = "CUDA launch failed" if refused.endswith("_cuda") else "cudaDeviceGetAttribute failed"
    with pytest.raises(RuntimeError, match=f"{message}.*cudaError 98"):
        fn(*args)
    assert fn.launches == before


def _fake_fusion_lib(refuse):
    from types import SimpleNamespace

    def smem_limit(device, out):
        out._obj.value = 232448
        return 0

    return SimpleNamespace(fusion_smem_limit=smem_limit, hard_nms_keep_cuda=refuse,
                           soft_nms_gaussian_cuda=refuse, soft_nms_gaussian_block_cuda=refuse,
                           greedy_match_cuda=refuse, greedy_match_block_cuda=refuse)


@pytest.mark.parametrize("entry", ["hard_nms_keep", "soft_nms_gaussian", "greedy_match"])
def test_fusion_loop_failed_launch_raises_never_falls_back(monkeypatch, entry):
    """The same contract for the three loop kernels: a CUDA-typed call whose
    launch returns a CUDA error raises, runs no plain version and counts no
    launch."""
    from types import SimpleNamespace

    from sfa3d_tpu_torch.ops import fusion_loops

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(fusion_loops, "load_library",
                        lambda name, signatures: _fake_fusion_lib(lambda *a: 98))
    monkeypatch.setattr(fusion_loops, "_smem_limits", {})
    monkeypatch.setattr(fusion_loops, f"{entry}_plain", plain)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    cuda = lambda t: torch.Tensor._make_subclass(_CudaTyped, t)  # noqa: E731
    boxes, valid = cuda(torch.zeros((2, 8, 4))), cuda(torch.ones((2, 8), dtype=torch.bool))
    args = {"hard_nms_keep": (boxes, valid, 0.5),
            "soft_nms_gaussian": (boxes, cuda(torch.zeros((2, 8))), valid),
            "greedy_match": (boxes, valid, boxes, valid, 0.5)}[entry]
    fn = getattr(fusion_loops, entry)
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA launch failed: cudaError 98"):
        fn(*args)
    assert fn.launches == before


def test_track_associate_failed_launch_raises_never_falls_back(monkeypatch):
    """The association kernel keeps the contract: a CUDA-typed call whose
    launch returns a CUDA error raises, runs no plain version and counts no
    launch; other devices and bad inputs are refused."""
    from types import SimpleNamespace

    from sfa3d_tpu_torch.ops import track_associate as ta

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def smem_limit(device, out):
        out._obj.value = 232448
        return 0

    monkeypatch.setattr(ta, "load_library", lambda name, signatures: SimpleNamespace(
        track_associate_smem_limit=smem_limit, track_associate_cuda=lambda *a: 98,
        track_associate_row_cuda=lambda *a: 98))
    monkeypatch.setattr(ta, "_smem_limits", {})
    monkeypatch.setattr(ta, "track_associate_plain", plain)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    cuda = lambda t: torch.Tensor._make_subclass(_CudaTyped, t)  # noqa: E731
    before = ta.track_associate.launches
    # the matrix design, the row design (T past 256), and the row design at a
    # 52 KB order vector, which takes the opt-in shared memory
    for k, t in ((8, 16), (8, 300), (13000, 1)):
        iou, order = cuda(torch.zeros((2, k, t))), cuda(torch.zeros((2, k), dtype=torch.int32))
        with pytest.raises(RuntimeError, match="CUDA launch failed: cudaError 98"):
            ta.track_associate(iou, order, 0.01)
    assert ta.track_associate.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ta.track_associate(torch.zeros((1, 8, 16), device="meta"), torch.zeros((1, 8), dtype=torch.int32, device="meta"), 0.01)
    with pytest.raises(TypeError, match="int32"):
        ta.track_associate(torch.zeros((1, 8, 16)), torch.zeros((1, 8), dtype=torch.int64), 0.01)
    with pytest.raises(ValueError, match="at least one track"):
        ta.track_associate(torch.zeros((1, 8, 0)), torch.zeros((1, 8), dtype=torch.int32), 0.01)
    big = cuda(torch.zeros((1, 60000, 1)))  # a 240 KB order vector: past the card's 232,448 bytes
    with pytest.raises(ValueError, match="shared memory"):
        ta.track_associate(big, cuda(torch.zeros((1, 60000), dtype=torch.int32)), 0.01)


def test_fusion_loop_wrappers_check_their_inputs():
    from sfa3d_tpu_torch.ops import fusion_loops

    boxes, valid = torch.zeros((1, 8, 4), device="meta"), torch.ones((1, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fusion_loops.hard_nms_keep(boxes, valid, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fusion_loops.greedy_match(boxes, valid, boxes, valid, 0.5)
    with pytest.raises(TypeError, match="float32"):
        fusion_loops.hard_nms_keep(torch.zeros((1, 8, 4), dtype=torch.float64), torch.ones((1, 8), dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match=r"\(B, K, 4\)"):
        fusion_loops.soft_nms_gaussian(torch.zeros((8, 4)), torch.zeros(8), torch.ones(8, dtype=torch.bool))
    big = torch.Tensor._make_subclass(_CudaTyped, torch.zeros((1, 1025, 4)))
    big_valid = torch.Tensor._make_subclass(_CudaTyped, torch.ones((1, 1025), dtype=torch.bool))
    with pytest.raises(ValueError, match="at most 1024 slots"):
        fusion_loops.hard_nms_keep(big, big_valid, 0.5)


def test_kernel_sources_ship_with_the_package():
    from sfa3d_tpu_torch import _build

    assert (_build.CSRC_DIR / "bev_counts.cu").is_file()
    assert (_build.CSRC_DIR / "fusion_loops.cu").is_file()
    assert (_build.CSRC_DIR / "track_associate.cu").is_file()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    lib = _build.library_path("bev_counts")
    assert lib.parent == ROOT / "build" / "kernels"


def test_extra_nvcc_flags_build_a_library_of_their_own():
    from sfa3d_tpu_torch import _build

    plain = _build.library_path("fusion_loops")
    stamped = _build.library_path("fusion_loops", ("-DFUSION_LOOPS_PHASE_STAMPS",))
    assert plain != stamped and plain.parent == stamped.parent
    assert stamped == _build.library_path("fusion_loops", ["-DFUSION_LOOPS_PHASE_STAMPS"])
