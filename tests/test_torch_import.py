"""The PyTorch port stands alone: it imports with JAX and the JAX package
absent, its sources import neither, and its entry points never fall back
to the CPU on their own."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sfa3d_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "sfa3d_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|sfa3d_tpu)\b", re.MULTILINE)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(sfa3d_tpu_torch.__path__, "sfa3d_tpu_torch.")
    )


def test_port_imports_without_jax():
    modules = _port_modules()
    assert "sfa3d_tpu_torch.ops.bev_counts" in modules
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sfa3d_tpu'] = None\n"
        "import importlib\n"
        f"for name in {modules!r} + ['sfa3d_tpu_torch', 'chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert not [m for m in sys.modules if m.startswith(('jax.', 'flax', 'sfa3d_tpu.'))]\n"
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


@pytest.mark.parametrize("entry", ["bev_cell_counts", "bev_raster_reduce"])
def test_failed_launch_raises_never_falls_back(monkeypatch, entry):
    """A CUDA-typed call whose launch returns a CUDA error raises; it never
    returns the plain result and never counts a launch."""
    from types import SimpleNamespace

    from sfa3d_tpu_torch.ops import bev_counts

    def smem_limit(device, out):
        out._obj.value = 232448
        return 0

    def refuse(*args):
        return 98  # cudaErrorInvalidDeviceFunction

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    fake = SimpleNamespace(bev_smem_limit=smem_limit, bev_cell_counts_cuda=refuse,
                           bev_raster_reduce_cuda=refuse)
    monkeypatch.setattr(bev_counts, "load_library", lambda name, signatures: fake)
    monkeypatch.setattr(bev_counts, "_smem_limits", {})
    monkeypatch.setattr(bev_counts, f"{entry}_plain", plain)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=0))
    fn = getattr(bev_counts, entry)
    idx = torch.Tensor._make_subclass(_CudaTyped, torch.zeros((2, 64), dtype=torch.int32))
    args = (idx, idx) if entry == "bev_cell_counts" else (idx, idx, idx)
    before = fn.launches
    with pytest.raises(RuntimeError, match="CUDA launch failed: cudaError 98"):
        fn(*args)
    assert fn.launches == before


def test_kernel_sources_ship_with_the_package():
    from sfa3d_tpu_torch import _build

    assert (_build.CSRC_DIR / "bev_counts.cu").is_file()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    lib = _build.library_path("bev_counts")
    assert lib.parent == ROOT / "build" / "kernels"
