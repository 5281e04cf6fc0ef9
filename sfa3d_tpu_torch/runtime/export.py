"""AOT export of the port: the detector or the whole fusion program as one
`torch.export` program with the weights baked in, the counterpart of
`sfa3d_tpu/runtime/export.py`.

The program is `torch.export.export(..., strict=False)` of an `nn.Module`
that holds the model(s): an IR with its weights as constants, run at load
by `ExportedProgram.module()`. Deployment then needs neither the model code
nor a checkpoint, only torch and this package's kernel ops: every
hand-written kernel entry is a `torch.library.custom_op`
(`sfa3d_torch::<entry>`), so it stays one node of the graph, and the loaded
program launches the same CUDA kernels as the live path (or, for a CPU
artifact, their plain versions). The artifact is not packaged through
AOTInductor: nothing generated by inductor runs on the served path.

File format (one file, magic "SFA3DT01"; the JAX package's layout):
  [8s magic][u64le manifest length][manifest JSON][torch.export.save bytes]

A JAX artifact (magic "SFA3DX01", serialized StableHLO) is refused by
magic: the port cannot run it.

Unlike JAX's lowering for several platforms, an artifact holds one: the
device it was exported on (`platforms` is ["cuda"] or ["cpu"]).
`load_exported` raises when that device is absent; it never moves a cuda
artifact to the CPU.

By default the batch dimension is symbolic (`torch.export.Dim("b")`, up to
the raster kernel's 65535 frames, traced at an example batch of 2, since
torch.export specialises sizes 0 and 1), so one artifact serves any batch;
``batch=N`` gives a fixed-shape artifact, shape-checked at call time.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Optional, Tuple

import torch

from sfa3d_tpu_torch.config import kitti as cnf

_MAGIC = b"SFA3DT01"
_JAX_MAGIC = b"SFA3DX01"

# KITTI camera frames letterboxed by the YOLO branch
_IMG_H, _IMG_W = 375, 1242
_SYMBOLIC_EXAMPLE_BATCH = 2  # the traced batch of a symbolic artifact: not 0 or 1, which export specialises


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _export(module: torch.nn.Module, args, batch: Optional[int]) -> torch.export.ExportedProgram:
    """Trace `module` at `args` (batch first on every input): a symbolic
    batch dimension shared by every input when `batch` is None. One real
    call first makes the program's device constants (`device.py::
    device_constant`), so the trace takes them as constants on the device
    instead of a host-to-device copy on every call."""
    from sfa3d_tpu_torch.ops.bev_counts import MAX_GRID_Y

    dynamic = None
    if batch is None:
        b = torch.export.Dim("b", max=MAX_GRID_Y)  # the raster kernel's grid holds at most this many frames
        dynamic = tuple({0: b} for _ in args)
    module.eval()
    with torch.no_grad():
        module(*args)
        return torch.export.export(module, tuple(args), dynamic_shapes=dynamic, strict=False)


class DetectorProgram(torch.nn.Module):
    """(points (b, P, 4) float32, valid (b, P) bool) -> `detect_frames`'
    dict without the raster: 'detections', 'boxes_bev', 'boxes_real',
    'mask'."""

    def __init__(self, model: torch.nn.Module, K: int, peak_thresh: float):
        super().__init__()
        self.model, self.K, self.peak_thresh = model, K, peak_thresh

    def forward(self, points, valid):
        from sfa3d_tpu_torch.pipeline import detect_program

        return detect_program(self.model, points, valid, self.K, self.peak_thresh)[2]


def export_detector(
    model: torch.nn.Module,
    *,
    K: int = 50,
    peak_thresh: float = 0.2,
    max_points: int = cnf.MAX_POINTS,
    batch: Optional[int] = None,
) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export raw points -> detections (`pipeline.detect_frames`' program)
    with `model`'s weights baked in, on the device the model lies on.
    Exported signature: (points (b, P, 4) float32, valid (b, P) bool) ->
    {'detections', 'boxes_bev', 'boxes_real', 'mask'}."""
    dev = _model_device(model)
    n = batch or _SYMBOLIC_EXAMPLE_BATCH
    args = (torch.zeros((n, max_points, 4), dtype=torch.float32, device=dev),
            torch.zeros((n, max_points), dtype=torch.bool, device=dev))
    exported = _export(DetectorProgram(model, K, peak_thresh), args, batch)
    manifest = {
        "kind": "detector",
        "arch": type(model).__name__,
        "K": K,
        "peak_thresh": peak_thresh,
        "max_points": max_points,
        "batch": batch,  # null == symbolic
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        "inputs": [
            {"name": "points", "shape": [batch or "b", max_points, 4], "dtype": "float32"},
            {"name": "valid", "shape": [batch or "b", max_points], "dtype": "bool"},
        ],
    }
    return exported, manifest


def letterbox_geometry(img_hw: Tuple[int, int], letterbox: int) -> Tuple[float, int, int]:
    """The (scale, pad_x, pad_y) a fused artifact bakes for frames of
    `img_hw` on a square `letterbox` canvas, as the JAX export computes
    them: integer pads, (letterbox - round(side * scale)) // 2."""
    h, w = img_hw
    scale = letterbox / max(h, w)
    return scale, (letterbox - round(w * scale)) // 2, (letterbox - round(h * scale)) // 2


class BakedFusedProgram(torch.nn.Module):
    """(points, valid, images, V2C, R0, P2) -> the fused program's dict,
    with the camera's letterbox geometry (frame size, scale, pad) baked in
    as constants, as the JAX export's `fn` does."""

    def __init__(self, program: torch.nn.Module, img_hw: Tuple[int, int], letterbox: int):
        super().__init__()
        self.program = program
        self.img_hw = tuple(img_hw)
        self.scale, self.pad_x, self.pad_y = letterbox_geometry(img_hw, letterbox)

    def forward(self, points, valid, images, V2C, R0, P2):
        b = points.shape[0]

        def column(value):
            return torch.full((b,), value, dtype=torch.float32, device=points.device)

        hw = torch.stack([column(self.img_hw[0]), column(self.img_hw[1])], dim=1)
        pad = torch.stack([column(self.pad_x), column(self.pad_y)], dim=1)
        return self.program(points, valid, images, V2C, R0, P2, hw, column(self.scale), pad)


def export_fused(
    kfpn_model: torch.nn.Module,
    yolo_model: torch.nn.Module,
    *,
    batch: Optional[int] = None,
    max_points: int = cnf.MAX_POINTS,
    img_hw: Tuple[int, int] = (_IMG_H, _IMG_W),
    letterbox: int = 640,
    **fused_kwargs,
) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export the whole fusion program (`fusion/batch.py::FusedProgram`:
    BEV + KFPN + decode, YOLOv8 on the square letterbox canvas, projection,
    fusion and NMS) with both models' weights baked in, on the device they
    lie on. `fused_kwargs` are FusedProgram's (K, max_yolo, mode, ...).

    Exported signature: (points (b, P, 4), valid (b, P) bool, images (b,
    letterbox, letterbox, 3) float32 RGB in [0, 1], V2C (b, 3, 4), R0 (b, 3,
    3), P2 (b, 3, 4)) -> the fused dict. `images` is exactly what
    `models.yolov8.letterbox(frame, letterbox)` returns. The frame size,
    letterbox scale and pad are constants from `img_hw`
    (`letterbox_geometry`), the fixed camera geometry of a deployment."""
    from sfa3d_tpu_torch.fusion.batch import FusedProgram

    dev = _model_device(kfpn_model)
    program = FusedProgram(kfpn_model, yolo_model, **fused_kwargs)
    baked = BakedFusedProgram(program, img_hw, letterbox)
    n = batch or _SYMBOLIC_EXAMPLE_BATCH

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((n, *shape), dtype=dtype, device=dev)

    args = (zeros(max_points, 4), zeros(max_points, dtype=torch.bool), zeros(letterbox, letterbox, 3),
            zeros(3, 4), zeros(3, 3), zeros(3, 4))
    exported = _export(baked, args, batch)
    h, w = img_hw
    manifest = {
        "kind": "fused",
        "batch": batch,
        "max_points": max_points,
        "img_hw": [h, w],
        "letterbox": letterbox,
        "images": "letterboxed RGB in [0,1] — the output of "
                  "models.yolov8.letterbox(frame, letterbox)",
        "letterbox_scale": baked.scale,
        "letterbox_pad": [baked.pad_x, baked.pad_y],
        "fused_kwargs": {k: v for k, v in fused_kwargs.items()
                         if isinstance(v, (int, float, str, bool))},
        "platforms": [dev.type],
        "torch_version": torch.__version__,
    }
    return exported, manifest


def save_exported(path: str, exported: torch.export.ExportedProgram, manifest: dict) -> None:
    blob = io.BytesIO()
    torch.export.save(exported, blob)
    mbytes = json.dumps(manifest, indent=1).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(mbytes)))
        f.write(mbytes)
        f.write(blob.getvalue())


class LoadedArtifact:
    """A loaded artifact: `call(*args)` runs the program on the artifact's
    device under `torch.inference_mode()` and returns its dict of tensors;
    `.manifest` has the shapes and settings it was exported with, and
    `.module` is the program itself (`ExportedProgram.module()`), for
    tensors already on the device."""

    def __init__(self, exported: torch.export.ExportedProgram, manifest: dict):
        self.exported = exported
        self.manifest = manifest
        self.device = torch.device(manifest["platforms"][0])
        self.module = exported.module()

    def call(self, *args):
        with torch.inference_mode():
            args = [torch.as_tensor(a).to(self.device, non_blocking=True) for a in args]
            return self.module(*args)


def _read_header(f, path: str) -> dict:
    magic = f.read(8)
    if magic == _JAX_MAGIC:
        raise ValueError(
            f"{path}: a JAX StableHLO artifact (magic {magic!r}, exported by sfa3d_tpu), which "
            "sfa3d_tpu_torch cannot run; export with `python -m sfa3d_tpu_torch.cli export`"
        )
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a sfa3d_tpu_torch export (magic {magic!r})")
    (mlen,) = struct.unpack("<Q", f.read(8))
    return json.loads(f.read(mlen).decode())


def read_manifest(path: str) -> dict:
    """Parse only the manifest header (the program is not loaded): for
    dispatching on `kind` before constructing the right facade."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def load_exported(path: str) -> LoadedArtifact:
    """Read an artifact and load its program on the device it was exported
    on. Raises RuntimeError when that device is cuda and CUDA is absent."""
    import sfa3d_tpu_torch.ops.bev_counts  # noqa: F401  (register the kernel ops before the program loads)
    import sfa3d_tpu_torch.ops.fusion_loops  # noqa: F401
    import sfa3d_tpu_torch.ops.track_associate  # noqa: F401

    with open(path, "rb") as f:
        manifest = _read_header(f, path)
        blob = f.read()
    platforms = manifest.get("platforms") or []
    if len(platforms) != 1 or platforms[0] not in ("cuda", "cpu"):
        raise ValueError(f"{path}: platforms {platforms!r}; an artifact of the port runs on one of cuda, cpu")
    if platforms[0] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{path} was exported on cuda and CUDA is not available; the artifact is not moved to the "
            "CPU (export one with --platform cpu)"
        )
    return LoadedArtifact(torch.export.load(io.BytesIO(blob)), manifest)
