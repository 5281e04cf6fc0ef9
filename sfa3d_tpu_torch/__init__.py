"""sfa3d_tpu_torch — the PyTorch + CUDA port of sfa3d_tpu for NVIDIA Hopper.

It ports the LiDAR serving path (padded raw scan -> BEV raster -> KFPN
ResNet -> peak decode -> metric boxes -> batching server) and the camera +
LiDAR fusion path (YOLOv8, 3D -> 2D projection, fusion, NMS, fused batching
server) with module and function names that mirror the JAX package, so
each counterpart is easy to find. The JAX package stays the numerical reference; `tests/test_torch_*.py`
hold the two against each other on the CPU.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no explicit CPU request they raise. The hand-written CUDA kernels
live in `csrc/` and are built with `nvcc` at first use (`_build.py`).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, like the JAX package: `import sfa3d_tpu_torch` stays cheap
    if name in ("Detector", "FusedDetector"):
        from sfa3d_tpu_torch import detector

        return getattr(detector, name)
    raise AttributeError(name)
