"""Bird's-eye-view rasterization of padded LiDAR scans, in PyTorch.

The port of `sfa3d_tpu/ops/bev.py`. `points_to_bev` fuses the range filter
and the raster, batched on the device:

    cell        = floor(x / disc), floor(y / disc) + W/2   (guard row/col dropped)
    key         = (13-bit height << 12) | 12-bit intensity  (-1 for a dropped point)
    max key     = per-cell max of the keys                 -> channels 0 and 1
    point count = per-cell count of the points             -> channel 2

The first two lines are elementwise PyTorch (`cell_indices_and_keys`); the
per-cell reduction and the channel epilogue are one launch of a
hand-written CUDA kernel (`ops/bev_counts.py::bev_raster_reduce`).

Channels (last axis, the JAX package's order):
    0: intensity of the highest point in the cell (12-bit quantized)
    1: height of the highest point / z range      (13-bit quantized)
    2: density min(1, log(n+1)/log 64), with n saturated at 63

A tie on quantized height picks the max intensity, because the packed key
orders by height first and intensity second: the same rule as the JAX
raster's sort + segment_max.

Every division by a constant is written as a multiplication by the float32
reciprocal, because XLA compiles `x / c` that way: a true division moves
`floor()` cell indices of points near a cell edge and breaks bit parity
with the JAX raster (tests/test_torch_bev.py covers cell-edge points).
Each elementwise step is its own PyTorch op, so nothing is contracted to a
fused multiply-add. Subnormal coordinates count as zero, as under XLA.

`argoverse_points_to_bev` is the Argoverse variant (1000 x 1000 cells of
0.1 m over +-50 m): row = (maxX - x) / disc (x flipped), col = (y - minY) /
disc, strict upper bounds, rows and columns clipped rather than dropped;
per cell the count, max(z, 0) and max(r, 0) in one launch of the tile
kernel's argoverse mode (`ops/bev_counts.py::argoverse_raster_reduce`),
then [log1p(count), height, intensity], each min-max scaled to [0, 255]
over the whole frame.
"""

from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch import native
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.device import Device, device_constant, resolve_device
from sfa3d_tpu_torch.ops.bev_counts import _f32_reciprocal, argoverse_raster_reduce, bev_raster_reduce

_BOUND = (
    cnf.boundary["minX"], cnf.boundary["maxX"],
    cnf.boundary["minY"], cnf.boundary["maxY"],
    cnf.boundary["minZ"], cnf.boundary["maxZ"],
)


def warn_point_overflow(n_in_range: int, max_points: int, stacklevel: int = 3) -> None:
    """Truncation must never be silent. The one warning site of the native
    pass and its numpy twin, whose stacklevel points at the caller of
    filter_and_pad_points. The message is the JAX package's."""
    if n_in_range > max_points:
        warnings.warn(
            f"scan has {n_in_range} in-range points; keeping the first "
            f"{max_points} (raise MAX_POINTS_FILTERED to keep all)",
            RuntimeWarning,
            stacklevel=stacklevel,
        )


def filter_and_pad_points(
    points: np.ndarray,
    max_points: int = cnf.MAX_POINTS_FILTERED,
    boundary: Dict[str, float] = cnf.boundary,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: range-filter a ragged (N, 4) scan and pad/truncate it to a
    fixed (max_points, 4) float32 array plus a (max_points,) bool mask.
    z is NOT shifted: `points_to_bev` applies the shift itself. Warns when
    in-range points are dropped.

    Runs the port's native pass (`native/preproc.cpp`, built at first use;
    a failed build raises), or its numpy twin `_filter_and_pad_numpy` when
    SFA3D_TPU_NO_NATIVE is set. The two are bit-equal
    (tests/test_torch_native.py)."""
    points = np.asarray(points, dtype=np.float32)
    native.note_path()
    if native.enabled():
        return native.filter_pad_points(points, max_points, boundary)
    return _filter_and_pad_numpy(points, max_points, boundary)


def _filter_and_pad_numpy(
    points: np.ndarray, max_points: int, boundary: Dict[str, float]
) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy twin of the native pass (and its parity oracle)."""
    mask = (
        (points[:, 0] >= boundary["minX"])
        & (points[:, 0] <= boundary["maxX"])
        & (points[:, 1] >= boundary["minY"])
        & (points[:, 1] <= boundary["maxY"])
        & (points[:, 2] >= boundary["minZ"])
        & (points[:, 2] <= boundary["maxZ"])
    )
    in_range = points[mask]
    warn_point_overflow(len(in_range), max_points, stacklevel=4)
    kept = in_range[:max_points]
    out = np.zeros((max_points, 4), dtype=np.float32)
    out[: len(kept)] = kept
    valid = np.zeros((max_points,), dtype=bool)
    valid[: len(kept)] = True
    return out, valid


def _pad_raw(points: np.ndarray, max_points: int = cnf.MAX_POINTS):
    """Pad/truncate a raw scan without filtering (the raster filters).
    Truncation warns: host-filter full scans first with
    filter_and_pad_points."""
    if len(points) > max_points:
        warnings.warn(
            f"raw scan has {len(points)} points; truncating to {max_points} "
            "— host-filter first (filter_and_pad_points) to keep all "
            "in-range points",
            RuntimeWarning,
            stacklevel=2,
        )
    n = min(len(points), max_points)
    out = np.zeros((max_points, 4), dtype=np.float32)
    out[:n] = points[:n]
    valid = np.zeros((max_points,), dtype=bool)
    valid[:n] = True
    return out, valid


def _check_bound(bound, bev_height: int, bev_width: int) -> float:
    min_x, max_x, min_y, max_y, _, _ = bound
    discretization = (max_x - min_x) / bev_height
    # The column formula floor(y/disc) + W//2 assumes a Y range symmetric
    # about 0 and square cells; anything else would shift and crop the
    # raster without a word.
    if abs(min_y + max_y) > 1e-9:
        raise ValueError(
            f"points_to_bev requires a symmetric Y boundary (minY == -maxY); "
            f"got minY={min_y}, maxY={max_y}"
        )
    if abs((max_y - min_y) / bev_width - discretization) > 1e-12:
        raise ValueError(
            "points_to_bev requires square cells: (maxY-minY)/bev_width must "
            f"equal (maxX-minX)/bev_height; got {(max_y - min_y) / bev_width} "
            f"vs {discretization}"
        )
    return discretization


def cell_indices_and_keys(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    bev_height: int = cnf.BEV_HEIGHT,
    bev_width: int = cnf.BEV_WIDTH,
    bound: Tuple[float, float, float, float, float, float] = _BOUND,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The elementwise half of the raster: (B, N, 4) raw padded scans +
    (B, N) bool mask -> (row, col, key), each (B, N) int32. A point dropped
    by the mask, the range filter or the guard row/column gets row = col =
    key = -1."""
    discretization = _check_bound(bound, bev_height, bev_width)
    min_x, max_x, min_y, max_y, min_z, max_z = bound
    points = torch.as_tensor(points).to(torch.float32)
    valid = torch.as_tensor(valid, device=points.device).to(torch.bool)
    if points.dim() != 3 or points.shape[-1] != 4 or valid.shape != points.shape[:2]:
        raise ValueError(
            f"expected points (B, N, 4) and valid (B, N); got "
            f"{tuple(points.shape)} and {tuple(valid.shape)}"
        )
    # XLA treats float32 subnormals as zero, on the TPU and on the CPU; so
    # does the port, or a point one ulp beside the x = 0 or y = 0 cell edge
    # would land in another cell than in the JAX raster
    points = torch.where(points.abs() < torch.finfo(torch.float32).tiny, 0.0, points)
    x, y, z, r = points.unbind(-1)
    # NaN coordinates fail the range tests; a NaN intensity on a valid point
    # would poison the packed key
    r = torch.nan_to_num(r)

    in_range = (
        (x >= min_x) & (x <= max_x)
        & (y >= min_y) & (y <= max_y)
        & (z >= min_z) & (z <= max_z)
    )
    inv_disc = _f32_reciprocal(discretization)
    rowf = torch.floor((x - min_x) * inv_disc)
    colf = torch.floor(y * inv_disc) + float(bev_width // 2)
    # the reference's (H+1, W+1) guard row and column are dropped
    ok = (
        valid & in_range
        & (rowf >= 0) & (rowf < bev_height) & (colf >= 0) & (colf < bev_width)
    )
    row = torch.where(ok, rowf, -1.0).to(torch.int32)
    col = torch.where(ok, colf, -1.0).to(torch.int32)

    # 25-bit key: 13-bit height high, 12-bit intensity low, so the max key is
    # the highest point with a max-intensity tie-break. Clamping before the
    # int cast equals the JAX cast-then-clip for every finite value.
    zs = z - min_z
    z_range = abs(max_z - min_z)
    qz = torch.clamp(zs * _f32_reciprocal(z_range) * 8191.0 + 0.5, 0.0, 8191.0)
    qr = torch.clamp(r * 4095.0 + 0.5, 0.0, 4095.0)
    qz = torch.where(ok, qz, 0.0).to(torch.int32)
    qr = torch.where(ok, qr, 0.0).to(torch.int32)
    key = torch.where(ok, (qz << 12) | qr, -1)
    return row, col, key


def points_to_bev_nchw(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    bev_height: int = cnf.BEV_HEIGHT,
    bev_width: int = cnf.BEV_WIDTH,
    bound: Tuple[float, float, float, float, float, float] = _BOUND,
) -> torch.Tensor:
    """(B, N, 4) raw padded scans + (B, N) bool mask -> (B, 3, H, W) float32
    raster, channels first, on the scans' device (the model's layout)."""
    row, col, key = cell_indices_and_keys(
        points, valid, bev_height=bev_height, bev_width=bev_width, bound=bound
    )
    return bev_raster_reduce(row, col, key, bev_height, bev_width)


def points_to_bev(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    bev_height: int = cnf.BEV_HEIGHT,
    bev_width: int = cnf.BEV_WIDTH,
    bound: Tuple[float, float, float, float, float, float] = _BOUND,
) -> torch.Tensor:
    """Raw padded scan(s) -> BEV raster in the JAX package's NHWC layout.

    `points`: (N, 4) or (B, N, 4) float32 (x, y, z, intensity), velodyne
    frame, unshifted z. `valid`: (N,) or (B, N) bool padding mask. Returns
    (H, W, 3) or (B, H, W, 3) float32 on the points' device (a channels-last
    view of the channels-first raster)."""
    points = torch.as_tensor(points)
    single = points.dim() == 2
    if single:
        points = points[None]
        valid = torch.as_tensor(valid)[None]
    bev = points_to_bev_nchw(
        points, valid, bev_height=bev_height, bev_width=bev_width, bound=bound
    ).permute(0, 2, 3, 1)
    return bev[0] if single else bev


def make_bev_map(points: np.ndarray, boundary: Dict[str, float] = cnf.boundary,
                 device: Device = None) -> np.ndarray:
    """The reference's makeBEVMap(PointCloud, boundary) as the JAX package
    has it: a RAW (unfiltered, unshifted) (N, 4) scan, range-filtered on
    the host before padding (so a KITTI-sized cloud never truncates), ->
    (H, W, 3) float32 HWC raster through the port's raster path, as numpy.
    On `device` (default cuda; raises without a GPU unless device="cpu")."""
    padded, valid = filter_and_pad_points(points, max_points=cnf.MAX_POINTS_FILTERED, boundary=boundary)
    bound = (boundary["minX"], boundary["maxX"], boundary["minY"], boundary["maxY"],
             boundary["minZ"], boundary["maxZ"])
    dev = resolve_device(device)
    bev = points_to_bev(torch.from_numpy(padded).to(dev), torch.from_numpy(valid).to(dev), bound=bound)
    return bev.cpu().numpy()


def hflip_bev(bev_nchw: torch.Tensor, hflip: torch.Tensor) -> torch.Tensor:
    """Mirror the frames of a (B, C, H, W) raster whose `hflip` (B,) flag is
    set along W, the last axis (the JAX loader's `bev[:, ::-1, :]` in HWC)."""
    flags = torch.as_tensor(hflip, device=bev_nchw.device).to(torch.bool)
    return torch.where(flags[:, None, None, None], bev_nchw.flip(-1), bev_nchw)


# uint16 points for the host -> device hop: x, y, z span the detection
# boundary (the points are range-filtered before padding), intensity
# [0, 1]. Steps: x, y 0.76 mm, z 0.06 mm, r 1.5e-5, two orders finer than
# the raster's own cells. The loader's point_format="uint16" opts in.
_QSCALE = np.asarray([
    (cnf.boundary["maxX"] - cnf.boundary["minX"]) / 65535.0,
    (cnf.boundary["maxY"] - cnf.boundary["minY"]) / 65535.0,
    (cnf.boundary["maxZ"] - cnf.boundary["minZ"]) / 65535.0,
    1.0 / 65535.0,
], np.float32)
_QMIN = np.asarray([cnf.boundary["minX"], cnf.boundary["minY"], cnf.boundary["minZ"], 0.0], np.float32)


def quantize_points_uint16(points: np.ndarray) -> np.ndarray:
    """Host side: (..., 4) float32 boundary-filtered points -> uint16."""
    q = np.rint((points - _QMIN) / _QSCALE)
    return np.clip(q, 0, 65535).astype(np.uint16)


@device_constant
def _dequantize_constants(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    # one copy per device: a pageable host-to-device copy syncs the stream;
    # made outside inference mode, like the upsample's matrices
    with torch.inference_mode(False):
        return (torch.from_numpy(_QSCALE.astype(np.float64)).to(device),
                torch.from_numpy(_QMIN.astype(np.float64)).to(device))


def dequantize_points(q: torch.Tensor) -> torch.Tensor:
    """Device side: quantized points -> float32 points, q * scale + min.

    `q` holds the uint16 values of `quantize_points_uint16`, as uint16 or
    as their int16 bit patterns (what the loader ships: every CUDA build
    copies int16). XLA fuses the multiply-add into one FMA under jit, a
    single rounding; the port gets the same float32 by computing in float64,
    where q * scale + min is exact (17 + 24 significant bits, summed within
    53), and rounding once."""
    q = q.to(torch.int32) & 0xFFFF  # an int16 bit pattern back to 0..65535
    scale, qmin = _dequantize_constants(q.device)
    return (q.to(torch.float64) * scale + qmin).to(torch.float32)


_ARGO_BOUND = (-50.0, 50.0, -50.0, 50.0, -3.0, 5.0)  # config/argoverse.py's boundary


def argoverse_bev_size(discretization: float = 0.1, bound=_ARGO_BOUND) -> Tuple[int, int]:
    """(H, W) of the Argoverse raster: 1000 x 1000 at the defaults."""
    min_x, max_x, min_y, max_y, _, _ = bound
    return int((max_x - min_x) / discretization), int((max_y - min_y) / discretization)


def argoverse_cell_indices(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    discretization: float = 0.1,
    bound: Tuple[float, float, float, float, float, float] = _ARGO_BOUND,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The elementwise half of the Argoverse raster: (B, N, 4) raw padded
    sweeps + (B, N) bool mask -> (row, col, z, r), row and col (B, N) int32
    (-1 for a point dropped by the mask or the range filter), z and r the
    sweeps' (B, N) float32 with subnormals read as zero.

    A point is kept where min <= v < max on x, y and z (strict upper
    bounds); its row (maxX - x) / disc and column (y - minY) / disc are cut
    to integers toward zero and clipped into the raster, as the JAX raster
    does. The divisions are multiplications by the float32 reciprocal, as
    XLA compiles them; clamping before the int cast equals the JAX
    cast-then-clip for every finite value."""
    H, W = argoverse_bev_size(discretization, bound)
    min_x, max_x, min_y, max_y, min_z, max_z = bound
    points = torch.as_tensor(points).to(torch.float32)
    valid = torch.as_tensor(valid, device=points.device).to(torch.bool)
    if points.dim() != 3 or points.shape[-1] != 4 or valid.shape != points.shape[:2]:
        raise ValueError(
            f"expected points (B, N, 4) and valid (B, N); got "
            f"{tuple(points.shape)} and {tuple(valid.shape)}"
        )
    points = torch.where(points.abs() < torch.finfo(torch.float32).tiny, 0.0, points)
    x, y, z, r = points.unbind(-1)
    ok = (
        valid
        & (x >= min_x) & (x < max_x)
        & (y >= min_y) & (y < max_y)
        & (z >= min_z) & (z < max_z)
    )
    inv_disc = _f32_reciprocal(discretization)
    rowf = torch.clamp((max_x - x) * inv_disc, 0.0, H - 1.0)
    colf = torch.clamp((y - min_y) * inv_disc, 0.0, W - 1.0)
    row = torch.where(ok, rowf, -1.0).to(torch.int32)
    col = torch.where(ok, colf, -1.0).to(torch.int32)
    return row, col, z.contiguous(), r.contiguous()


def _minmax255(m: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> each frame scaled to [0, 255] by its own min and max,
    in the JAX raster's float order (a true division by the range)."""
    lo = m.amin(dim=(1, 2), keepdim=True)
    hi = m.amax(dim=(1, 2), keepdim=True)
    return (m - lo) / torch.clamp_min(hi - lo, 1e-12) * 255.0


def argoverse_points_to_bev_nchw(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    discretization: float = 0.1,
    bound: Tuple[float, float, float, float, float, float] = _ARGO_BOUND,
) -> torch.Tensor:
    """(B, N, 4) raw padded sweeps + (B, N) bool mask -> (B, 3, H, W)
    float32 Argoverse raster, channels [density, height, intensity], each in
    [0, 255], on the sweeps' device:
        density    log1p(count)
        height     per-cell max of max(z, 0)
        intensity  per-cell max of max(r, 0) (a NaN intensity counts as 0)
    each min-max scaled over its whole frame."""
    H, W = argoverse_bev_size(discretization, bound)
    row, col, z, r = argoverse_cell_indices(points, valid, discretization=discretization, bound=bound)
    count, height, intensity = argoverse_raster_reduce(row, col, z, r, H, W).unbind(1)
    return torch.stack([_minmax255(torch.log1p(count)), _minmax255(height), _minmax255(intensity)], dim=1)


def argoverse_points_to_bev(
    points: torch.Tensor,
    valid: torch.Tensor,
    *,
    discretization: float = 0.1,
    bound: Tuple[float, float, float, float, float, float] = _ARGO_BOUND,
) -> torch.Tensor:
    """The Argoverse raster in the JAX package's NHWC layout: (N, 4) or
    (B, N, 4) sweeps + (N,) or (B, N) mask -> (H, W, 3) or (B, H, W, 3)
    float32 (a channels-last view of `argoverse_points_to_bev_nchw`)."""
    points = torch.as_tensor(points)
    single = points.dim() == 2
    if single:
        points = points[None]
        valid = torch.as_tensor(valid)[None]
    bev = argoverse_points_to_bev_nchw(
        points, valid, discretization=discretization, bound=bound
    ).permute(0, 2, 3, 1)
    return bev[0] if single else bev


def points_to_bev_batch(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched form at the default geometry: (B, N, 4), (B, N) -> (B, H, W, 3)."""
    if torch.as_tensor(points).dim() != 3:
        raise ValueError("points_to_bev_batch expects (B, N, 4) points")
    return points_to_bev(points, valid)
