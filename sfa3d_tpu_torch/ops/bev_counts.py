"""The BEV raster's per-cell reduction and exact per-cell point counts: the
port of the Pallas kernel `sfa3d_tpu/ops/bev_pallas.py:76`
(`bev_cell_counts`), redesigned for Hopper on shared-memory integer atomics.

The TPU kernel built the count as bf16 one-hot matrix products because the
TPU has no fast scatter. On Hopper (`csrc/bev_counts.cu`) a block owns one
band of rows of one frame, keeps the band's accumulators in shared memory
(integer atomics: exact in any order), and writes the finished band once.
There are three entries:

  bev_raster_reduce        (B, N) int32 row, col, key -> (B, 3, H, W)
                           float32 KITTI raster (intensity, height,
                           density), channels first: everything the raster
                           does after `cell_indices_and_keys`
  bev_cell_counts          (B, N) int32 row, col -> (B, H, W) float32 exact
                           counts, what the TPU kernel computes
  argoverse_raster_reduce  (B, N) int32 row, col and float32 z, r ->
                           (B, 3, H, W) float32 [count, max(z, 0),
                           max(r, 0)] per cell: the Argoverse raster's
                           reductions (`ops/bev.py::argoverse_points_to_bev`)

The first two are one tile pass (`tile_plan` cuts the rows into bands whose
accumulators fit a block's shared memory; each band's block scans its
frame's points). The Argoverse entry buckets the points by band first, in
three kernels a call (histogram, scatter, reduce; `argoverse_band_plan`
sizes the bands and chunks), so each band's block reads only its own
points. All are bound by bytes: at the served shape (8, 32768) -> 608x608
the raster reads 3.1 MB and writes 35.5 MB (11.5 us at 3.35 TB/s), the
counts read 2.1 MB and write 11.8 MB (4.2 us); the Argoverse entry at
(16, 131072) -> 1000x1000 reads 33.5 MB and writes 192 MB (67 us).

Unlike the TPU kernel, which asserts N % 128 == 0 (bev_pallas.py:80; its
docstring says 512), the port accepts any N. Indices outside the raster
count nowhere.

Each entry is a `torch.library.custom_op` (`sfa3d_torch::<entry>`), so
`torch.export` and graph captures see it as one op with a shape-only fake
implementation. It launches its kernels for CUDA tensors (or raises) and
takes its plain PyTorch version (`*_plain`) only for tensors on the CPU.
Each keeps a `launches` counter (one a real CUDA launch; fake and traced
calls count nothing), so a run can show that the served path went through
the kernel. `_<entry>_impl` is an op's real implementation, callable past
the dispatcher (to time what the dispatcher adds). The tile design's Argoverse entry,
`argoverse_raster_reduce_tile_cuda`, stays a plain C call, kept to be
compared with.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from sfa3d_tpu_torch._build import check_op_device, finish_launch, load_library

H = 608
W = 608
RASTER_BYTES_PER_CELL = 8  # int32 max key + int32 count
COUNT_BYTES_PER_CELL = 4  # int32 count
ARGOVERSE_BYTES_PER_CELL = 12  # int32 count + two int32 maxima
MAX_GRID_Y = 65535  # the grid's y dimension holds the batch
ARGOVERSE_BLOCKS_PER_SM = 2  # reduce blocks an SM holds at once: one writes its band while another fills
ARGOVERSE_CHUNKS = (4096, 2048, 1024)  # points a histogram / scatter block takes, largest first
SMEM_RESERVED_PER_BLOCK = 1024  # shared memory the card keeps for each resident block
ARGOVERSE_STATIC_SMEM = 128  # the Argoverse kernels' static shared memory: a scan's 32 warp sums

_c_ptr, _c_i32, _c_i64, _c_f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "bev_smem_limit": (ctypes.c_int, (_c_i32, ctypes.POINTER(_c_i32))),
    "bev_raster_reduce_cuda": (
        ctypes.c_int,
        (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_i32, _c_i32, _c_i32, _c_i32,
         _c_f32, _c_f32, _c_f32, _c_i32, _c_ptr),
    ),
    "bev_cell_counts_cuda": (
        ctypes.c_int,
        (_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_i32, _c_i32, _c_i32, _c_i32, _c_i32, _c_ptr),
    ),
    "bev_sm_count": (ctypes.c_int, (_c_i32, ctypes.POINTER(_c_i32))),
    "argoverse_raster_reduce_cuda": (
        ctypes.c_int,
        (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_i32, _c_i32, _c_i32,
         _c_i32, _c_i32, _c_i32, _c_ptr),
    ),
    "argoverse_raster_reduce_tile_cuda": (  # the first design, kept to be compared with
        ctypes.c_int,
        (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_i32, _c_i32, _c_i32, _c_i32,
         _c_i32, _c_ptr),
    ),
}
_smem_limits = {}  # device index -> bytes of shared memory a block may use
_sm_counts = {}  # device index -> SMs


def _f32_reciprocal(c: float) -> float:
    """1/c rounded to float32 (a Python float that float32 holds exactly)."""
    return float(np.float32(1.0 / c))


_INV_4095 = _f32_reciprocal(4095.0)
_INV_8191 = _f32_reciprocal(8191.0)
_INV_LOG64 = _f32_reciprocal(float(np.log(64.0)))


def tile_plan(B: int, H: int, W: int, bytes_per_cell: int, smem_limit: int) -> Tuple[int, int]:
    """Bands of rows for the tile kernel -> (tile_rows, n_tiles).

    A band holds as many rows of W cells as fit `smem_limit` bytes at
    `bytes_per_cell` (the kernel pads a band to a multiple of 4 cells); the
    rows are then spread evenly over the fewest bands, so band t covers rows
    [t * tile_rows, min(H, (t + 1) * tile_rows)) and every row lies in
    exactly one band. The grid is (n_tiles, B). Raises ValueError when one
    row of W cells alone exceeds the shared memory, or B the grid."""
    if H < 1 or W < 1 or B < 0:
        raise ValueError(f"tile_plan needs H, W >= 1 and B >= 0; got B={B}, H={H}, W={W}")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid's y dimension ({MAX_GRID_Y})")
    rows_fit = (smem_limit // bytes_per_cell) // 4 * 4 // W
    if rows_fit < 1:
        raise ValueError(
            f"one raster row of {W} cells needs {W * bytes_per_cell} bytes of shared "
            f"memory; a block has {smem_limit}"
        )
    n_tiles = -(-H // rows_fit)
    tile_rows = -(-H // n_tiles)
    return tile_rows, -(-H // tile_rows)


def argoverse_reduce_smem(band_rows: int, W: int) -> int:
    """Dynamic shared memory of an Argoverse reduce block: three int32
    planes of the band's cells, each padded to a multiple of 4 cells."""
    return -(-band_rows * W // 4) * 4 * ARGOVERSE_BYTES_PER_CELL


def argoverse_scatter_smem(chunk: int, n_bands: int) -> int:
    """Dynamic shared memory of an Argoverse scatter block: three int32 per
    band (its run in the bucket, its run in staging, the staging cursor) and
    four per point of its chunk (a staged record and its place)."""
    return 12 * n_bands + 16 * chunk


def argoverse_scratch_len(B: int, N: int, n_bands: int, chunk: int) -> int:
    """int32 entries of the Argoverse entry's scratch: the band totals and
    the buckets' starts ((B, n_bands) each), each chunk's counts and its
    runs' offsets ((B, chunks, n_bands) each), then the records (3, B, N):
    25 MB at (16, 131072)."""
    return 2 * B * n_bands * (1 + -(-N // chunk)) + 3 * B * N


@functools.lru_cache(maxsize=256)
def argoverse_band_plan(B: int, N: int, H: int, W: int, smem_limit: int,
                        sm_count: int) -> Tuple[int, int, int]:
    """Bands and chunks for the Argoverse entry -> (band_rows, n_bands,
    chunk).

    A reduce block keeps its band in shared memory at 12 B a cell; a band
    has as many rows as let ARGOVERSE_BLOCKS_PER_SM such blocks share an SM
    (`smem_limit`, a block's opt-in limit, stands for the SM's share: 9 rows
    of 1000 on an H100, where 3 or 6 rows gave no faster call at 1, 16 or 64
    sweeps, `scripts/torch_argoverse_variants.py`). The rows are spread
    evenly over the fewest bands, so band k covers rows [k * band_rows,
    min(H, (k + 1) * band_rows)). `chunk` is the points a histogram or
    scatter block takes: the largest of ARGOVERSE_CHUNKS whose grid
    (ceil(N / chunk), B) still holds ARGOVERSE_BLOCKS_PER_SM blocks for each
    of the `sm_count` SMs, else the smallest. Raises ValueError when one row
    of W cells does not fit a block's share, a scatter block does not fit
    `smem_limit`, or B exceeds the grid."""
    if H < 1 or W < 1 or B < 0 or N < 0:
        raise ValueError(f"argoverse_band_plan needs H, W >= 1 and B, N >= 0; got B={B}, N={N}, H={H}, W={W}")
    if B > MAX_GRID_Y:
        raise ValueError(f"batch {B} exceeds the grid's y dimension ({MAX_GRID_Y})")
    share = smem_limit // ARGOVERSE_BLOCKS_PER_SM - SMEM_RESERVED_PER_BLOCK - ARGOVERSE_STATIC_SMEM
    rows_fit = (share // ARGOVERSE_BYTES_PER_CELL) // 4 * 4 // W
    if rows_fit < 1:
        raise ValueError(
            f"one raster row of {W} cells needs {W * ARGOVERSE_BYTES_PER_CELL} bytes of shared "
            f"memory; {ARGOVERSE_BLOCKS_PER_SM} blocks an SM leave a block {share}"
        )
    n_bands = -(-H // rows_fit)
    band_rows = -(-H // n_bands)
    target = ARGOVERSE_BLOCKS_PER_SM * sm_count
    chunk = next((c for c in ARGOVERSE_CHUNKS if B * -(-N // c) >= target), ARGOVERSE_CHUNKS[-1])
    if argoverse_scatter_smem(chunk, n_bands) + ARGOVERSE_STATIC_SMEM > smem_limit:
        raise ValueError(f"{n_bands} bands and chunks of {chunk} points take more than the "
                         f"{smem_limit} bytes of shared memory a block may use")
    return band_rows, n_bands, chunk


def _check(*tensors: torch.Tensor) -> None:
    first = tensors[0]
    if first.dim() != 2 or any(t.shape != first.shape for t in tensors):
        raise ValueError(f"indices must all be (B, N); got {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"indices must be int32; got {[t.dtype for t in tensors]}")
    if any(t.device != first.device for t in tensors):
        raise ValueError(f"indices lie on {[str(t.device) for t in tensors]}")


def _check_values(like: torch.Tensor, *values: torch.Tensor) -> None:
    if any(v.shape != like.shape for v in values):
        raise ValueError(f"values must be (B, N) like the indices {tuple(like.shape)}; got "
                         f"{[tuple(v.shape) for v in values]}")
    if any(v.dtype != torch.float32 for v in values):
        raise TypeError(f"values must be float32; got {[v.dtype for v in values]}")
    if any(v.device != like.device for v in values):
        raise ValueError(f"values lie on {[str(v.device) for v in values]}, indices on {like.device}")


def _cuda_launch_setup(name: str, tensors) -> Tuple[ctypes.CDLL, torch.device]:
    """The library and device for a launch; raises for a device that is not
    CUDA (the CPU never gets here) or a tensor that is not contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return load_library("bev_counts", _SIGNATURES), dev


def _smem_limit(lib: ctypes.CDLL, dev: torch.device) -> int:
    limit = _smem_limits.get(dev.index)
    if limit is None:
        v = _c_i32(0)
        err = lib.bev_smem_limit(dev.index, ctypes.byref(v))
        if err != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed on {dev}: cudaError {err}")
        limit = _smem_limits[dev.index] = v.value
    return limit


def _sm_count(lib: ctypes.CDLL, dev: torch.device) -> int:
    count = _sm_counts.get(dev.index)
    if count is None:
        v = _c_i32(0)
        err = lib.bev_sm_count(dev.index, ctypes.byref(v))
        if err != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed on {dev}: cudaError {err}")
        count = _sm_counts[dev.index] = v.value
    return count


def shared_memory_limit(device) -> int:
    """Bytes of shared memory one block may use on the CUDA `device` (the
    `smem_limit` the wrappers give `tile_plan`)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return _smem_limit(load_library("bev_counts", _SIGNATURES), dev)


def multiprocessor_count(device) -> int:
    """SMs on the CUDA `device` (the `sm_count` the Argoverse wrapper gives
    `argoverse_band_plan`)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return _sm_count(load_library("bev_counts", _SIGNATURES), dev)


def bev_cell_counts_plain(row: torch.Tensor, col: torch.Tensor,
                          H: int = H, W: int = W) -> torch.Tensor:
    """Plain PyTorch version: (B, N) int32 cell indices (-1 = invalid) ->
    (B, H, W) float32 exact counts. A point counts only where 0 <= row < H
    and 0 <= col < W, as in the TPU kernel."""
    _check(row, col)
    b, n = row.shape
    ok = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    batch = torch.arange(b, device=row.device, dtype=torch.int64)[:, None].expand(b, n)
    flat = (batch * H + row.long()) * W + col.long()
    counts = torch.zeros(b * H * W, dtype=torch.int32, device=row.device)
    idx = flat[ok]
    counts.index_put_((idx,), torch.ones_like(idx, dtype=torch.int32), accumulate=True)
    return counts.view(b, H, W).float()


def _bev_cell_counts_impl(row: torch.Tensor, col: torch.Tensor, H: int, W: int) -> torch.Tensor:
    _check(row, col)
    if row.device.type == "cpu":
        return bev_cell_counts_plain(row, col, H, W)
    lib, dev = _cuda_launch_setup("bev_cell_counts", (row, col))
    b, n = row.shape
    tile_rows, n_tiles = tile_plan(b, H, W, COUNT_BYTES_PER_CELL, _smem_limit(lib, dev))
    out = row.new_empty((b, H, W), dtype=torch.float32)
    err = lib.bev_cell_counts_cuda(
        row.data_ptr(), col.data_ptr(), out.data_ptr(), b, n, H, W, tile_rows, n_tiles,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    finish_launch(bev_cell_counts, "bev_cell_counts", err)
    return out


_bev_cell_counts_op = torch.library.custom_op("sfa3d_torch::bev_cell_counts", _bev_cell_counts_impl, mutates_args=())


@_bev_cell_counts_op.register_fake
def _(row, col, H, W):
    _check(row, col)
    check_op_device("bev_cell_counts", row)
    return row.new_empty((row.shape[0], H, W), dtype=torch.float32)


def bev_cell_counts(row: torch.Tensor, col: torch.Tensor,
                    H: int = H, W: int = W) -> torch.Tensor:
    """(B, N) int32 cell indices (-1 = invalid) -> (B, H, W) float32 exact
    per-cell point counts, through the custom op `sfa3d_torch::bev_cell_counts`.
    CUDA tensors launch the counts instantiation of `csrc/bev_counts.cu`
    (one launch); CPU tensors take `bev_cell_counts_plain`."""
    return _bev_cell_counts_op(row, col, H, W)


def bev_raster_reduce_plain(row: torch.Tensor, col: torch.Tensor, key: torch.Tensor,
                            H: int = H, W: int = W) -> torch.Tensor:
    """Plain PyTorch version: (B, N) int32 row, col and packed key (the
    output of `ops/bev.py::cell_indices_and_keys`; -1 = dropped point) ->
    (B, 3, H, W) float32 raster, channels first:
        0: intensity of the max key   (key & 4095) / 4095
        1: height of the max key      (key >> 12) / 8191
        2: density                    min(1, log(min(n, 63) + 1) / log 64)
    Each division is a multiplication by the float32 reciprocal, as XLA
    compiles it."""
    _check(row, col, key)
    b = row.shape[0]
    num_cells = H * W
    ok = row >= 0
    cid = torch.where(ok, row.long() * W + col.long(), num_cells)  # dump cell
    max_key = torch.full((b, num_cells + 1), -1, dtype=torch.int32, device=row.device)
    max_key.scatter_reduce_(1, cid, key, reduce="amax", include_self=True)
    max_key = max_key[:, :num_cells]

    count = torch.clamp_max(bev_cell_counts_plain(row, col, H, W), 63.0)
    count = count.view(b, num_cells)

    occupied = max_key >= 0
    seg = torch.clamp_min(max_key, 0)
    height_map = torch.where(occupied, (seg >> 12).to(torch.float32) * _INV_8191, 0.0)
    intensity_map = torch.where(occupied, (seg & 4095).to(torch.float32) * _INV_4095, 0.0)
    density_map = torch.clamp_max(torch.log(count + 1.0) * _INV_LOG64, 1.0)
    bev = torch.stack([intensity_map, height_map, density_map], dim=1)
    return bev.view(b, 3, H, W)


def _bev_raster_reduce_impl(row: torch.Tensor, col: torch.Tensor, key: torch.Tensor,
                          H: int, W: int) -> torch.Tensor:
    _check(row, col, key)
    if row.device.type == "cpu":
        return bev_raster_reduce_plain(row, col, key, H, W)
    lib, dev = _cuda_launch_setup("bev_raster_reduce", (row, col, key))
    b, n = row.shape
    tile_rows, n_tiles = tile_plan(b, H, W, RASTER_BYTES_PER_CELL, _smem_limit(lib, dev))
    out = row.new_empty((b, 3, H, W), dtype=torch.float32)
    err = lib.bev_raster_reduce_cuda(
        row.data_ptr(), col.data_ptr(), key.data_ptr(), out.data_ptr(), b, n, H, W,
        tile_rows, n_tiles, _INV_4095, _INV_8191, _INV_LOG64,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    finish_launch(bev_raster_reduce, "bev_raster_reduce", err)
    return out


_bev_raster_reduce_op = torch.library.custom_op("sfa3d_torch::bev_raster_reduce", _bev_raster_reduce_impl, mutates_args=())


@_bev_raster_reduce_op.register_fake
def _(row, col, key, H, W):
    _check(row, col, key)
    check_op_device("bev_raster_reduce", row)
    return row.new_empty((row.shape[0], 3, H, W), dtype=torch.float32)


def bev_raster_reduce(row: torch.Tensor, col: torch.Tensor, key: torch.Tensor,
                      H: int = H, W: int = W) -> torch.Tensor:
    """(B, N) int32 row, col and packed key -> (B, 3, H, W) float32 raster
    (see `bev_raster_reduce_plain`), through the custom op
    `sfa3d_torch::bev_raster_reduce`. CUDA tensors launch the raster
    instantiation of `csrc/bev_counts.cu` (one launch); CPU tensors take
    `bev_raster_reduce_plain`."""
    return _bev_raster_reduce_op(row, col, key, H, W)


def argoverse_raster_reduce_plain(row: torch.Tensor, col: torch.Tensor, z: torch.Tensor,
                                  r: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch version: (B, N) int32 cell indices (-1 = dropped) and
    float32 z, r -> (B, 3, H, W) float32, per cell:
        0: the number of points                  (`bev_cell_counts_plain`)
        1: the max of max(z, 0) over its points  (0 for an empty cell)
        2: the max of max(r, 0) over its points  (0 for an empty cell)
    max(v, 0) is +0.0 for -0.0, NaN and negatives, as in the kernel."""
    _check(row, col)
    _check_values(row, z, r)
    b = row.shape[0]
    num_cells = H * W
    ok = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    cid = torch.where(ok, row.long() * W + col.long(), num_cells)  # dump cell

    def cell_max(v):
        top = torch.zeros((b, num_cells + 1), dtype=torch.float32, device=row.device)
        top.scatter_reduce_(1, cid, torch.where(v > 0, v, 0.0), reduce="amax", include_self=True)
        return top[:, :num_cells]

    count = bev_cell_counts_plain(row, col, H, W).view(b, num_cells)
    return torch.stack([count, cell_max(z), cell_max(r)], dim=1).view(b, 3, H, W)


def _argoverse_raster_reduce_impl(row: torch.Tensor, col: torch.Tensor, z: torch.Tensor,
                                r: torch.Tensor, H: int, W: int) -> torch.Tensor:
    _check(row, col)
    _check_values(row, z, r)
    if row.device.type == "cpu":
        return argoverse_raster_reduce_plain(row, col, z, r, H, W)
    lib, dev = _cuda_launch_setup("argoverse_raster_reduce", (row, col, z, r))
    b, n = row.shape
    plan = argoverse_band_plan(b, n, H, W, _smem_limit(lib, dev), _sm_count(lib, dev))
    out, err = argoverse_band_launch(lib, dev, row, col, z, r, H, W, plan)
    finish_launch(argoverse_raster_reduce, "argoverse_raster_reduce", err)
    return out


_argoverse_raster_reduce_op = torch.library.custom_op("sfa3d_torch::argoverse_raster_reduce", _argoverse_raster_reduce_impl, mutates_args=())


@_argoverse_raster_reduce_op.register_fake
def _(row, col, z, r, H, W):
    _check(row, col)
    _check_values(row, z, r)
    check_op_device("argoverse_raster_reduce", row)
    return row.new_empty((row.shape[0], 3, H, W), dtype=torch.float32)


def argoverse_raster_reduce(row: torch.Tensor, col: torch.Tensor, z: torch.Tensor,
                            r: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, N) int32 row, col and float32 z, r -> (B, 3, H, W) float32
    [count, max z, max r] per cell (see `argoverse_raster_reduce_plain`),
    through the custom op `sfa3d_torch::argoverse_raster_reduce`. CUDA
    tensors launch the three Argoverse kernels of `csrc/bev_counts.cu`
    (`argoverse_band_launch`; one call counts one launch) or raise; CPU
    tensors take `argoverse_raster_reduce_plain`."""
    return _argoverse_raster_reduce_op(row, col, z, r, H, W)


def argoverse_band_launch(lib: ctypes.CDLL, dev: torch.device, row: torch.Tensor,
                          col: torch.Tensor, z: torch.Tensor, r: torch.Tensor, H: int, W: int,
                          plan: Tuple[int, int, int]) -> Tuple[torch.Tensor, int]:
    """Enqueues the Argoverse histogram, scatter and reduce kernels of `lib`
    on the current stream at `plan` (band_rows, n_bands, chunk), in one C
    call -> (out, its CUDA error, 0 when all three launched). The scratch
    (`argoverse_scratch_len` int32) comes from PyTorch's allocator; the
    kernels allocate nothing."""
    band_rows, n_bands, chunk = plan
    b, n = row.shape
    out = row.new_empty((b, 3, H, W), dtype=torch.float32)
    scratch = row.new_empty((argoverse_scratch_len(b, n, n_bands, chunk),))
    err = lib.argoverse_raster_reduce_cuda(
        row.data_ptr(), col.data_ptr(), z.data_ptr(), r.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), b, n, H, W, band_rows, n_bands, chunk, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    return out, err


bev_cell_counts.launches = 0
bev_raster_reduce.launches = 0
argoverse_raster_reduce.launches = 0
