"""Exact per-cell point counts for the BEV raster: the port of the Pallas
kernel `sfa3d_tpu/ops/bev_pallas.py:76` (`bev_cell_counts`).

The TPU kernel built the count as bf16 one-hot matrix products because the
TPU has no fast scatter. On Hopper the count is an integer atomic histogram
(`csrc/bev_counts.cu`): one thread per point, `atomicAdd` into a zeroed
int32 buffer, then a convert to float32. The work is bound by bytes: at the
served shape (8, 32768) -> (8, 608, 608) the least the card must move is
2.1 MB of indices read plus 11.8 MB of counts written, about 4.2 us at
3.35 TB/s. The source note in the `.cu` file says what the simple version
moves beyond that.

Unlike the TPU kernel, which asserts N % 128 == 0 (bev_pallas.py:80; its
docstring says 512), the port accepts any N.

`bev_cell_counts` launches the kernel for CUDA tensors (or raises) and
takes the plain PyTorch version, `bev_cell_counts_plain`, only for tensors
on the CPU. `bev_cell_counts.launches` counts the kernel launches, so a run
can show that the served path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from sfa3d_tpu_torch._build import load_library

H = 608
W = 608

_SIGNATURES = {
    "bev_cell_counts_cuda": (
        ctypes.c_int,
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
         ctypes.c_void_p),
    ),
}
_count_lock = threading.Lock()


def _check(row: torch.Tensor, col: torch.Tensor) -> None:
    if row.dim() != 2 or row.shape != col.shape:
        raise ValueError(
            f"row and col must both be (B, N); got {tuple(row.shape)} and {tuple(col.shape)}"
        )
    if row.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"row and col must be int32; got {row.dtype} and {col.dtype}")
    if row.device != col.device:
        raise ValueError(f"row and col lie on {row.device} and {col.device}")


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


def bev_cell_counts(row: torch.Tensor, col: torch.Tensor,
                    H: int = H, W: int = W) -> torch.Tensor:
    """(B, N) int32 cell indices (-1 = invalid) -> (B, H, W) float32 exact
    per-cell point counts. CUDA tensors launch `csrc/bev_counts.cu`; CPU
    tensors take `bev_cell_counts_plain`."""
    _check(row, col)
    if row.device.type == "cpu":
        return bev_cell_counts_plain(row, col, H, W)
    if row.device.type != "cuda":
        raise ValueError(f"bev_cell_counts runs on cuda or cpu, not {row.device}")
    if not (row.is_contiguous() and col.is_contiguous()):
        raise ValueError("bev_cell_counts needs contiguous row and col")
    lib = load_library("bev_counts", _SIGNATURES)
    b, n = row.shape
    counts_i32 = torch.zeros((b, H * W), dtype=torch.int32, device=row.device)
    out = torch.empty((b, H, W), dtype=torch.float32, device=row.device)
    with torch.cuda.device(row.device):
        err = lib.bev_cell_counts_cuda(
            row.data_ptr(), col.data_ptr(), counts_i32.data_ptr(), out.data_ptr(),
            b, n, H, W, torch.cuda.current_stream(row.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bev_cell_counts CUDA launch failed: cudaError {err}")
    with _count_lock:
        bev_cell_counts.launches += 1
    return out


bev_cell_counts.launches = 0
