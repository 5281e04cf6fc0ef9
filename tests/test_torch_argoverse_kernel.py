"""The Argoverse raster's bucketed design (`csrc/bev_counts.cu`: histogram,
scatter, reduce) on the CPU: its arithmetic modelled in numpy and held bit
for bit against `argoverse_raster_reduce_plain`, its band plan, and the
wrapper's three launches. The kernels themselves run only on the card
(`chip_smoke.py`, `scripts/torch_argoverse_variants.py`)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sfa3d_tpu_torch.ops import bev_counts
from sfa3d_tpu_torch.ops.bev_counts import (
    ARGOVERSE_BLOCKS_PER_SM,
    ARGOVERSE_CHUNKS,
    ARGOVERSE_STATIC_SMEM,
    SMEM_RESERVED_PER_BLOCK,
    argoverse_band_plan,
    argoverse_raster_reduce,
    argoverse_raster_reduce_plain,
    argoverse_reduce_smem,
    argoverse_scatter_smem,
    argoverse_scratch_len,
)

H = W = 1000
H100_SMEM = 232448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
H100_SMS = 132


def _floored_bits(v: np.ndarray) -> np.ndarray:
    """The bits of max(v, 0) as int32: -0, NaN and negatives give +0.0."""
    return np.where(v > 0, v, np.float32(0)).astype(np.float32).view(np.int32)


def _bucketed_numpy(row, col, z, r, plan, rng=None):
    """The bucketed design step by step: per chunk, the histogram of
    in-raster rows per band, whose atomic adds to the band totals hand each
    chunk the start of its run in a band's bucket (in the order `rng`
    shuffles the chunks: the order of the atomics; chunk order without
    `rng`); the buckets' starts; the scatter of one record per in-raster
    point into its run (in a shuffled order too, or point order); and the
    reduce of each band's bucket alone."""
    band_rows, n_bands, chunk = plan
    B, N = row.shape
    n_chunks = -(-N // chunk)
    count = np.zeros((B, H, W), np.int64)
    zmax, rmax = np.zeros((B, H, W), np.int32), np.zeros((B, H, W), np.int32)
    for b in range(B):
        band = np.where(row[b].astype(np.uint32) < H, row[b] // band_rows, -1)
        chunks = [np.arange(c * chunk, min(N, (c + 1) * chunk)) for c in range(n_chunks)]
        counts = [np.bincount(band[idx][band[idx] >= 0], minlength=n_bands) for idx in chunks]
        totals = np.zeros(n_bands, np.int64)
        offsets = [None] * n_chunks
        for c in (rng.permutation(n_chunks) if rng is not None else range(n_chunks)):
            offsets[c] = totals.copy()  # the old values of the histogram's atomic adds
            totals += counts[c]
        start = np.concatenate([[0], np.cumsum(totals)[:-1]])
        rec = np.full((3, N), -7, np.int64)  # cell, z bits, r bits; -7: never written
        for c, idx in enumerate(chunks):
            idx = idx[band[idx] >= 0]
            if rng is not None:
                idx = rng.permutation(idx)
            idx = idx[np.argsort(band[idx], kind="stable")]  # grouped by band
            kb = band[idx]
            rank = np.arange(len(idx)) - np.searchsorted(kb, kb, side="left")
            dst = start[kb] + offsets[c][kb] + rank
            lr = row[b, idx] - kb * band_rows
            rec[0, dst] = np.where(col[b, idx].astype(np.uint32) < W, lr * W + col[b, idx], -1)
            rec[1, dst] = _floored_bits(z[b, idx])
            rec[2, dst] = _floored_bits(r[b, idx])
        total = int(totals.sum())
        assert (rec[:, :total] != -7).all() and (rec[:, total:] == -7).all()  # every slot written once
        owner = np.repeat(np.arange(n_bands), totals)  # the reduce block that reads each record
        cell, zb, rb = rec[:, :total]
        rows_in = np.minimum(band_rows, H - owner * band_rows)
        assert ((cell >= -1) & (cell < rows_in * W)).all()  # a record stays inside its band
        ok = cell >= 0
        at = (owner[ok] * band_rows + cell[ok] // W, cell[ok] % W)
        np.add.at(count[b], at, 1)
        np.maximum.at(zmax[b], at, zb[ok].astype(np.int32))
        np.maximum.at(rmax[b], at, rb[ok].astype(np.int32))
    return np.stack([count.astype(np.float32), zmax.view(np.float32), rmax.view(np.float32)], 1)


def _special_inputs(B: int, n: int, band_rows: int, seed: int):
    """Rows and columns -3..1002 (outside the raster: nowhere), a cell hit
    5,000 times, points on the rows where bands meet, z and r negative,
    -0.0, +0.0, subnormal, NaN and +inf; with B = 3 also a frame whose every
    point lies in one band (with its own hot cell) and an all-invalid
    frame."""
    rng = np.random.default_rng(seed)
    row = rng.integers(-3, H + 3, (B, n)).astype(np.int32)
    col = rng.integers(-3, W + 3, (B, n)).astype(np.int32)
    edges = np.array([e for m in range(band_rows, H, band_rows) for e in (m - 1, m)])
    row[0, : n // 4] = rng.choice(edges, n // 4)
    row[0, n // 4: n // 4 + 5000], col[0, n // 4: n // 4 + 5000] = 123, 456
    if B == 3:
        k = 777 // band_rows
        row[1] = k * band_rows + rng.integers(0, band_rows, n) % min(band_rows, H - k * band_rows)
        row[1, :5000], col[1, :5000] = k * band_rows, 17
        row[2], col[2] = -1, -1
    special = np.array([-1.0, -0.0, 0.0, 1e-40, -1e-40, np.nan, np.inf, 2.5, 0.75], np.float32)
    z = np.where(rng.random((B, n)) < 0.3, rng.choice(special, (B, n)), rng.uniform(-3, 5, (B, n))).astype(np.float32)
    r = np.where(rng.random((B, n)) < 0.3, rng.choice(special, (B, n)), rng.uniform(-0.2, 1, (B, n))).astype(np.float32)
    return row, col, z, r


@pytest.mark.parametrize("order", ["point", "shuffled"])
@pytest.mark.parametrize("B", [1, 3])
def test_bucketed_design_gives_the_plain_version(B, order):
    """The histogram, prefix, scatter and reduce at the H100 plan equal the
    plain version bit for bit, whatever order the atomics hand out the
    records in."""
    n = 20000
    plan = argoverse_band_plan(B, n, H, W, H100_SMEM, H100_SMS)
    assert plan[2] == 1024 and -(-n // plan[2]) > 1  # several chunks a frame
    row, col, z, r = _special_inputs(B, n, plan[0], seed=20 + B)
    rng = np.random.default_rng(5) if order == "shuffled" else None
    want = _bucketed_numpy(row, col, z, r, plan, rng)
    got = argoverse_raster_reduce_plain(*(torch.from_numpy(a) for a in (row, col, z, r)), H, W).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0, 0, 123, 456] >= 5000
    assert np.isinf(got[:, 1]).any() and (got[:, 1:].view(np.uint32) != np.uint32(0x80000000)).all()
    if B == 3:
        k = 777 // plan[0]
        assert got[1, 0, k * plan[0], 17] >= 5000 and not got[2].any()
        assert got[1, 0].sum() == ((col[1] >= 0) & (col[1] < W)).sum() and not got[1, 0, : k * plan[0]].any()


@pytest.mark.parametrize("hw", [(1000, 1000), (608, 608), (40, 24), (7, 3), (1, 1)])
@pytest.mark.parametrize("smem", [H100_SMEM, 100 * 1024])
def test_band_plan_covers_every_row_once_and_fits(hw, smem):
    """For B from 1 to 64: every row lies in exactly one band; a reduce
    block's band leaves room for ARGOVERSE_BLOCKS_PER_SM blocks an SM; a
    scatter block fits a block's shared memory; the histogram and scatter
    grids hold ARGOVERSE_BLOCKS_PER_SM blocks for each SM wherever the
    smallest chunk allows."""
    h, w = hw
    n = 131072
    for b in range(1, 65):
        band_rows, n_bands, chunk = argoverse_band_plan(b, n, h, w, smem, H100_SMS)
        bands = [list(range(k * band_rows, min(h, (k + 1) * band_rows))) for k in range(n_bands)]
        assert all(bands) and sum(bands, []) == list(range(h))
        share = smem // ARGOVERSE_BLOCKS_PER_SM
        assert argoverse_reduce_smem(band_rows, w) + ARGOVERSE_STATIC_SMEM + SMEM_RESERVED_PER_BLOCK <= share
        assert argoverse_scatter_smem(chunk, n_bands) + ARGOVERSE_STATIC_SMEM <= smem
        assert chunk in ARGOVERSE_CHUNKS
        assert b * -(-n // chunk) >= ARGOVERSE_BLOCKS_PER_SM * H100_SMS or chunk == min(ARGOVERSE_CHUNKS)


def test_band_plan_at_the_path_shapes():
    """On an H100 at 131072 points a sweep: 9-row bands (108 KB, two blocks
    an SM); chunks of 1024 points for one sweep (argoverse_test), of 4096
    for 16 and 64."""
    assert argoverse_band_plan(1, 131072, H, W, H100_SMEM, H100_SMS) == (9, 112, 1024)
    assert argoverse_band_plan(16, 131072, H, W, H100_SMEM, H100_SMS) == (9, 112, 4096)
    assert argoverse_band_plan(64, 131072, H, W, H100_SMEM, H100_SMS) == (9, 112, 4096)
    assert argoverse_reduce_smem(9, W) == 108000


def test_band_plan_raises_where_a_row_does_not_fit():
    share = H100_SMEM // ARGOVERSE_BLOCKS_PER_SM - SMEM_RESERVED_PER_BLOCK - ARGOVERSE_STATIC_SMEM
    w = share // 12 // 4 * 4
    assert argoverse_band_plan(1, 131072, 10, w, H100_SMEM, H100_SMS)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        argoverse_band_plan(1, 131072, 10, w + 4, H100_SMEM, H100_SMS)
    with pytest.raises(ValueError, match="grid"):
        argoverse_band_plan(65536, 131072, H, W, H100_SMEM, H100_SMS)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the launch path of
    the wrapper without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_wrapper_launches_the_bucketed_design_at_the_plan(monkeypatch):
    """A CUDA call makes one C call with the plan's bands and chunk, an
    int32 scratch of the tables and the (3, B, N) records, and a float32
    (B, 3, H, W) output, and counts one launch."""
    calls = []

    def limit(value):
        def query(device, out):
            out._obj.value = value
            return 0
        return query

    def launch(*args):
        calls.append(args)
        return 0

    fake = SimpleNamespace(bev_smem_limit=limit(H100_SMEM), bev_sm_count=limit(H100_SMS),
                           argoverse_raster_reduce_cuda=launch)
    monkeypatch.setattr(bev_counts, "load_library", lambda name, signatures: fake)
    monkeypatch.setattr(bev_counts, "_smem_limits", {})
    monkeypatch.setattr(bev_counts, "_sm_counts", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))
    sizes = {}
    new_empty = torch.Tensor.new_empty

    def recording_new_empty(self, size, **kw):
        out = new_empty(self, size, **kw)
        sizes.setdefault(out.data_ptr(), (tuple(size), kw.get("dtype", self.dtype)))
        return out

    monkeypatch.setattr(torch.Tensor, "new_empty", recording_new_empty)
    b, n = 2, 5000
    idx = torch.Tensor._make_subclass(_CudaTyped, torch.zeros((b, n), dtype=torch.int32))
    vals = torch.Tensor._make_subclass(_CudaTyped, torch.zeros((b, n)))
    before = argoverse_raster_reduce.launches
    out = argoverse_raster_reduce(idx, idx, vals, vals, H, W)
    assert argoverse_raster_reduce.launches == before + 1
    assert out.shape == (b, 3, H, W) and out.dtype == torch.float32
    band_rows, n_bands, chunk = argoverse_band_plan(b, n, H, W, H100_SMEM, H100_SMS)
    assert len(calls) == 1
    args = calls[0]
    assert args[4] == out.data_ptr() and args[6:] == (b, n, H, W, band_rows, n_bands, chunk, 0, 7)
    assert sizes[args[5]] == ((argoverse_scratch_len(b, n, n_bands, chunk),), torch.int32)
    assert argoverse_scratch_len(b, n, n_bands, chunk) == b * n_bands * 12 + 3 * b * n  # 5 chunks of 1024
