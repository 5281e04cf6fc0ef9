"""The port's BEV raster and cell counts against the JAX package on the CPU.

The raster must be bit-exact on channels 0 (intensity) and 1 (height) and
on the counts; the density channel's log may differ by one float32 ulp
between XLA and PyTorch (<= 1.2e-7).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.ops import bev as jbev
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.ops import bev as tbev
from sfa3d_tpu_torch.ops.bev_counts import (
    COUNT_BYTES_PER_CELL,
    RASTER_BYTES_PER_CELL,
    bev_cell_counts,
    bev_cell_counts_plain,
    bev_raster_reduce_plain,
    tile_plan,
)

N = 4096
DENSITY_TOL = 1.2e-7
H100_SMEM = 232448  # shared memory one block may use on an H100


def _np_counts(row, col, H=608, W=608):
    ref = np.zeros((row.shape[0], H, W), np.float32)
    for b in range(row.shape[0]):
        m = (row[b] >= 0) & (row[b] < H) & (col[b] >= 0) & (col[b] < W)
        np.add.at(ref[b], (row[b][m], col[b][m]), 1.0)
    return ref


def test_plain_counts_match_pallas_kernel_and_add_at(rng):
    from jax.experimental.pallas import tpu as pltpu

    from sfa3d_tpu.ops import bev_pallas

    B, n = 2, 1024
    row = rng.integers(0, 608, (B, n)).astype(np.int32)
    col = rng.integers(0, 608, (B, n)).astype(np.int32)
    inv = rng.random((B, n)) < 0.3
    row[inv] = -1
    col[inv] = -1
    row[1, :200] = 17  # one hot cell
    col[1, :200] = 601

    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(bev_pallas.bev_cell_counts(jnp.asarray(row), jnp.asarray(col)))
    plain = bev_cell_counts_plain(torch.from_numpy(row), torch.from_numpy(col)).numpy()
    wrapped = bev_cell_counts(torch.from_numpy(row), torch.from_numpy(col)).numpy()
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, _np_counts(row, col))
    np.testing.assert_array_equal(wrapped, plain)
    assert plain[1, 17, 601] >= 200


def test_counts_take_any_point_count_and_drop_out_of_raster_indices(rng):
    """The TPU kernel asserts N % 128 == 0; the port takes any N. Indices
    outside the raster count nowhere, as in the TPU kernel."""
    B, n, H, W = 3, 1000 + 37, 40, 24
    row = rng.integers(-3, H + 3, (B, n)).astype(np.int32)
    col = rng.integers(-3, W + 3, (B, n)).astype(np.int32)
    got = bev_cell_counts(torch.from_numpy(row), torch.from_numpy(col), H, W).numpy()
    assert got.shape == (B, H, W) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _np_counts(row, col, H, W))


def _scan_random(rng):
    p = np.empty((N, 4), np.float32)
    p[:, 0] = rng.uniform(-5, 55, N)
    p[:, 1] = rng.uniform(-30, 30, N)
    p[:, 2] = rng.uniform(-3.0, 1.5, N)
    p[:, 3] = rng.uniform(-0.1, 1.1, N)
    return p, rng.random(N) < 0.9


def _near_edges(rng, k):
    """Cell edges k * disc, exactly and one float32 ulp either side (for
    the edges at 0 that ulp is a subnormal)."""
    v = (k * np.float32(cnf.DISCRETIZATION)).astype(np.float32)
    u = rng.random(len(k))
    v = np.where(u < 1 / 3, np.nextafter(v, np.float32(1e3)), v)
    return np.where(u > 2 / 3, np.nextafter(v, np.float32(-1e3)), v)


def _scan_cell_edges(rng):
    x = _near_edges(rng, rng.integers(0, 609, N))
    y = _near_edges(rng, rng.integers(-304, 305, N))
    z = rng.uniform(-2.73, 1.27, N).astype(np.float32)
    z[:64] = np.float32(cnf.boundary["minZ"])
    z[64:128] = np.float32(cnf.boundary["maxZ"])
    r = rng.uniform(0, 1, N).astype(np.float32)
    return np.stack([x, y, z, r], 1), np.ones(N, bool)


def _scan_nan_intensity(rng):
    p, valid = _scan_random(rng)
    p[::7, 3] = np.nan
    p[::11, 0] = np.nan  # NaN coordinates drop out
    return p, valid


def _scan_empty(rng):
    return np.zeros((N, 4), np.float32), np.zeros(N, bool)


def _scan_one_cell(rng):
    """100 points in one cell: the count saturates at 63 (density 1.0);
    tied heights pick the max intensity."""
    p, valid = _scan_random(rng)
    p[:100, 0] = 10.01
    p[:100, 1] = -3.02
    p[:100, 2] = np.where(np.arange(100) < 50, 0.5, rng.uniform(-2, 0.4, 100))
    p[:100, 3] = rng.uniform(0, 1, 100)
    valid[:100] = True
    return p, valid


def _band_edge_rows():
    """The rows k * tile_rows - 1 and k * tile_rows where two bands of the
    tile kernel meet, for the raster's and the counts' plans on an H100."""
    rows = set()
    for bytes_per_cell in (RASTER_BYTES_PER_CELL, COUNT_BYTES_PER_CELL):
        t, _ = tile_plan(8, 608, 608, bytes_per_cell, H100_SMEM)
        rows |= {e for m in range(t, 608, t) for e in (m - 1, m)}
    return np.array(sorted(rows))


def _scan_band_boundaries(rng):
    """Every point inside a cell of a row where two bands meet."""
    row = rng.choice(_band_edge_rows(), N)
    x = ((row + rng.uniform(0.2, 0.8, N)) * cnf.DISCRETIZATION).astype(np.float32)
    y = rng.uniform(-25, 25, N).astype(np.float32)
    z = rng.uniform(-2.7, 1.2, N).astype(np.float32)
    r = rng.uniform(0, 1, N).astype(np.float32)
    return np.stack([x, y, z, r], 1), np.ones(N, bool)


SCANS = {
    "random": _scan_random,
    "cell_edges": _scan_cell_edges,
    "nan_intensity": _scan_nan_intensity,
    "empty": _scan_empty,
    "saturated_cell": _scan_one_cell,
    "band_boundaries": _scan_band_boundaries,
}


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_points_to_bev_matches_jax(rng, kind):
    """points_to_bev, and bev_raster_reduce_plain on the prelude's indices
    and keys, equal the JAX raster; the two are the same bits."""
    p, valid = SCANS[kind](rng)
    want = np.asarray(jbev.points_to_bev(jnp.asarray(p), jnp.asarray(valid)))
    got = tbev.points_to_bev(torch.from_numpy(p), torch.from_numpy(valid)).numpy()
    idx = tbev.cell_indices_and_keys(torch.from_numpy(p[None]), torch.from_numpy(valid[None]))
    plain = bev_raster_reduce_plain(*idx)[0].permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(plain.view(np.uint32), got.view(np.uint32))
    assert got.shape == want.shape == (608, 608, 3)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=DENSITY_TOL)
    if kind == "empty":
        assert not got.any()
    elif kind == "saturated_cell":
        r, c = int(np.floor(10.01 / cnf.DISCRETIZATION)), int(np.floor(-3.02 / cnf.DISCRETIZATION)) + 304
        assert got[r, c, 2] == 1.0
        assert got[r, c, 1] == want[r, c, 1]
    else:
        assert (got[..., 2] > 0).sum() > 100


def _tile_kernel_numpy(row, col, key, H, W, tile_rows, n_tiles):
    """The tile kernel's band arithmetic in numpy: block (t, b) owns rows
    [t * tile_rows, ...) of frame b and takes a point where the unsigned
    row - r0 falls below its row count and 0 <= col < W."""
    B = row.shape[0]
    counts = np.zeros((B, H, W), np.int64)
    max_key = np.full((B, H, W), -1, np.int64)
    for b in range(B):
        for t in range(n_tiles):
            r0 = t * tile_rows
            lr = row[b].astype(np.uint32) - np.uint32(r0)
            ok = (lr < min(tile_rows, H - r0)) & (col[b] >= 0) & (col[b] < W)
            np.add.at(counts[b], (lr[ok] + r0, col[b][ok]), 1)
            np.maximum.at(max_key[b], (lr[ok] + r0, col[b][ok]), key[b][ok])
    f32 = np.float32
    occupied = max_key >= 0
    intensity = np.where(occupied, (max_key & 4095).astype(f32) * f32(1 / 4095), f32(0))
    height = np.where(occupied, (max_key >> 12).astype(f32) * f32(1 / 8191), f32(0))
    density = np.minimum(
        np.log(np.minimum(counts, 63).astype(f32) + f32(1)) * f32(1 / np.log(64.0)), f32(1))
    return counts.astype(f32), np.stack([intensity, height, density], 1)


@pytest.mark.parametrize("kind", ["random", "band_boundaries"])
@pytest.mark.parametrize("bytes_per_cell", [RASTER_BYTES_PER_CELL, COUNT_BYTES_PER_CELL])
def test_tile_bands_give_the_plain_counts_and_raster(rng, kind, bytes_per_cell):
    """Cut into the bands of the kernel's plan on an H100, the counts and the
    raster are the plain versions' (rows -3..H+2 and columns -3..W+2 included
    for the counts)."""
    p, valid = SCANS[kind](rng)
    row, col, key = (t.numpy() for t in tbev.cell_indices_and_keys(
        torch.from_numpy(p[None]), torch.from_numpy(valid[None])))
    plan = tile_plan(1, 608, 608, bytes_per_cell, H100_SMEM)
    counts, raster = _tile_kernel_numpy(row, col, key, 608, 608, *plan)
    want = bev_raster_reduce_plain(*(torch.from_numpy(a) for a in (row, col, key))).numpy()
    np.testing.assert_array_equal(counts, bev_cell_counts_plain(
        torch.from_numpy(row), torch.from_numpy(col)).numpy())
    np.testing.assert_array_equal(raster[:, :2], want[:, :2])
    np.testing.assert_allclose(raster[:, 2], want[:, 2], rtol=0, atol=DENSITY_TOL)

    wild_row = rng.integers(-3, 611, row.shape).astype(np.int32)
    wild_col = rng.integers(-3, 611, row.shape).astype(np.int32)
    counts, _ = _tile_kernel_numpy(wild_row, wild_col, key, 608, 608, *plan)
    np.testing.assert_array_equal(counts, _np_counts(wild_row, wild_col))


@pytest.mark.parametrize("B,H,W", [(1, 608, 608), (8, 608, 608), (3, 40, 24), (2, 64, 64)])
def test_tile_plan_covers_every_row_once_within_shared_memory(B, H, W):
    for bytes_per_cell in (RASTER_BYTES_PER_CELL, COUNT_BYTES_PER_CELL):
        for smem in (H100_SMEM, 48 * 1024, W * bytes_per_cell + 12):
            tile_rows, n_tiles = tile_plan(B, H, W, bytes_per_cell, smem)
            bands = [list(range(t * tile_rows, min(H, (t + 1) * tile_rows))) for t in range(n_tiles)]
            assert all(bands) and sum(bands, []) == list(range(H))
            assert -(-tile_rows * W // 4) * 4 * bytes_per_cell <= smem


def test_tile_plan_raises_when_a_row_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tile_plan(1, 608, 608, RASTER_BYTES_PER_CELL, 608 * RASTER_BYTES_PER_CELL - 1)
    with pytest.raises(ValueError, match="grid"):
        tile_plan(65536, 608, 608, RASTER_BYTES_PER_CELL, H100_SMEM)


def test_cell_indices_match_jax_floor_at_cell_edges(rng):
    """Row/col of every kept point equal the JAX raster's cell arithmetic
    (XLA's reciprocal multiply, subnormals as zero)."""
    import jax

    p, valid = _scan_cell_edges(rng)
    row, col, key = tbev.cell_indices_and_keys(torch.from_numpy(p[None]), torch.from_numpy(valid[None]))
    d = cnf.DISCRETIZATION
    jrow = np.asarray(jax.jit(lambda x: jnp.floor(x / d).astype(jnp.int32))(p[:, 0]))
    jcol = np.asarray(jax.jit(lambda y: jnp.floor(y / d).astype(jnp.int32) + 304)(p[:, 1]))
    kept = row[0].numpy() >= 0
    assert kept.sum() > N // 2
    np.testing.assert_array_equal(row[0].numpy()[kept], jrow[kept])
    np.testing.assert_array_equal(col[0].numpy()[kept], jcol[kept])
    assert (key[0].numpy()[~kept] == -1).all()


def test_points_to_bev_batch_stacks_single_scans(rng):
    scans = [_scan_random(rng), _scan_one_cell(rng)]
    pts = torch.from_numpy(np.stack([s[0] for s in scans]))
    valid = torch.from_numpy(np.stack([s[1] for s in scans]))
    batch = tbev.points_to_bev_batch(pts, valid)
    assert batch.shape == (2, 608, 608, 3)
    for i in range(2):
        torch.testing.assert_close(batch[i], tbev.points_to_bev(pts[i], valid[i]), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tbev.points_to_bev_batch(pts[0], valid[0])


@pytest.mark.parametrize(
    "bound",
    [
        (0.0, 50.0, -20.0, 30.0, -2.73, 1.27),  # asymmetric Y
        (0.0, 50.0, -30.0, 30.0, -2.73, 1.27),  # non-square cells
    ],
    ids=["asymmetric_y", "non_square"],
)
def test_bad_boundaries_raise_like_jax(bound):
    p = np.zeros((16, 4), np.float32)
    v = np.ones(16, bool)
    with pytest.raises(ValueError) as jax_err:
        jbev.points_to_bev(jnp.asarray(p), jnp.asarray(v), bound=bound)
    with pytest.raises(ValueError) as port_err:
        tbev.points_to_bev(torch.from_numpy(p), torch.from_numpy(v), bound=bound)
    assert str(port_err.value) == str(jax_err.value)


def test_filter_and_pad_matches_jax_and_warns_on_overflow(rng):
    scan = np.concatenate([_scan_random(rng)[0], _scan_random(rng)[0]])
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jp, jv = jbev._filter_and_pad_numpy(scan, 1000, jbev.cnf.boundary)
    with pytest.warns(RuntimeWarning, match="in-range points; keeping the first 1000") as tw:
        tp, tv = tbev.filter_and_pad_points(scan, max_points=1000)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tp, tv = tbev.filter_and_pad_points(scan, max_points=cnf.MAX_POINTS_FILTERED)
    jp, jv = jbev._filter_and_pad_numpy(scan, cnf.MAX_POINTS_FILTERED, jbev.cnf.boundary)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("extra", [10, -10], ids=["over_budget", "under_budget"])
def test_pad_raw_matches_jax_and_warns(rng, extra):
    scan = np.concatenate([_scan_random(rng)[0]] * 2)[: N + extra]
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jp, jv = jbev._pad_raw(scan, N)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tp, tv = tbev._pad_raw(scan, N)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == (1 if extra > 0 else 0)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tv, jv)
