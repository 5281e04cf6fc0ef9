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
from sfa3d_tpu_torch.ops.bev_counts import bev_cell_counts, bev_cell_counts_plain

N = 4096
DENSITY_TOL = 1.2e-7


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


SCANS = {
    "random": _scan_random,
    "cell_edges": _scan_cell_edges,
    "nan_intensity": _scan_nan_intensity,
    "empty": _scan_empty,
    "saturated_cell": _scan_one_cell,
}


@pytest.mark.parametrize("kind", sorted(SCANS))
def test_points_to_bev_matches_jax(rng, kind):
    p, valid = SCANS[kind](rng)
    want = np.asarray(jbev.points_to_bev(jnp.asarray(p), jnp.asarray(valid)))
    got = tbev.points_to_bev(torch.from_numpy(p), torch.from_numpy(valid)).numpy()
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
